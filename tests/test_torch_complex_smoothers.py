"""Complex operators under the relaxation smoothers, against the JAX
package on the CPU (ROADMAP item 7c): each smoother one sweep as the
preconditioner of FGMRES, on the Hermitian ``L + iK`` (complex
couplings) and on the shifted Helmholtz operator (a complex diagonal).

The JAX package's count and residual history (``HIST_RTOL`` 1e-8 plus
``HIST_ATOL``·‖r₀‖, ``tests/torch_complex_parity.py``).  The colors
follow the pattern; the slabs keep complex values; MULTICOLOR_DILU's E
and MULTICOLOR_ILU's factors come from the real parts, as the JAX
package computes them (``amgx_tpu/solvers/dilu.py:50, 58``,
``ilu.py:121``)."""
import pytest

from torch_complex_parity import assert_same, both, krylov_cfg, operator

SMOOTHERS = ("JACOBI_L1", "POLYNOMIAL", "MULTICOLOR_GS", "GS",
             "FIXCOLOR_GS", "MULTICOLOR_DILU", "MULTICOLOR_ILU")


@pytest.mark.parametrize("op", ["H", "Z"])
@pytest.mark.parametrize("name", SMOOTHERS)
def test_smoother_matches_jax(name, op):
    A, b = operator(op)
    rj, rp, _ = both(krylov_cfg("FGMRES", pre=name), A, b)
    assert_same(rj, rp)
    assert rp.status == 0


def test_chebyshev_on_hermitian_matches_jax():
    """CHEBYSHEV (its BLOCK_JACOBI preconditioner, the Lanczos estimate of
    both spectrum ends) on the Hermitian operator."""
    A, b = operator("H")
    rj, rp, _ = both(krylov_cfg("FGMRES", pre="CHEBYSHEV"), A, b)
    assert_same(rj, rp)


@pytest.mark.parametrize("op,it", [("H", 200), ("Z", 40)])
def test_kaczmarz_matches_jax(op, it):
    """KACZMARZ projects along the unconjugated rows with 1/Σ a_ij², as
    the JAX package does; it converges slowly on the Helmholtz operator,
    whose first 40 iterations are compared."""
    A, b = operator(op)
    rj, rp, _ = both(krylov_cfg("FGMRES", pre="KACZMARZ", it=it), A, b)
    assert_same(rj, rp)
