"""Complex operators under aggregation AMG beyond the GEO and SIZE_2 V
and CG cycles, and complex b×b block packs, against the JAX package on
the CPU (ROADMAP item 7c): the selectors, ENERGYMIN (its strength
measure on the real parts, ``amgx_tpu/amg/classical/strength.py:60-67``),
``amg_host_levels_rows`` and
``hierarchy_dtype=float32`` (a complex level narrowed to a real dtype
keeps its real parts, as the JAX package's cast does); the cycles and
``error_scaling`` are in ``test_torch_complex_cycles.py``, the block
packs, bf16 levels and the resetup in ``test_torch_complex_amg_blocks.py``.

The JAX package's count and residual history (``HIST_RTOL`` 1e-8 plus
``HIST_ATOL``·‖r₀‖, ``tests/torch_complex_parity.py``) and, where both
expose them, the levels' sizes."""
import pytest

from torch_complex_parity import (amg_cfg, assert_same, operator, relres,
                                  solve_jax, solve_port)

AMG_CASES = {
    "SIZE_4": amg_cfg(sel="SIZE_4"),
    "SIZE_8": amg_cfg(sel="SIZE_8"),
    "MULTI_PAIRWISE": amg_cfg(sel="MULTI_PAIRWISE"),
    "host_levels": amg_cfg(extra=", amg_host_levels_rows=100"),
    "hierarchy_float32": amg_cfg(extra=", hierarchy_dtype=float32"),
    "ENERGYMIN": amg_cfg(alg="ENERGYMIN", sel="PMIS",
                         extra=", amg:strength_threshold=0.25"),
    "ILU_smoother": amg_cfg(sm="MULTICOLOR_ILU"),
    "F_SIZE_4_DILU": amg_cfg(sel="SIZE_4", cyc="F", sm="MULTICOLOR_DILU"),
    "PCG_PIPE_JACOBI_L1": amg_cfg(outer="PCG_PIPE", sm="JACOBI_L1"),
}
#: the Hermitian operator for the CG outer solver
HERMITIAN = {"PCG_PIPE_JACOBI_L1"}


def _level_rows(slv):
    h = slv.preconditioner.hierarchy
    return [lv.Ad.n_rows for lv in h.levels]


@pytest.mark.parametrize("case", sorted(AMG_CASES))
def test_amg_configuration_matches_jax(case):
    A, b = operator("H" if case in HERMITIAN else "Z")
    cfg = AMG_CASES[case]
    rj, sj = solve_jax(cfg, A, b, solver=True)
    rp, sp_ = solve_port(cfg, A, b)
    assert_same(rj, rp)
    assert rp.status == 0 and relres(A, rp.x, b) < 1e-7
    assert _level_rows(sp_) == [lv.Ad.n_rows for lv in
                                sj.preconditioner.hierarchy.levels]
