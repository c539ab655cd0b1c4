"""Complex operators under the W, F and CGF cycles and ``error_scaling``
2 and 3 (the scaling's inner products conjugated, its sign λ/|λ| as
``jnp.sign``), against the JAX package on the CPU (ROADMAP item 7c).

The JAX package's count and residual history (``HIST_RTOL`` 1e-8 plus
``HIST_ATOL``·‖r₀‖, ``tests/torch_complex_parity.py``)."""
import pytest

from torch_complex_parity import amg_cfg, assert_same, both, operator

CYCLE_CASES = {
    # the recursive cycles on SIZE_4's three levels: the JAX package
    # compiles each cycle unrolled, 2^(levels−1) visits deep
    "W": amg_cfg(sel="SIZE_4", cyc="W"),
    "F": amg_cfg(sel="SIZE_4", cyc="F"),
    "CGF": amg_cfg(sel="SIZE_4", cyc="CGF"),
    "error_scaling_2": amg_cfg(extra=", amg:error_scaling=2"),
    "error_scaling_3": amg_cfg(sel="SIZE_4",
                               extra=", amg:error_scaling=3"),
}


@pytest.mark.parametrize("case", sorted(CYCLE_CASES))
def test_cycle_matches_jax(case):
    A, b = operator("Z")
    rj, rp, _ = both(CYCLE_CASES[case], A, b)
    assert_same(rj, rp)
    assert rp.status == 0
