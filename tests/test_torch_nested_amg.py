"""An AMG nested in the AMG preconditioner (its coarse solver) in the port
against the JAX package on the CPU: the headline stack at 16³ cut at two
levels, whose coarse solve is a second aggregation AMG (two V-cycles).
On the card the outer application is one CUDA graph and the inner one
runs eagerly inside its capture (``utils/cuda_graph.py``); the card tier
holds that (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

import amgx_tpu as jx
from amgx_tpu.io import poisson7pt_device as jax_poisson7pt_device

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson7pt_device
from amgx_tpu_torch.solvers.amg_solver import AMGSolver
from chip_smoke import NESTED_CFG, NESTED_ITERS

#: the headline stack cut at two levels, with an AMG as its coarse solver
NESTED = NESTED_CFG + ", out:store_res_history=1"


@pytest.mark.parametrize("dtype,iters", [(np.float64, 12),
                                         (np.float32, NESTED_ITERS)])
def test_nested_amg_headline_matches_jax(dtype, iters):
    """The JAX package's count in f64 and with the f32 pack (+ f64
    refinement); in f64 the residual histories agree to rounding (the f32
    sums of the two packages are not ordered alike, see
    tests/test_torch_agg_solve_f32.py)."""
    rhs = np.ones(16 ** 3)
    sj = jx.create_solver(jx.AMGConfig(NESTED))
    sj.setup(jax_poisson7pt_device(16, 16, 16, device_dtype=dtype))
    rj = sj.solve(rhs)
    sp_ = amgx.create_solver(NESTED)
    sp_.setup(poisson7pt_device(16, 16, 16, device_dtype=dtype,
                                device="cpu"))
    rp = sp_.solve(rhs)
    h = sp_.preconditioner.hierarchy
    assert isinstance(h.coarse_solver, AMGSolver)
    assert len(h.levels) == 1 and h.coarse_solver.hierarchy.levels
    assert rp.iterations == rj.iterations == iters
    assert rp.status == SolveStatus.SUCCESS
    hp, hj = rp.residual_history, np.asarray(rj.residual_history)
    assert hp.shape == hj.shape
    if dtype == np.float64:
        np.testing.assert_allclose(hp, hj, rtol=1e-9)
