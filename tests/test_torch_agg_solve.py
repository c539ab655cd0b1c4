"""End-to-end parity of the aggregation path between the port on the CPU
and the JAX package, on the DFG cylinder pressure operator: the headline
stack (FGMRES restart 6, CG K-cycle, block Jacobi 2+2, dense LU) with
SIZE_2 named, at ny = 32, and the config of examples/amgx_mpi_capi_agg.py
(FGMRES restart 20, V-cycle, SIZE_2, block Jacobi 1+2) at ny = 64: equal
iteration counts and f64 residual histories.

The operator has at most 48 diagonals at these sizes, so GEO would take
the DIA plan: SIZE_2 is named.  The headline runs at ny = 32 because the
JAX package compiles its K-cycle unrolled, 2^(levels−1) cycle bodies: at
ny = 64 (9 levels) its first solve's compile alone runs past a test
file's budget; ``tests/torch_agg_parity.py`` runs that size by hand.  The f32 headline count is in
tests/test_torch_agg_solve_f32.py."""
import numpy as np
import pytest
import torch

import amgx_tpu

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import dfg_cylinder_pressure
from amgx_tpu_torch.ops.spmv import DISPATCH

#: f64 residual histories: the same arithmetic in another summation
#: order (BLAS dots, Gram–Schmidt products, ELL row sums) — rounding at
#: 1e-16 grows through the AMG cycles to far below this
HIST_RTOL = 1e-6

HEADLINE_SIZE2 = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER, out:store_res_history=1")
#: examples/amgx_mpi_capi_agg.py's CONFIG, with the history stored
EXAMPLE_AGG = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=1, amg:postsweeps=2, amg:min_coarse_rows=16, "
    "amg:coarse_solver=DENSE_LU_SOLVER, out:store_res_history=1")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU solves are thousands of small ops a cycle: one
    intra-op thread runs them fastest, and keeps a worker of a parallel
    test run from contending with the others."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def solve_both(cfg, dtype, ny=64):
    """(JAX result, port result, A) of one solve of the DFG operator with
    ``b = 1`` and a ``dtype`` pack."""
    A = dfg_cylinder_pressure(ny)
    jm = amgx_tpu.Matrix(A)
    jm.device_dtype = dtype
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(jm)
    rj = ref.solve(np.ones(A.shape[0]))
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = dtype
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    rp = slv.solve(np.ones(A.shape[0]))
    return rj, rp, A


def relres(A, x):
    x = np.asarray(x, dtype=np.float64)
    return np.linalg.norm(1.0 - A @ x) / np.sqrt(A.shape[0])


@pytest.mark.parametrize("cfg,ny,iters", [(HEADLINE_SIZE2, 32, 18),
                                          (EXAMPLE_AGG, 64, 43)],
                         ids=["headline_size2", "example_agg"])
def test_f64_counts_and_histories_match_jax(cfg, ny, iters):
    before = DISPATCH["ell/gather"]
    rj, rp, A = solve_both(cfg, np.float64, ny)
    assert DISPATCH["ell/gather"] > before      # coarse ELL levels (B3)
    assert rj.iterations == iters
    assert rp.iterations == rj.iterations
    assert rp.status == SolveStatus.SUCCESS
    assert relres(A, rp.x.numpy()) <= 1e-8
    np.testing.assert_allclose(rp.residual_history,
                               np.asarray(rj.residual_history),
                               rtol=HIST_RTOL)
    np.testing.assert_allclose(rp.residual_norm,
                               np.asarray(rj.residual_norm), rtol=HIST_RTOL)


def test_example_config_f32_refined_matches_jax():
    """The V-cycle config with the f32 pack + f64 refinement: the same
    count as the JAX package, true relres within the tolerance."""
    rj, rp, A = solve_both(EXAMPLE_AGG, np.float32)
    assert rp.iterations == rj.iterations == 53
    assert rp.status == SolveStatus.SUCCESS
    assert rp.x.numpy().dtype == np.float64
    assert relres(A, rp.x.numpy()) <= 1e-8
