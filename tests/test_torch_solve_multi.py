"""``Solver.solve_multi`` of the port: per-lane results equal to
sequential ``solve`` calls, counts equal to the JAX package's
``solve_multi``, ``pad_to_bucket``, k = 0 and k = 1, ``X0`` and
``zero_initial_guess``."""
import numpy as np
import pytest
import torch

import amgx_tpu

import amgx_tpu_torch as tam
from amgx_tpu_torch.io import poisson7pt

HEADLINE = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
N = 10


@pytest.fixture(scope="module")
def setup():
    A = poisson7pt(N, N, N)
    m = tam.Matrix(A, device="cpu")
    m.device_dtype = np.float32          # the f32 pack + f64 refinement
    slv = tam.create_solver(tam.AMGConfig(HEADLINE))
    slv.setup(m)
    rng = np.random.default_rng(11)
    B = rng.standard_normal((4, A.shape[0]))
    B[2] *= 1e-3                         # lanes of different scale
    return A, slv, B


def test_lanes_equal_sequential_and_jax_counts(setup):
    A, slv, B = setup
    out = slv.solve_multi(B)
    assert len(out) == len(B)
    for bj, rj in zip(B, out):
        single = slv.solve(bj)
        assert torch.equal(rj.x, single.x)
        assert rj.iterations == single.iterations and rj.status == 0
        assert np.linalg.norm(bj - A @ rj.x.numpy()) \
            <= 1e-7 * np.linalg.norm(bj)
    jm = amgx_tpu.Matrix(A)
    jm.device_dtype = np.float32
    js = amgx_tpu.create_solver(amgx_tpu.AMGConfig(HEADLINE))
    js.setup(jm)
    jout = js.solve_multi(B)
    assert [r.iterations for r in out] == [r.iterations for r in jout]


def test_pad_to_bucket_and_small_batches(setup):
    _A, slv, B = setup
    k3 = slv.solve_multi(B[:3], pad_to_bucket=True)
    assert len(k3) == 3
    for bj, rj in zip(B[:3], k3):
        assert torch.equal(rj.x, slv.solve(bj).x)
    assert slv.solve_multi(B[:0]) == []
    assert slv.solve_multi([]) == []
    one = slv.solve_multi([B[1]])
    assert len(one) == 1 and torch.equal(one[0].x, slv.solve(B[1]).x)


def test_initial_guesses(setup):
    _A, slv, B = setup
    X0 = 0.5 * B[:2]
    out = slv.solve_multi(B[:2], X0=X0)
    for j in range(2):
        assert torch.equal(out[j].x, slv.solve(B[j], x0=X0[j]).x)
    zero = slv.solve_multi(B[:2], X0=X0, zero_initial_guess=True)
    for j in range(2):
        assert torch.equal(zero[j].x, slv.solve(B[j]).x)


def test_recovery_is_off_for_the_batch():
    """``recovery_policy=AUTO`` stays off inside a batch (upstream's
    sequential branch), and on again after it."""
    A = poisson7pt(4, 4, 4)
    cfg = ("config_version=2, solver(out)=PCG, out:max_iters=2, "
           "out:monitor_residual=1, out:tolerance=1e-12, "
           "out:convergence=RELATIVE_INI, out:recovery_policy=AUTO")
    slv = tam.create_solver(tam.AMGConfig(cfg))
    slv.setup(tam.Matrix(A, device="cpu"))
    b = np.ones(A.shape[0])
    batch = slv.solve_multi([b, b])
    assert all(r.recovery is None and r.status != 0 for r in batch)
    assert slv.solve(b).recovery is not None
