"""Equation scaling (``solvers/scalers.py``) and ``matrix_reorder=RCM``
(``Solver._maybe_reorder``) on the port against the JAX package on the
CPU, mirroring ``test_solvers.py:318-366``, ``test_coloring_smoothers.py
:151-170`` and ``test_matrix_ops.py:173-202``: the scaler's factors bit
for bit (the same numpy code), the scaled and the reordered solves'
iteration counts equal, f64 residual histories to ``HIST_RTOL`` and x to
``X_RTOL``.  A scaled solve monitors the scaled residual, as upstream."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import amgx_tpu as jx
from amgx_tpu.io import poisson5pt
from amgx_tpu.solvers.scalers import create_scaler as jax_create_scaler

import amgx_tpu_torch as amgx
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.solvers.scalers import create_scaler

#: f64 residual histories of the same solve in another summation order
HIST_RTOL = 1e-8
#: f64 solutions of the same solve
X_RTOL = 1e-8


class _Cfg:
    def get(self, k, scope=None):
        return 0


def _badly_scaled(n_side=20, decades=5, seed=8):
    A0 = sp.csr_matrix(poisson5pt(n_side, n_side)).astype(np.float64)
    s = 10.0 ** np.random.default_rng(seed).uniform(-decades, decades,
                                                    A0.shape[0])
    return sp.csr_matrix(sp.diags(s) @ A0 @ sp.diags(s))


@pytest.mark.parametrize("kind", ["DIAGONAL_SYMMETRIC", "BINORMALIZATION",
                                  "NBINORMALIZATION"])
def test_scaler_factors_match_jax(kind):
    A = _badly_scaled()
    got = create_scaler(kind, _Cfg(), "default").setup(A)
    want = jax_create_scaler(kind, _Cfg(), "default").setup(A)
    assert np.array_equal(got.dl, want.dl)
    assert np.array_equal(got.dr, want.dr)
    Ag, Aw = got.scale_matrix(A), want.scale_matrix(A)
    assert np.array_equal(Ag.toarray(), Aw.toarray())
    # the solve boundary on a tensor: the same products as numpy's
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    assert np.array_equal(got.scale_rhs(torch.from_numpy(b)).numpy(),
                          want.scale_rhs(b))
    assert np.array_equal(got.unscale_solution(torch.from_numpy(b))
                          .numpy(), want.unscale_solution(b))


def _both(A, cfg, b):
    """(JAX result, port result, port solver) of one solve."""
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jx.Matrix(A))
    sp_ = amgx.create_solver(cfg)
    sp_.setup(amgx.Matrix(A, device="cpu"))
    return sj.solve(b), sp_.solve(b), sp_


def _same(rj, rp):
    assert rp.iterations == rj.iterations, (rp.iterations, rj.iterations)
    assert int(rp.status) == int(rj.status)
    xj = np.asarray(rj.x, dtype=np.float64)
    np.testing.assert_allclose(rp.x.numpy(), xj, rtol=0,
                               atol=X_RTOL * np.abs(xj).max())


def test_nbinormalization_solve_matches_jax():
    """``test_solvers.py:318-366``: PCG + BLOCK_JACOBI on a 10-decade
    badly scaled SPD system with NBINORMALIZATION converges, in the JAX
    package's iterations and histories; the solution error against a
    direct solve < 1e-5."""
    A = _badly_scaled()
    b = np.ones(A.shape[0])
    cfg = ("config_version=2, solver(out)=PCG, out:max_iters=900, "
           "out:monitor_residual=1, out:tolerance=1e-10, "
           "out:convergence=RELATIVE_INI, out:store_res_history=1, "
           "out:preconditioner(p)=BLOCK_JACOBI, p:max_iters=1, "
           "scaling=NBINORMALIZATION")
    rj, rp, slv = _both(A, cfg, b)
    assert slv.scaler is not None
    _same(rj, rp)
    np.testing.assert_allclose(rp.residual_history,
                               np.asarray(rj.residual_history),
                               rtol=HIST_RTOL)
    x_true = spla.spsolve(A.tocsc(), b)
    err = np.linalg.norm(rp.x.numpy() - x_true) / np.linalg.norm(x_true)
    assert rp.status == 0 and err < 1e-5, err


@pytest.mark.parametrize("kind", ["DIAGONAL_SYMMETRIC", "BINORMALIZATION",
                                  "NBINORMALIZATION"])
def test_scalers_in_solver_scope_match_jax(kind):
    """``test_coloring_smoothers.py:151-170``: ``s:scaling`` on a 6-decade
    scaled 10×10 Poisson restores PCG; counts and x as the JAX
    package's, the caller's relres < 1e-6."""
    rng = np.random.default_rng(9)
    A0 = poisson5pt(10, 10)
    s = 10.0 ** rng.uniform(-3, 3, 100)
    A = sp.csr_matrix(sp.diags(s) @ A0 @ sp.diags(s))
    b = rng.standard_normal(100)
    cfg = ("config_version=2, solver(s)=PCG, "
           "s:preconditioner(p)=BLOCK_JACOBI, "
           f"p:max_iters=2, s:scaling={kind}, s:max_iters=300, "
           "s:monitor_residual=1, s:tolerance=1e-10, "
           "s:convergence=RELATIVE_INI")
    rj, rp, _ = _both(A, cfg, b)
    _same(rj, rp)
    assert np.linalg.norm(b - A @ rp.x.numpy()) / np.linalg.norm(b) < 1e-6


def test_rcm_solve_returns_the_callers_ordering():
    """``test_matrix_ops.py:173-202``: RCM on a randomly permuted 12³
    Poisson; the solve runs in permuted space and x comes back in the
    caller's order: the JAX package's count and x, relres < 1e-9, and
    the unreordered solve's x to 1e-6."""
    rng = np.random.default_rng(3)
    A0 = sp.csr_matrix(poisson7pt(12, 12, 12))
    perm = rng.permutation(A0.shape[0])
    Ap = sp.csr_matrix(A0[perm][:, perm])
    b = rng.standard_normal(Ap.shape[0])
    base = ("config_version=2, solver(s)=PCG, "
            "s:preconditioner(p)=BLOCK_JACOBI, p:max_iters=3, "
            "s:max_iters=400, s:monitor_residual=1, s:tolerance=1e-10, "
            "s:convergence=RELATIVE_INI, s:store_res_history=1, "
            "s:matrix_reorder={}")
    rj, rp, slv = _both(Ap, base.format("RCM"), b)
    assert slv._reorder is not None
    _same(rj, rp)
    assert np.array_equal(slv._reorder[0], np.asarray(
        __import__("scipy.sparse.csgraph", fromlist=["x"])
        .reverse_cuthill_mckee(Ap, symmetric_mode=False)))
    x = rp.x.numpy()
    relres = np.linalg.norm(b - Ap @ x) / np.linalg.norm(b)
    assert relres < 1e-9, relres
    plain = amgx.create_solver(base.format("NONE"))
    plain.setup(amgx.Matrix(Ap, device="cpu"))
    assert plain._reorder is None
    np.testing.assert_allclose(x, plain.solve(b).x.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_rcm_classical_on_permuted_poisson_matches_jax():
    """The classical stack (f32 pack, f64 refinement) with
    ``out:matrix_reorder=RCM`` on a randomly permuted 10³ Poisson (the
    phase-33 case at CPU size): the JAX package's count."""
    rng = np.random.default_rng(4)
    A0 = sp.csr_matrix(poisson7pt(10, 10, 10))
    perm = rng.permutation(A0.shape[0])
    Ap = sp.csr_matrix(A0[perm][:, perm])
    cfg = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
           "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
           "amg:interpolator=D2, amg:max_iters=1, "
           "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
           "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, "
           "sm:max_iters=1, amg:presweeps=2, amg:postsweeps=2, "
           "amg:min_coarse_rows=32, amg:coarse_solver=DENSE_LU_SOLVER, "
           "amg:strength_threshold=0.2401, out:matrix_reorder=RCM")
    mj = jx.Matrix(Ap)
    mj.device_dtype = np.float32
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    rj = sj.solve(np.ones(1000))
    mp = amgx.Matrix(Ap, device="cpu")
    mp.device_dtype = np.float32
    sp_ = amgx.create_solver(cfg)
    sp_.setup(mp)
    rp = sp_.solve(np.ones(1000))
    assert sp_._reorder is not None and rp.status == 0
    assert rp.iterations == rj.iterations
    x = rp.x.numpy()
    assert np.linalg.norm(1 - Ap @ x) / np.sqrt(1000) < 1e-8


def test_auto_reorder_is_a_no_op_off_the_tpu():
    """AUTO reorders only on a TPU or under the JAX package's Pallas
    interpreter; the port (the card or the CPU) never does."""
    A0 = sp.csr_matrix(poisson7pt(8, 8, 8))
    perm = np.random.default_rng(1).permutation(512)
    slv = amgx.create_solver(
        "config_version=2, solver(s)=PCG, s:max_iters=50, "
        "s:monitor_residual=1, s:tolerance=1e-8, "
        "s:convergence=RELATIVE_INI, s:matrix_reorder=AUTO")
    slv.setup(amgx.Matrix(sp.csr_matrix(A0[perm][:, perm]), device="cpu"))
    assert slv._reorder is None
