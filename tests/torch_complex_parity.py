"""Shared oracle helpers of the complex parity tests
(``tests/test_torch_complex_solvers.py``, ``test_torch_complex_smoothers.py``,
``test_torch_complex_amg.py``, ``test_torch_complex_dist.py``): the
seeded 8³ operators of ``tests/test_complex.py`` (the Hermitian
``L + iK`` and the shifted Helmholtz ``L + (−0.4 + 0.35i)I``), a complex
2×2 block system, and one solve of a configuration through the JAX
package and the port on the CPU.

Counts are equal; residual histories agree to ``HIST_RTOL`` relative,
and late entries also to ``HIST_ATOL`` of the initial norm (a
recomputed true residual carries an absolute rounding of about ε·‖b‖
whatever its size, ``tests/torch_solver_parity.py``)."""
import numpy as np
import scipy.sparse as sp
import torch

import amgx_tpu as jx

import amgx_tpu_torch as amgx
from amgx_tpu_torch.io import poisson7pt

#: relative agreement of two c128 residual histories
HIST_RTOL = 1e-8
#: ... and absolute, as a fraction of the initial residual norm
HIST_ATOL = 1e-12

#: a Krylov solver with a one-sweep preconditioner
KRYLOV = ("config_version=2, solver(out)={name}, out:max_iters={it}, "
          "out:monitor_residual=1, out:tolerance=1e-8, "
          "out:store_res_history=1, out:convergence=RELATIVE_INI, "
          "out:gmres_n_restart=20{extra}, "
          "out:preconditioner(pre)={pre}, pre:max_iters=1")
#: FGMRES(6) around aggregation AMG, one sweep each way, DENSE_LU
AMG = ("config_version=2, solver(out)={outer}, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:store_res_history=1, out:convergence=RELATIVE_INI, "
       "out:gmres_n_restart=6, out:preconditioner(amg)=AMG, "
       "amg:algorithm={alg}, amg:selector={sel}, amg:max_iters=1, "
       "amg:max_levels=20, amg:cycle={cyc}, amg:smoother(sm)={sm}, "
       "sm:max_iters=1, amg:presweeps=1, amg:postsweeps=1, "
       "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER{extra}")


def amg_cfg(outer="FGMRES", alg="AGGREGATION", sel="SIZE_2", cyc="V",
            sm="BLOCK_JACOBI", extra=""):
    return AMG.format(outer=outer, alg=alg, sel=sel, cyc=cyc, sm=sm,
                      extra=extra)


def krylov_cfg(name, pre="BLOCK_JACOBI", it=200, extra=""):
    return KRYLOV.format(name=name, pre=pre, it=it, extra=extra)


def hermitian(side=8, seed=0):
    """L + i·K with K antisymmetric real (``tests/test_complex.py``)."""
    L = sp.csr_matrix(poisson7pt(side, side, side), dtype=np.complex128)
    n = L.shape[0]
    rng = np.random.default_rng(seed)
    coo = sp.triu(L, k=1).tocoo()
    vals = 0.3 * rng.standard_normal(len(coo.data))
    K = sp.csr_matrix((vals, (coo.row, coo.col)), shape=(n, n))
    A = sp.csr_matrix(L + 1j * (K - K.T))
    A.sort_indices()
    return A


def helmholtz(side=8, k2=0.4, eps=0.35):
    """L − k²I + iεI (``tests/test_complex.py:40-47``)."""
    L = sp.csr_matrix(poisson7pt(side, side, side), dtype=np.complex128)
    return sp.csr_matrix(L + (-k2 + 1j * eps) * sp.identity(L.shape[0]))


def block_system(side=6):
    """A complex 2×2 block system: the Helmholtz operator times a
    complex coupling block, plus 0.3i on the diagonal (BSR)."""
    B = np.array([[1.0, 0.2 + 0.1j], [0.15 - 0.05j, 1.1]])
    A = sp.kron(helmholtz(side), B).tocsr() \
        + sp.kron(sp.identity(side ** 3), 0.3j * np.eye(2))
    return sp.bsr_matrix(sp.csr_matrix(A), blocksize=(2, 2))


def crhs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def operator(name):
    """(A, b) of ``"H"`` (Hermitian) or ``"Z"`` (Helmholtz) at 8³."""
    if name == "H":
        return hermitian(), crhs(512, 1)
    return helmholtz(), crhs(512, 2)


def solve_jax(cfg, A, b, block_dim=1, mesh=None, solver=False):
    """The JAX package's result (and solver, with ``solver``)."""
    m = jx.Matrix(A, block_dim=block_dim)
    if mesh is not None:
        m.set_distribution(mesh)
    s = jx.create_solver(jx.AMGConfig(cfg))
    s.setup(m)
    return (s.solve(b), s) if solver else s.solve(b)


def solve_port(cfg, A, b, block_dim=1, mesh=None):
    m = amgx.Matrix(A, block_dim=block_dim, device="cpu")
    if mesh is not None:
        m.set_distribution(mesh)
    s = amgx.create_solver(cfg)
    s.setup(m)
    return s.solve(b), s


def relres(A, x, b) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def assert_same(rj, rp, rtol=HIST_RTOL):
    """Equal counts; histories to ``rtol`` + ``HIST_ATOL``·‖r₀‖."""
    assert rp.iterations == rj.iterations, (rp.iterations, rj.iterations)
    hj = np.asarray(rj.residual_history, dtype=np.float64)
    hp = np.asarray(rp.residual_history, dtype=np.float64)
    assert hp.shape == hj.shape, (hp.shape, hj.shape)
    np.testing.assert_allclose(hp, hj, rtol=rtol,
                               atol=HIST_ATOL * float(np.max(hj[0])))


def both(cfg, A, b, block_dim=1):
    """One solve in each package: (JAX result, port result, port
    solver); the port's x is complex128 on the CPU."""
    rj = solve_jax(cfg, A, b, block_dim)
    rp, sp_ = solve_port(cfg, A, b, block_dim)
    assert rp.x.dtype == torch.complex128 and rp.x.device.type == "cpu"
    return rj, rp, sp_
