"""Shared oracle helpers of the solver parity tests
(``tests/test_torch_krylov_family.py``, ``test_torch_idr.py``,
``test_torch_chebyshev.py``, ``test_torch_colored_smoothers.py``,
``test_torch_ilu.py``): the same numpy inputs through the JAX package
and the port on the CPU, in f64.

Residual histories agree to ``HIST_RTOL``; entries near the end of a
solve also to ``HIST_ATOL`` of the initial norm, because a recomputed
true residual ``b − A·x`` carries an absolute rounding of about
ε·‖b‖·κ whatever its size, which no summation order avoids."""
import numpy as np
import torch

import amgx_tpu as jx

import amgx_tpu_torch as amgx

#: relative agreement of two f64 residual histories
HIST_RTOL = 1e-10
#: ... and absolute, as a fraction of the initial residual norm
HIST_ATOL = 1e-12
#: one application of a smoother in f64: the same products summed in
#: another order
SWEEP_RTOL = 1e-12


def matrices(A, b: int = 1):
    """The JAX package's Matrix and the port's (CPU) of one host
    matrix."""
    return jx.Matrix(A, block_dim=b), amgx.Matrix(A, block_dim=b,
                                                  device="cpu")


def solve_both(A, cfg: str, b: int = 1, rhs=None):
    """(JAX result, port result, port solver) of one solve of ``cfg``
    on ``A`` with ``rhs`` (default all ones)."""
    rhs = np.ones(A.shape[0]) if rhs is None else rhs
    mj, mp = matrices(A, b)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    sp_ = amgx.create_solver(cfg)
    sp_.setup(mp)
    return sj.solve(rhs), sp_.solve(rhs), sp_


def assert_same_solve(rj, rp, iterations=None):
    """Equal iteration counts and histories (``HIST_RTOL``/``HIST_ATOL``)."""
    assert rp.iterations == rj.iterations, (rp.iterations, rj.iterations)
    if iterations is not None:
        assert rp.iterations == iterations, rp.iterations
    hj = np.asarray(rj.residual_history, dtype=np.float64)
    hp = np.asarray(rp.residual_history, dtype=np.float64)
    assert hp.shape == hj.shape, (hp.shape, hj.shape)
    np.testing.assert_allclose(hp, hj, rtol=HIST_RTOL,
                               atol=HIST_ATOL * float(np.max(hj[0])))


def relres(A, x, rhs) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs))


def apply_both(A, cfg: str, b: int = 1, seed: int = 0, x0=True):
    """One application (``apply``) of the solver of ``cfg`` in both
    packages, on the same random right-hand side and initial guess
    (none with ``x0=False``): (JAX x, port x, JAX solver, port solver)."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    rhs = rng.standard_normal(n)
    x = rng.standard_normal(n) if x0 else None
    mj, mp = matrices(A, b)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    sp_ = amgx.create_solver(cfg)
    sp_.setup(mp)
    import jax.numpy as jnp
    xj = sj.apply(jnp.asarray(rhs), None if x is None else jnp.asarray(x))
    xp = sp_.apply(torch.from_numpy(rhs),
                   None if x is None else torch.from_numpy(x.copy()))
    return np.asarray(xj), xp.numpy(), sj, sp_
