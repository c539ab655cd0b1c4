"""Chebyshev iteration and the polynomial smoothers (CHEBYSHEV,
CHEBYSHEV_POLY, POLYNOMIAL, KPZ_POLYNOMIAL) in the port against the JAX
package on the CPU in f64: the setup state (the Lanczos (λmin, λmax),
the power-iteration λmax, each estimate mode's interval) to 1e-10, one
application to ``SWEEP_RTOL``, and whole solves — CHEBYSHEV standalone
(the ``CHEB_SOLVER_NOPREC`` shape) and the polynomial smoothers inside
the headline's GEO-aggregation AMG (the ``V-cheby-smoother`` shape) —
with equal counts and histories to ``HIST_RTOL``/``HIST_ATOL``
(``torch_solver_parity``)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
import jax.numpy as jnp
from amgx_tpu.io import poisson7pt_device as jax_poisson7pt_device
from amgx_tpu.solvers import chebyshev as jcheb

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
from amgx_tpu_torch.solvers import chebyshev as pcheb
from chip_smoke import HEADLINE_CFG
from torch_solver_parity import (SWEEP_RTOL, apply_both, assert_same_solve,
                                 matrices, solve_both)

SETUP_RTOL = 1e-10
A10 = sp.csr_matrix(poisson7pt(10, 10, 10))


def _anisotropic(n=12, eps=0.05):
    """A 2-D anisotropic operator: a spread-out spectrum."""
    d = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1])
    eye = sp.identity(n)
    return sp.csr_matrix(sp.kron(eye, d) + eps * sp.kron(d, eye))


@pytest.mark.parametrize("op", ["poisson7", "anisotropic"])
def test_lanczos_spectrum_matches_jax(op):
    A = A10 if op == "poisson7" else _anisotropic()
    mj, mp = matrices(A)
    Aj, Ap = mj.device(), mp.device()
    from amgx_tpu.ops.spmv import spmv as jspmv
    from amgx_tpu_torch.ops.spmv import spmv as pspmv
    want = jcheb._lanczos_spectrum(lambda v: jspmv(Aj, v), A.shape[0],
                                   jnp.float64)
    got = pcheb.lanczos_spectrum(lambda v: pspmv(Ap, v), A.shape[0],
                                 torch.float64, torch.device("cpu"))
    np.testing.assert_allclose(got, want, rtol=SETUP_RTOL)
    ev = np.linalg.eigvalsh(A.toarray())
    assert got[1] <= ev[-1] * (1 + 1e-12) and got[1] > 0.99 * ev[-1]


def test_power_iteration_matches_jax():
    mj, mp = matrices(A10)
    from amgx_tpu.solvers.jacobi import setup_dinv as jdinv
    from amgx_tpu_torch.solvers.jacobi import setup_dinv as pdinv

    class _S:
        pass
    sj, sp_ = _S(), _S()
    sj.Ad, sj.A, sp_.Ad, sp_.A = mj.device(), mj, mp.device(), mp
    want = float(jcheb._power_iteration_lambda_max(sj.Ad, jdinv(sj)))
    got = float(pcheb.power_iteration_lambda_max(sp_.Ad, pdinv(sp_)))
    np.testing.assert_allclose(got, want, rtol=SETUP_RTOL)


CHEB = ("config_version=2, solver(out)=CHEBYSHEV, out:max_iters={it}, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, out:store_res_history=1, "
        "out:chebyshev_lambda_estimate_mode={mode}")


@pytest.mark.parametrize("pre", ["", "p"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_chebyshev_solver_matches_jax(mode, pre):
    """A fixed budget of 40 iterations: the interval of each estimate
    mode, the history and the residual reached."""
    cfg = CHEB.format(it=40, mode=mode)
    if pre:
        cfg += (", out:preconditioner(p)=BLOCK_JACOBI, p:max_iters=1, "
                "out:cheby_max_lambda=1.9, out:cheby_min_lambda=0.1")
    rj, rp, slv = solve_both(A10, cfg)
    mj, _ = matrices(A10)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    np.testing.assert_allclose([slv.lmin, slv.lmax], [sj.lmin, sj.lmax],
                               rtol=SETUP_RTOL)
    assert_same_solve(rj, rp)


@pytest.mark.parametrize("name", ["CHEBYSHEV_POLY", "POLYNOMIAL",
                                  "KPZ_POLYNOMIAL", "CHEBYSHEV"])
def test_one_application_matches_jax(name):
    cfg = (f"config_version=2, solver(s)={name}, s:max_iters=1, "
           "s:chebyshev_polynomial_order=4, s:kpz_mu=3, s:kpz_order=2")
    xj, xp, sj, sp_ = apply_both(A10, cfg)
    np.testing.assert_allclose(xp, xj, rtol=SWEEP_RTOL,
                               atol=SWEEP_RTOL * np.max(np.abs(xj)))
    if name in ("CHEBYSHEV_POLY", "KPZ_POLYNOMIAL", "CHEBYSHEV"):
        np.testing.assert_allclose(sp_.lmax, sj.lmax, rtol=SETUP_RTOL)


def _headline(smoother: str) -> str:
    return (HEADLINE_CFG.replace("BLOCK_JACOBI", smoother)
            + ", out:store_res_history=1")


@pytest.mark.parametrize("sm", ["CHEBYSHEV_POLY", "POLYNOMIAL",
                                "KPZ_POLYNOMIAL", "CHEBYSHEV"])
def test_headline_smoother_matches_jax(sm):
    """The headline stack at 12³ (FGMRES + GEO-aggregation AMG, DIA
    levels derived on the device) with the smoother replaced."""
    cfg = _headline(sm)
    rhs = np.ones(12 ** 3)
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jax_poisson7pt_device(12, 12, 12, device_dtype=np.float64))
    rj = sj.solve(rhs)
    sp_ = amgx.create_solver(cfg)
    sp_.setup(poisson7pt_device(12, 12, 12, device_dtype=np.float64,
                                device="cpu"))
    rp = sp_.solve(rhs)
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS
    lj = sj.preconditioner.hierarchy.levels
    lp = sp_.preconditioner.hierarchy.levels
    if sm != "POLYNOMIAL":
        np.testing.assert_allclose([lv.smoother.lmax for lv in lp],
                                   [lv.smoother.lmax for lv in lj],
                                   rtol=SETUP_RTOL)
