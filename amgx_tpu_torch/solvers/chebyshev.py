"""Chebyshev iteration and the polynomial smoothers (port of
``amgx_tpu/solvers/chebyshev.py``; reference
``core/src/solvers/cheb_solver.cu`` with the λ-estimate modes 0-3,
``chebyshev_poly.cu``, ``polynomial_solver.cu``,
``kpz_polynomial_solver.cu``).

Each is SpMVs and elementwise work, with every coefficient fixed at
setup: the spectrum estimates run once there — a Lanczos recurrence
(:func:`lanczos_spectrum`) or a power iteration
(:func:`power_iteration_lambda_max`) on the device, fetched to the host
once at the end — so an application holds no host sync and runs inside
the AMG's CUDA graph.

The card and the CPU divide in the same way only when the divisor is a
device tensor: on a CUDA tensor PyTorch turns a division by a Python
number into a product with its reciprocal, which rounds otherwise.  The
coefficients that divide a vector are therefore 0-d tensors on its
device (:class:`_Consts`).  The Lanczos recurrence sums an f32 operand in f64
(``ordered.wdot``, ``wgram_dots``) and subtracts its projections left to
right (``ordered.lincomb``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import compute_dtype
from ..errors import BadParametersError
from ..ops import ordered
from ..ops.spmv import abs_rowsum, spmv
from .base import Solver, register_solver
from .jacobi import apply_dinv, setup_dinv
from .krylov import _PrecondMixin


class _Consts:
    """The 0-d device tensors of a solver's fixed coefficients, made at
    their first use (an eager application: on the card, the AMG graph's
    warm-up) and reused after — a capture may not copy a Python number to
    the card."""

    def __init__(self):
        self._cache = {}

    def __call__(self, value: float, like: torch.Tensor) -> torch.Tensor:
        key = (value, like.dtype, like.device)
        t = self._cache.get(key)
        if t is None:
            t = self._cache[key] = torch.tensor(value, dtype=like.dtype,
                                                device=like.device)
        return t

    def div(self, v: torch.Tensor, c: float) -> torch.Tensor:
        """v / c, the divisor a 0-d tensor on v's device (a true
        division on every device)."""
        return v / self(c, v)


def lanczos_spectrum(matvec, n: int, dtype: torch.dtype, device,
                     m: int = 40, seed: int = 0):
    """(λmin, λmax) Ritz estimates of a self-adjoint operator from an
    m-step Lanczos recurrence with full reorthogonalisation, started
    from ``np.random.default_rng(seed)``: the recurrence runs on the
    device, its (m,) coefficients are fetched once, and ``eigvalsh`` of
    the tridiagonal T on the host gives the Ritz values."""
    m = int(min(m, max(2, n - 1)))
    x0 = np.random.default_rng(seed).standard_normal(n)
    v0 = torch.from_numpy(x0).to(device, dtype)
    V = torch.zeros((m + 1, n), dtype=dtype, device=device)
    V[0] = v0 / torch.clamp(ordered.wnrm2(v0), min=1e-30)
    alpha = torch.zeros(m, dtype=dtype, device=device)
    beta = torch.zeros(m, dtype=dtype, device=device)
    cplx = V.is_complex()
    for j in range(m):
        w = matvec(V[j])
        a = ordered.wdot(V[j], w)
        Vj = V[:j + 1]
        if cplx:
            # the JAX package's complex recurrence: α = Re(v̄ⱼ·w), and the
            # reorthogonalisation projects with Vᵀ, unconjugated
            # (``amgx_tpu/solvers/chebyshev.py:51-56``)
            a = a.real.to(dtype)
            w = w - ordered.mul(a, V[j])
            proj = ordered.wgram_dots(Vj.conj().resolve_conj(), w)
        else:
            w = w - a * V[j]
            proj = ordered.wgram_dots(Vj, w)
        # full reorthogonalisation against the built rows 0..j
        w = w - ordered.lincomb(Vj, proj)
        b = ordered.wnrm2(w)
        V[j + 1] = torch.where(b > 1e-30, ordered.div(w, torch.clamp(
            b, min=1e-30)), torch.zeros_like(w))
        alpha[j] = a
        beta[j] = b
    # the tridiagonal's real parts, as the JAX package casts it
    # (``amgx_tpu/solvers/chebyshev.py:69-70``)
    got = torch.cat([alpha, beta]).cpu().numpy().real.astype(np.float64)
    al, be = got[:m], got[m:]
    off = be[:-1]
    T = np.diag(al) + np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def _power_lambda(matvec, n: int, dtype, device, n_iters: int,
                  seed: int = 0) -> torch.Tensor:
    """The last Rayleigh-free power estimate ‖y‖/‖x‖, y = matvec(x),
    after ``n_iters`` steps from ``np.random.default_rng(seed)``: a 0-d
    tensor on the device (no host sync)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        n)).to(device, dtype)
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(n_iters):
        y = matvec(x)
        nrm = ordered.wnrm2(y)
        lam = nrm / torch.clamp(ordered.wnrm2(x), min=1e-30)
        x = y / torch.clamp(nrm, min=1e-30)
    return lam


def power_iteration_lambda_max(Ad, dinv, n_iters: int = 20,
                               seed: int = 0) -> torch.Tensor:
    """λmax of D⁻¹A by a fixed number of power steps on the device, in
    the compute dtype of the pack (at least f32); a 0-d tensor."""
    return _power_lambda(lambda v: apply_dinv(dinv, spmv(Ad, v)), Ad.n,
                         compute_dtype(Ad.dtype), Ad.device, n_iters, seed)


@register_solver("CHEBYSHEV")
class ChebyshevSolver(_PrecondMixin, Solver):
    """Chebyshev iteration on the preconditioned operator M⁻¹A over
    [λmin, λmax] (reference ``cheb_solver.cu``)."""

    is_smoother = True

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.lambda_mode = int(cfg.get("chebyshev_lambda_estimate_mode",
                                       scope))
        self.user_max = float(cfg.get("cheby_max_lambda", scope))
        self.user_min = float(cfg.get("cheby_min_lambda", scope))

    def _gershgorin_lmax(self) -> float:
        """The max abs row sum bound (reference
        ``compute_eigenmax_estimate``)."""
        if self.A is not None:
            return float(np.abs(self.A.scalar_csr()).sum(axis=1).max())
        return float(torch.max(abs_rowsum(self.Ad)))

    def _power_lmax(self) -> float:
        """λmax(M⁻¹A) by 30 power steps, with a 1.1 safety factor (power
        iteration approaches λmax from below, and an interval that
        misses the top of the spectrum makes the smoother amplify)."""
        lam = _power_lambda(lambda v: self._apply_M(spmv(self.Ad, v)),
                            self.Ad.n, compute_dtype(self.Ad.dtype),
                            self.Ad.device, 30)
        return 1.1 * float(lam)

    def solver_setup(self):
        self.consts = _Consts()
        self._setup_preconditioner(True)
        # the reference's mode semantics (cheb_solver.cu:179-242), as the
        # JAX package reads them:
        #   0: Lanczos estimate of both ends of M⁻¹A
        #   1: power λmax, λmin = λmax/8
        #   2: Gershgorin λmax unpreconditioned, else power λmax
        #   3: Gershgorin unpreconditioned, else the user's λ values
        no_pre = (self.preconditioner is None
                  or self.preconditioner.config_name == "NOSOLVER")
        if self.lambda_mode == 0:
            lmin_r, lmax = lanczos_spectrum(
                lambda v: self._apply_M(spmv(self.Ad, v)), self.Ad.n,
                compute_dtype(self.Ad.dtype), self.Ad.device)
            if lmax <= 0:
                # a degenerate Ritz estimate: re-estimate, and refuse a
                # spectrum top that is still not positive
                lmax = self._power_lmax() if not no_pre \
                    else self._gershgorin_lmax()
                if lmax <= 0:
                    raise BadParametersError(
                        "CHEBYSHEV: non-positive spectrum-top estimate "
                        "(Lanczos and power/Gershgorin both ≤ 0) — the "
                        "operator is not SPD-like; choose another "
                        "smoother or supply cheby_max/min_lambda")
                lmin = 0.125 * lmax
            else:
                lmin = min(max(lmin_r, 1e-12), 0.5 * lmax)
        elif self.lambda_mode == 1 or \
                (self.lambda_mode == 2 and not no_pre):
            lmax = self._power_lmax()
            lmin = 0.125 * lmax
        elif self.lambda_mode == 2:
            lmax = self._gershgorin_lmax()
            lmin = 0.125 * lmax
        elif self.lambda_mode == 3 and no_pre:
            lmax = self._gershgorin_lmax()
            lmin = 0.125 * lmax
        else:
            lmax, lmin = self.user_max, self.user_min
        self.lmax = lmax * 1.05  # the usual Chebyshev safety margin
        self.lmin = lmin

    def solve_init(self, b, x):
        r = b - spmv(self.Ad, x)
        return (r, torch.zeros_like(b),
                torch.zeros((), dtype=b.dtype, device=b.device))

    def solve_iteration(self, b, x, state, iter_idx: int):
        r, d, rho = state
        theta = 0.5 * (self.lmax + self.lmin)
        delta = max(0.5 * (self.lmax - self.lmin), 1e-30)
        sigma = theta / delta
        z = self._apply_M(r)
        if iter_idx == 0:
            d_new = self.consts.div(z, theta)
            rho_new = self.consts(1.0 / sigma, b)
        else:
            rho_new = 1.0 / (2.0 * sigma - rho)
            d_new = rho_new * rho * d \
                + self.consts.div(2.0 * rho_new, delta) * z
        x = x + d_new
        r = r - spmv(self.Ad, d_new)
        return x, (r, d_new, rho_new)

    def residual_norm_estimate(self, b, x, state):
        return self.norm(state[0])


@register_solver("CHEBYSHEV_POLY")
class ChebyshevPolySmoother(Solver):
    """Chebyshev polynomial smoother on the Jacobi-preconditioned
    operator D⁻¹A (reference ``chebyshev_poly.cu``): one iteration applies
    a degree-``chebyshev_polynomial_order`` polynomial over
    [λmax/30, λmax], λmax from 20 power steps (×1.05)."""

    is_smoother = True
    complex_refused = ("its power iteration's loop carry, "
                       "amgx_tpu/solvers/chebyshev.py:91")

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.order = int(cfg.get("chebyshev_polynomial_order", scope))

    def solver_setup(self):
        self.consts = _Consts()
        self.dinv = setup_dinv(self)
        lmax = float(power_iteration_lambda_max(self.Ad, self.dinv))
        self.lmax = 1.05 * lmax
        self.lmin = self.lmax / 30.0

    def solve_iteration(self, b, x, state, iter_idx: int):
        # the classic three-term Chebyshev smoothing (Adams et al.)
        theta = 0.5 * (self.lmax + self.lmin)
        delta = 0.5 * (self.lmax - self.lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - spmv(self.Ad, x)
        d = self.consts.div(apply_dinv(self.dinv, r), theta)
        x = x + d
        for _ in range(self.order - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - spmv(self.Ad, x)
            d = rho_new * rho * d + 2.0 * rho_new / delta * apply_dinv(
                self.dinv, r)
            x = x + d
            rho = rho_new
        return x, state


@register_solver("POLYNOMIAL")
class PolynomialSmoother(Solver):
    """Neumann-series polynomial smoother (reference
    ``polynomial_solver.cu``): x += Σ_{k<μ} (I − D⁻¹A)^k D⁻¹ r with
    μ = ``kpz_mu``."""

    is_smoother = True

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.mu = int(cfg.get("kpz_mu", scope))

    def solver_setup(self):
        self.dinv = setup_dinv(self)

    def solve_iteration(self, b, x, state, iter_idx: int):
        r = b - spmv(self.Ad, x)
        z = apply_dinv(self.dinv, r)
        acc = z
        for _ in range(self.mu - 1):
            z = z - apply_dinv(self.dinv, spmv(self.Ad, z))
            acc = acc + z
        return x + acc, state


@register_solver("KPZ_POLYNOMIAL")
class KPZPolynomialSmoother(ChebyshevPolySmoother):
    """KPZ polynomial smoother (reference ``kpz_polynomial_solver.cu``),
    as the JAX package realises it: a Chebyshev polynomial of order
    ``kpz_order`` on D⁻¹A."""

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.order = int(cfg.get("kpz_order", scope))
