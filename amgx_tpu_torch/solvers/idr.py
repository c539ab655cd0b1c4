"""IDR(s) solvers (port of ``amgx_tpu/solvers/idr.py``; reference
``core/src/solvers/idr_solver.cu`` and ``idrmsync_solver.cu``, induced
dimension reduction, ``subspace_dim_s`` core.cu:416).

IDR(s) with biorthogonalisation (van Gijzen & Sonneveld),
right-preconditioned.  One iteration is one cycle: s intermediate steps
and the (s+1)-th minimising step, s + 1 SpMVs and preconditioner
applications.  IDRMSYNC is Collignon & van Gijzen's restructuring: one
shadow projection a direction, the elimination coefficients from one
triangular solve, and ``f`` and ``P·g`` updated algebraically.

The shadow space P is drawn at setup from ``np.random.default_rng(11)``
and orthonormalised by a numpy QR on the host, as in the JAX package, and
uploaded once.  The projections onto P sum an f32 operand in f64
(``ordered.wgram_dots``) and the combinations of the G and U rows add
left to right (``ordered.lincomb``).  The s × s solves of each step run
on the device (``torch.linalg.solve_ex`` / ``solve_triangular``): the
library orders their sums its own way on each device, so the card and
the CPU agree on the iteration count but not on x bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import ordered
from ..ops.spmv import spmv
from .base import Solver, register_solver
from .krylov import _PrecondMixin


@dataclasses.dataclass
class _IDRState:
    r: torch.Tensor
    G: torch.Tensor       # (s, n) direction matrix (in place)
    U: torch.Tensor       # (s, n) (in place)
    M: torch.Tensor       # (s, s) P·Gᵀ (in place)
    om: torch.Tensor


def _small_solve(M: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """(M + 1e-30·I)⁻¹·f for the s × s system of one step, without a
    host check of the factorisation (the library's order of sums, which
    differs between the card and the CPU)."""
    s = M.shape[0]
    eye = torch.eye(s, dtype=M.dtype, device=M.device)
    return torch.linalg.solve_ex(M + eye * 1e-30, f[:, None],
                                 check_errors=False)[0][:, 0]


def _min_residual_step(Ad, apply_M, x, r):
    """The (s+1)-th step: ω = (t, r)/(t, t) with t = A·M·r."""
    v = apply_M(r)
    t = spmv(Ad, v)
    tt = ordered.wdot(t, t)
    safe = torch.where(tt == 0, torch.ones_like(tt), tt)
    om = torch.where(tt != 0, ordered.wdot(t, r) / safe,
                     torch.zeros_like(tt))
    return x + om * v, r - om * t, om


@register_solver("IDR")
class IDRSolver(_PrecondMixin, Solver):
    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.s = int(cfg.get("subspace_dim_s", scope))

    def solver_setup(self):
        self._setup_preconditioner(True)
        s, n = self.s, self.Ad.n
        # fixed shadow space P (random orthonormal rows)
        rng = np.random.default_rng(11)
        P = rng.standard_normal((s, n))
        P, _ = np.linalg.qr(P.T)
        self.P = torch.from_numpy(np.ascontiguousarray(P.T[:s])).to(
            self.Ad.device, self.Ad.dtype)

    def _proj(self, v: torch.Tensor) -> torch.Tensor:
        """P·v, an f32 operand summed in f64 and rounded once."""
        return ordered.wgram_dots(self.P, v)

    def solve_init(self, b, x):
        s, n = self.s, b.shape[0]
        r = b - spmv(self.Ad, x)
        z = lambda *shape: torch.zeros(shape, dtype=b.dtype,
                                       device=b.device)
        return _IDRState(r=r, G=z(s, n), U=z(s, n),
                         M=torch.eye(s, dtype=b.dtype, device=b.device),
                         om=torch.ones((), dtype=b.dtype, device=b.device))

    def _direction(self, st: _IDRState, r, f):
        """u = ω·M(r − G·c) + U·c and g = A·u, c = M⁻¹ f."""
        c = _small_solve(st.M, f)
        v = self._apply_M(r - ordered.lincomb(st.G, c))
        u = st.om * v + ordered.lincomb(st.U, c)
        return u, spmv(self.Ad, u)

    def solve_iteration(self, b, x, st: _IDRState, iter_idx: int):
        """One IDR(s) cycle: s intermediate steps, each
        biorthogonalised against the shadow rows before it, then the
        minimising step."""
        s, G, U, M = self.s, st.G, st.U, st.M
        r = st.r
        f = self._proj(r)
        for k in range(s):
            u_new, g_new = self._direction(st, r, f)
            pg = self._proj(g_new)
            for j in range(k):
                alpha = pg[j] / torch.where(M[j, j] == 0, 1.0, M[j, j])
                g_new = g_new - alpha * G[j]
                u_new = u_new - alpha * U[j]
                pg = self._proj(g_new)
            G[k] = g_new
            U[k] = u_new
            M[:, k] = pg
            beta = f[k] / torch.where(M[k, k] == 0, 1.0, M[k, k])
            r = r - beta * g_new
            x = x + beta * u_new
            f = self._proj(r)
        x, r, om = _min_residual_step(self.Ad, self._apply_M, x, r)
        return x, _IDRState(r=r, G=G, U=U, M=M, om=om)

    def residual_norm_estimate(self, b, x, st: _IDRState):
        return self.norm(st.r)


@register_solver("IDRMSYNC")
class IDRMSyncSolver(IDRSolver):
    """Minimal-synchronisation IDR(s) (``idrmsync_solver.cu``): ONE
    shadow projection per direction, the elimination coefficients from
    one triangular solve against the strictly-lower block of M, and the
    projected residual ``f`` and ``P·g`` updated by the same triangular
    algebra — s + 2 reductions a cycle instead of O(s²)."""

    def solve_iteration(self, b, x, st: _IDRState, iter_idx: int):
        s, G, U, M = self.s, st.G, st.U, st.M
        r = st.r
        f = self._proj(r)                       # sync 1 of the cycle
        for k in range(s):
            u_new, g_new = self._direction(st, r, f)
            pg = self._proj(g_new)              # the one projection
            if k:
                eye = torch.eye(k, dtype=M.dtype, device=M.device)
                alpha = torch.linalg.solve_triangular(
                    M[:k, :k] + eye * 1e-30, pg[:k, None],
                    upper=False)[:, 0]
                g_new = g_new - ordered.lincomb(G[:k], alpha)
                u_new = u_new - ordered.lincomb(U[:k], alpha)
                # P(g − Σ αⱼ Gⱼ) = pg − M·α, without a fresh projection
                pg = pg - ordered.lincomb(M[:, :k].T, alpha)
            G[k] = g_new
            U[k] = u_new
            M[:, k] = pg
            beta = f[k] / torch.where(pg[k] == 0, 1.0, pg[k])
            r = r - beta * g_new
            x = x + beta * u_new
            f = f - beta * pg                   # algebraic, no sync
        x, r, om = _min_residual_step(self.Ad, self._apply_M, x, r)
        return x, _IDRState(r=r, G=G, U=U, M=M, om=om)
