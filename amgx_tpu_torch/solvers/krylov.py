"""Krylov solvers: CG, PCG, BiCGStab and flexible GMRES (port of
``_PrecondMixin``, ``CGSolver``, ``PCGSolver``, ``_BiCGStabBase``,
``BiCGStabSolver``, ``PBiCGStabSolver``, ``_GMRESBase`` and
``FGMRESSolver`` of ``amgx_tpu/solvers/krylov.py``; reference
``core/src/solvers/{cg,pcg,bicgstab,pbicgstab,fgmres}_solver.cu``).

BiCGStab keeps ρ, α, ω and its breakdown code as 0-d device tensors; the
code (``errors.BREAKDOWN_KRYLOV`` when r ⊥ r*) rides the iteration's one
host fetch with the residual norm.

CG/PCG run the CLASSIC communication mode only (two reductions per
iteration); CA and PIPELINED raise.  α and β stay 0-d device tensors
(guarded divisions via ``torch.where``); the only host sync of an
iteration is the convergence check on ‖r‖.

FGMRES orthogonalises by two-pass classical Gram–Schmidt (CGS2, the
CLASSIC reduction layout): two matrix-vector products against the live basis
rows per Arnoldi step, an f32 basis summed in f64 and rounded once, and the
projections subtracted as a left-to-right combination of the rows
(``ordered.wgram_dots``, ``ordered.lincomb``), so the card and the CPU
take the same f32 steps.  The restart position ``j = iter % m`` is a host
int, so the basis slices are exact and no masks are needed.

Each FGMRES iteration fetches ONE small array from the device: the new
Hessenberg column (plus ‖r‖ after a restart).  The Givens rotations, the
least-squares right-hand side ``g`` and the quasi-residual — which is the
convergence check — then run on the host in the solve dtype, and the
cycle-end triangular solve is an (m×m) host solve followed by one device
matrix-vector product.  The Krylov buffers V and Z are preallocated and
updated in place (one (m+1)×n and one m×n buffer per solve).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from ..device import numpy_dtype
from ..errors import BREAKDOWN_KRYLOV, NotImplementedError_
from ..ops import blas, ordered
from ..ops.spmv import spmv
from .base import Solver, SolverFactory, register_solver


class _PrecondMixin:
    """Allocates the nested preconditioner from the config scope."""

    def _setup_preconditioner(self, use_precond: bool):
        self.preconditioner: Optional[Solver] = None
        if use_precond and self.cfg.has("preconditioner", self.scope):
            self.preconditioner = SolverFactory.allocate(
                self.cfg, self.scope, "preconditioner")
            self.preconditioner.setup(self.A if self.A is not None
                                      else self.Ad)

    def _apply_M(self, r):
        if self.preconditioner is None:
            return r
        return self.preconditioner.apply(r)


def _guarded_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den, or 0 where den == 0 — without a host sync."""
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 0.0)


@dataclasses.dataclass
class _CGState:
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor


def _classic_only(cfg, scope, what: str):
    if str(cfg.get("krylov_comm", scope)) != "CLASSIC":
        raise NotImplementedError_(
            f"krylov_comm CA/PIPELINED ({what}) is a later slice of the "
            "port")


@register_solver("CG")
class CGSolver(Solver):
    """Plain conjugate gradient (reference ``cg_solver.cu``), CLASSIC
    mode."""

    use_preconditioner = False

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        _classic_only(cfg, scope, "the fused CG reductions")

    def solver_setup(self):
        if self.use_preconditioner:
            self._setup_preconditioner(True)

    def _M(self, r):
        return r

    def solve_init(self, b, x):
        r = b - spmv(self.Ad, x)
        z = self._M(r)
        return _CGState(r=r, p=z, rz=blas.dot(r, z))

    def solve_iteration(self, b, x, st: _CGState, iter_idx: int):
        q = spmv(self.Ad, st.p)
        alpha = _guarded_div(st.rz, blas.dot(st.p, q))
        x = x + alpha * st.p
        r = st.r - alpha * q
        z = self._M(r)
        rz_new = blas.dot(r, z)
        beta = _guarded_div(rz_new, st.rz)
        return x, _CGState(r=r, p=z + beta * st.p, rz=rz_new)

    def residual_norm_estimate(self, b, x, st: _CGState):
        return self.norm(st.r)


@dataclasses.dataclass
class _GMRESState:
    V: torch.Tensor        # (m+1, n) Krylov basis (device, in place)
    Z: torch.Tensor        # (m, n) preconditioned basis (device, in place)
    R: np.ndarray          # (m+1, m) triangularised Hessenberg (host)
    g: np.ndarray          # (m+1,) least-squares right-hand side (host)
    cs: np.ndarray         # (m,) Givens cosines (host)
    sn: np.ndarray         # (m,) Givens sines (host)
    x_base: torch.Tensor   # x at cycle start
    quasi_res: np.ndarray  # (1,) |g[j+1]|
    j: int                 # last completed column of the cycle
    beta: Optional[torch.Tensor]  # ‖r‖ awaiting the next fetch into g[0]


class _GMRESBase(Solver):
    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.restart = int(cfg.get("gmres_n_restart", scope))
        krylov_dim = int(cfg.get("gmres_krylov_dim", scope))
        if krylov_dim > 0:
            self.restart = min(self.restart, krylov_dim)
        _classic_only(cfg, scope, "the fused Arnoldi pass")

    def solver_setup(self):
        self._setup_preconditioner(True)

    def solve_init(self, b, x):
        m, n = self.restart, b.shape[0]
        r = b - spmv(self.Ad, x)
        beta = ordered.wnrm2(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = _normalized(r, beta)
        Z = torch.zeros((m, n), dtype=b.dtype, device=b.device)
        ndt = numpy_dtype(b.dtype)
        return _GMRESState(
            V=V, Z=Z, R=np.zeros((m + 1, m), ndt), g=np.zeros(m + 1, ndt),
            cs=np.zeros(m, ndt), sn=np.zeros(m, ndt), x_base=x,
            quasi_res=np.zeros(1, ndt), j=-1, beta=beta)

    def _solve_ls_and_update(self, st: _GMRESState, j: int):
        """x = x_base + Z[:j+1]ᵀ·y where R[:j+1, :j+1]·y = g[:j+1]."""
        if j < 0:
            return st.x_base
        y = scipy.linalg.solve_triangular(st.R[:j + 1, :j + 1],
                                          st.g[:j + 1], lower=False)
        y = torch.from_numpy(np.ascontiguousarray(y, st.g.dtype)).to(
            st.Z.device)
        return st.x_base + ordered.lincomb(st.Z[:j + 1], y)

    def solve_iteration(self, b, x, st: _GMRESState, iter_idx: int):
        m = self.restart
        j = iter_idx % m
        if j == 0 and iter_idx > 0:
            # restart: the true residual seeds a fresh basis
            r = b - spmv(self.Ad, x)
            st.beta = ordered.wnrm2(r)
            st.V[0] = _normalized(r, st.beta)
            st.x_base = x
            st.g[:] = 0
            st.cs[:] = 0
            st.sn[:] = 0

        # Arnoldi step with CGS2 against the live rows 0..j
        z_j = self._apply_M(st.V[j])
        w = spmv(self.Ad, z_j)
        Vj = st.V[:j + 1]
        h1 = ordered.wgram_dots(Vj, w)
        w = w - ordered.lincomb(Vj, h1)
        h2 = ordered.wgram_dots(Vj, w)
        w = w - ordered.lincomb(Vj, h2)
        h_next = ordered.wnrm2(w)
        st.V[j + 1] = _normalized(w, h_next)
        st.Z[j] = z_j

        # the iteration's one host fetch: the Hessenberg column (+ ‖r‖)
        parts = [h1 + h2, h_next.reshape(1)]
        if st.beta is not None:
            parts.append(st.beta.reshape(1))
        got = torch.cat(parts).cpu().numpy()
        if st.beta is not None:
            st.g[0] = abs(got[j + 2])
            st.beta = None
        hcol = np.zeros(m + 1, st.g.dtype)
        hcol[:j + 2] = got[:j + 2]

        # previous Givens rotations, then the new one zeroing h[j+1]
        for i in range(j):
            ci, si = st.cs[i], st.sn[i]
            hi, hi1 = hcol[i], hcol[i + 1]
            hcol[i] = ci * hi + si * hi1
            hcol[i + 1] = -si * hi + ci * hi1
        hj, hj1 = hcol[j], hcol[j + 1]
        denom = np.sqrt(hj * hj + hj1 * hj1)
        if denom == 0:
            c, s = hj.dtype.type(1), hj.dtype.type(0)
        else:
            c, s = hj / denom, hj1 / denom
        hcol[j] = c * hj + s * hj1
        hcol[j + 1] = 0
        st.cs[j], st.sn[j] = c, s
        gj = st.g[j]
        st.g[j] = c * gj
        st.g[j + 1] = -s * gj
        st.R[:, j] = hcol
        st.quasi_res = np.abs(st.g[j + 1:j + 2])
        st.j = j

        if j == m - 1:
            # end of cycle: fold the LS solution into x; a later
            # solve_finalize then adds nothing on top
            x = self._solve_ls_and_update(st, j)
            st.x_base = x
            st.g[:] = 0
            return x, st
        return st.x_base, st

    def residual_norm_estimate(self, b, x, st):
        if self.norm_type == "L2" and (self.use_scalar_norm or
                                       self.Ad.block_dim == 1):
            return st.quasi_res
        return None

    def solve_finalize(self, b, x, st):
        # mid-cycle exit: fold the pending LS solution into x
        return self._solve_ls_and_update(st, st.j)


def _normalized(v: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """v / nrm, or zeros when nrm == 0 — without a host sync."""
    safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return torch.where(nrm > 0, v / safe, torch.zeros_like(v))


@register_solver("PCG")
class PCGSolver(_PrecondMixin, CGSolver):
    """Preconditioned CG (reference ``pcg_solver.cu``)."""

    use_preconditioner = True

    def _M(self, r):
        return self._apply_M(r)


@register_solver("FGMRES")
class FGMRESSolver(_PrecondMixin, _GMRESBase):
    """Flexible GMRES: stores the preconditioned vectors Z so the
    preconditioner (an AMG cycle) may change every iteration."""


@dataclasses.dataclass
class _BiCGStabState:
    r: torch.Tensor
    r_star: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    omega: torch.Tensor
    brk: torch.Tensor      # int32 breakdown code (errors.BREAKDOWN_*)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.ones_like(d), d)


#: x·y for BiCGStab's scalars: ρ, α and ω steer its f32 count, so an
#: f32 pair is summed in f64 and rounded once
#: (:func:`~..ops.ordered.wdot`)
_wdot = ordered.wdot


class _BiCGStabBase(Solver):
    """BiCGStab skeleton; ``_M`` hooks (right) preconditioning."""

    def _M(self, r):
        return r

    def solve_init(self, b, x):
        r = b - spmv(self.Ad, x)
        one = torch.ones((), dtype=r.dtype, device=r.device)
        return _BiCGStabState(
            r=r, r_star=r, p=torch.zeros_like(r), v=torch.zeros_like(r),
            rho=one, alpha=one, omega=one,
            brk=torch.zeros((), dtype=torch.int32, device=r.device))

    def solve_iteration(self, b, x, st: _BiCGStabState, iter_idx: int):
        rho_new = _wdot(st.r_star, st.r)
        # the serious breakdown r ⊥ r*: provisional (the monitor drops it
        # when the residual is dead, i.e. ordinary convergence)
        brk = torch.where((st.brk == 0) & (rho_new == 0),
                          torch.full_like(st.brk, BREAKDOWN_KRYLOV),
                          st.brk)
        beta = (rho_new / _safe(st.rho)) * (st.alpha / _safe(st.omega))
        p = st.r + beta * (st.p - st.omega * st.v)
        p_hat = self._M(p)
        v = spmv(self.Ad, p_hat)
        alpha = rho_new / _safe(_wdot(st.r_star, v))
        s = st.r - alpha * v
        s_hat = self._M(s)
        t = spmv(self.Ad, s_hat)
        tt = _wdot(t, t)
        omega = torch.where(tt != 0, _wdot(t, s) / _safe(tt),
                            torch.zeros_like(tt))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        return x, _BiCGStabState(r=r, r_star=st.r_star, p=p, v=v,
                                 rho=rho_new, alpha=alpha, omega=omega,
                                 brk=brk)

    def residual_norm_estimate(self, b, x, st: _BiCGStabState):
        return self.norm(ordered.widen(st.r)).to(st.r.dtype)


@register_solver("BICGSTAB")
class BiCGStabSolver(_BiCGStabBase):
    """Reference ``bicgstab_solver.cu``."""


@register_solver("PBICGSTAB")
class PBiCGStabSolver(_PrecondMixin, _BiCGStabBase):
    """Right-preconditioned BiCGStab (reference ``pbicgstab_solver.cu``)."""

    def solver_setup(self):
        self._setup_preconditioner(True)

    def _M(self, r):
        return self._apply_M(r)
