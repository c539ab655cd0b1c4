"""Krylov solvers: CG, PCG (with the CA and pipelined reduction
layouts), PCG_CA, PCG_PIPE, PCGF, BiCGStab, PBiCGStab, GMRES and flexible
GMRES (port of ``amgx_tpu/solvers/krylov.py``; reference
``core/src/solvers/{cg,pcg,pcgf,bicgstab,pbicgstab,gmres,
fgmres}_solver.cu``).

BiCGStab keeps ρ, α, ω and its breakdown code as 0-d device tensors; the
code (``errors.BREAKDOWN_KRYLOV`` when r ⊥ r*) rides the iteration's one
host fetch with the residual norm.

CG/PCG take the ``krylov_comm`` knob (or a ``forced_comm`` subclass):
CLASSIC runs two reductions an iteration; CA (Chronopoulos–Gear) and
PIPELINED (Ghysels–Vanroose) one stacked reduction that also carries the
monitor norm's accumulators (``blas.fused_reduce`` over widened
operands), and both
recompute the true residual every ``ca_residual_replace`` iterations.
LMAX norms keep CLASSIC.  CLASSIC sums its f32 inner products and its
monitor norm in f64 and rounds once (``ordered.wdot``), so the card and
the CPU take the same steps.  α and β stay 0-d device tensors (guarded
divisions via ``torch.where``); the only host sync of an iteration is the
convergence check, which also fetches the breakdown code of the CA,
pipelined and flexible loops (``_cg_breakdown``).

(F)GMRES orthogonalises by two-pass classical Gram–Schmidt (CGS2): two
matrix-vector products against the live basis rows per Arnoldi step, an
f32 basis summed in f64 and rounded once, and the projections subtracted
as a left-to-right combination of the rows (``ordered.wgram_dots``,
``ordered.lincomb``), so the card and the CPU take the same f32 steps.
With ``krylov_comm`` CA or PIPELINED the second pass and ‖w‖² share one
stacked product (``ordered.wgram_dots_with_norm``).  The restart
position ``j = iter % m`` is a host int, so the basis slices are exact
and no masks are needed.  FGMRES keeps the preconditioned vectors Z;
GMRES keeps none and applies the preconditioner once to the basis
combination at the end of a cycle.

Each (F)GMRES iteration fetches ONE small array from the device: the new
Hessenberg column (plus ‖r‖ after a restart).  The Givens rotations, the
least-squares right-hand side ``g`` and the quasi-residual — which is the
convergence check — then run on the host in the solve dtype, and the
cycle-end triangular solve is an (m×m) host solve followed by one device
combination.  The Krylov buffers are preallocated and updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg
import torch

from ..device import numpy_dtype
from ..errors import BREAKDOWN_INDEFINITE, BREAKDOWN_KRYLOV
from ..ops import blas, ordered
from ..ops.spmv import spmv
from .base import Solver, SolverFactory, register_solver


class _PrecondMixin:
    """Allocates the nested preconditioner from the config scope."""

    def _setup_preconditioner(self, use_precond: bool):
        existing = getattr(self, "preconditioner", None)
        if existing is not None and use_precond and \
                getattr(self, "_numeric_resetup", False):
            # a resetup keeps the preconditioner instance (its hierarchy
            # structure and CUDA graphs); a plain setup allocates anew
            existing.resetup(self.A if self.A is not None else self.Ad)
            return
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


def _cg_breakdown(brk: torch.Tensor, rz: torch.Tensor,
                  pq: torch.Tensor) -> torch.Tensor:
    """The in-loop CG breakdown guard: ``rho == 0`` or ``pAp == 0`` is a
    Krylov breakdown (provisional: the monitor drops it when the residual
    is dead, i.e. ordinary convergence), ``Re(pAp) < 0`` an operator or
    preconditioner that is not SPD.  The first code sticks; 0 is
    healthy."""
    kry = (rz == 0) | (pq == 0)
    indef = pq.real < 0
    code = torch.where(indef, BREAKDOWN_INDEFINITE,
                       torch.where(kry, BREAKDOWN_KRYLOV, 0)).to(torch.int32)
    return torch.where(brk == 0, code, brk)


def _no_breakdown(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclasses.dataclass
class _CGState:
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor


@dataclasses.dataclass
class _CACGState:
    """Chronopoulos–Gear state: u = M·r, w = A·u, s = A·p; gamma = (r,u)
    and delta = (w,u) of the current vectors, ``rr`` the monitor norm's
    accumulators of the current r."""
    r: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor
    gamma: torch.Tensor
    gamma_prev: torch.Tensor
    delta: torch.Tensor
    alpha_prev: torch.Tensor
    rr: torch.Tensor
    brk: torch.Tensor


@dataclasses.dataclass
class _PipeCGState:
    """Ghysels–Vanroose state: q = M·s and z = A·q as well, so the one
    reduction at the top of an iteration does not wait for m = M·w and
    n = A·m; ``rr`` is the norm of the incoming residual (one iteration
    behind)."""
    r: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    p: torch.Tensor
    s: torch.Tensor
    q: torch.Tensor
    z: torch.Tensor
    gamma_prev: torch.Tensor
    alpha_prev: torch.Tensor
    rr: torch.Tensor
    brk: torch.Tensor


@register_solver("CG")
class CGSolver(Solver):
    """Plain conjugate gradient (reference ``cg_solver.cu``) in the
    reduction layout of ``krylov_comm`` (or ``forced_comm``)."""

    use_preconditioner = False
    forced_comm: Optional[str] = None

    def solver_setup(self):
        if self.use_preconditioner:
            self._setup_preconditioner(True)

    def _M(self, r):
        return r

    def _comm_mode(self) -> str:
        mode = self.forced_comm or self.krylov_comm
        if mode != "CLASSIC" and self.norm_type == blas.NORM_LMAX:
            # a max cannot ride the stacked sum
            return "CLASSIC"
        return mode

    def _fused_scalars(self, r, u, w):
        """gamma = (r,u), delta = (w,u) and the monitor norm's
        accumulators of r, from one stacked reduction; f32 operands are
        widened first, so the products are exact and the sums f64,
        rounded once."""
        rw, uw, ww = ordered.widen(r), ordered.widen(u), ordered.widen(w)
        terms = [rw.conj() * uw, ww.conj() * uw]
        terms += blas.norm_terms(rw, self.norm_type, self.Ad.block_dim,
                                 self.use_scalar_norm)
        acc = blas.fused_reduce(terms).to(r.dtype)
        return acc[0], acc[1], acc[2:].real

    def solve_init(self, b, x):
        mode = self._comm_mode()
        r = b - spmv(self.Ad, x)
        if mode == "CLASSIC":
            z = self._M(r)
            return _CGState(r=r, p=z, rz=ordered.wdot(r, z))
        u = self._M(r)
        w = spmv(self.Ad, u)
        gamma, delta, rr = self._fused_scalars(r, u, w)
        one = torch.ones((), dtype=gamma.dtype, device=r.device)
        zero_v = torch.zeros_like(r)
        brk = _no_breakdown(r.device)
        if mode == "CA":
            return _CACGState(r=r, u=u, w=w, p=zero_v, s=zero_v,
                              gamma=gamma, gamma_prev=one, delta=delta,
                              alpha_prev=one, rr=rr, brk=brk)
        return _PipeCGState(r=r, u=u, w=w, p=zero_v, s=zero_v, q=zero_v,
                            z=zero_v, gamma_prev=one, alpha_prev=one,
                            rr=rr, brk=brk)

    def solve_iteration(self, b, x, st, iter_idx: int):
        if isinstance(st, _CACGState):
            return self._ca_iteration(b, x, st, iter_idx)
        if isinstance(st, _PipeCGState):
            return self._pipe_iteration(b, x, st, iter_idx)
        q = spmv(self.Ad, st.p)
        alpha = _guarded_div(st.rz, ordered.wdot(st.p, q))
        x = x + alpha * st.p
        r = st.r - alpha * q
        z = self._M(r)
        rz_new = ordered.wdot(r, z)
        beta = _guarded_div(rz_new, st.rz)
        return x, _CGState(r=r, p=z + beta * st.p, rz=rz_new)

    def _replace_now(self, iter_idx: int) -> bool:
        rep = self.ca_residual_replace
        return rep > 0 and iter_idx > 0 and iter_idx % rep == 0

    @staticmethod
    def _cg_scalar_step(gamma, gamma_prev, delta, alpha_prev, brk,
                        iter_idx: int):
        """The shared CA/pipelined recurrence: β = γ/γ_prev (0 at the
        first iteration), pAp = δ − β·γ/α_prev, α = γ/pAp, with the
        classic loop's breakdown guards (γ_prev == 0 flagged first)."""
        if iter_idx == 0:
            beta = torch.zeros_like(gamma)
        else:
            beta = gamma / torch.where(gamma_prev == 0, 1.0, gamma_prev)
            brk = torch.where((brk == 0) & (gamma_prev == 0),
                              torch.full_like(brk, BREAKDOWN_KRYLOV), brk)
        pap = delta - beta * gamma \
            / torch.where(alpha_prev == 0, 1.0, alpha_prev)
        brk = _cg_breakdown(brk, gamma, pap)
        return beta, _guarded_div(gamma, pap), brk

    def _ca_iteration(self, b, x, st: _CACGState, iter_idx: int):
        r, u, w, s = st.r, st.u, st.w, st.s
        gamma, delta, rr = st.gamma, st.delta, st.rr
        if self._replace_now(iter_idx):
            # true-residual replacement flushes the recurrence drift
            r = b - spmv(self.Ad, x)
            u = self._M(r)
            w = spmv(self.Ad, u)
            s = spmv(self.Ad, st.p)
            gamma, delta, rr = self._fused_scalars(r, u, w)
        beta, alpha, brk = self._cg_scalar_step(
            gamma, st.gamma_prev, delta, st.alpha_prev, st.brk, iter_idx)
        p = u + beta * st.p
        s = w + beta * s            # s = A p by linearity
        x = x + alpha * p
        r = r - alpha * s
        u = self._M(r)
        w = spmv(self.Ad, u)
        gamma_new, delta_new, rr_new = self._fused_scalars(r, u, w)
        return x, _CACGState(r=r, u=u, w=w, p=p, s=s, gamma=gamma_new,
                             gamma_prev=gamma, delta=delta_new,
                             alpha_prev=alpha, rr=rr_new, brk=brk)

    def _pipe_iteration(self, b, x, st: _PipeCGState, iter_idx: int):
        r, u, w, s, q, z = st.r, st.u, st.w, st.s, st.q, st.z
        if self._replace_now(iter_idx):
            r = b - spmv(self.Ad, x)
            u = self._M(r)
            w = spmv(self.Ad, u)
            s = spmv(self.Ad, st.p)
            q = self._M(s)
            z = spmv(self.Ad, q)
        gamma, delta, rr_new = self._fused_scalars(r, u, w)
        m_vec = self._M(w)
        n_vec = spmv(self.Ad, m_vec)
        beta, alpha, brk = self._cg_scalar_step(
            gamma, st.gamma_prev, delta, st.alpha_prev, st.brk, iter_idx)
        z = n_vec + beta * z        # z = A q
        q = m_vec + beta * q        # q = M s
        s = w + beta * s            # s = A p
        p = u + beta * st.p
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        return x, _PipeCGState(r=r, u=u, w=w, p=p, s=s, q=q, z=z,
                               gamma_prev=gamma, alpha_prev=alpha,
                               rr=rr_new, brk=brk)

    def residual_norm_estimate(self, b, x, st):
        if isinstance(st, (_CACGState, _PipeCGState)):
            # the stacked reduction carried the norm's accumulators
            return blas.finish_norm(st.rr, self.norm_type, st.r.shape[0],
                                    self.Ad.block_dim, self.use_scalar_norm)
        return self.norm(ordered.widen(st.r)).to(st.r.dtype)


@dataclasses.dataclass
class _GMRESState:
    V: torch.Tensor        # (m+1, n) Krylov basis (device, in place)
    Z: Optional[torch.Tensor]  # (m, n) preconditioned basis (FGMRES only)
    R: np.ndarray          # (m+1, m) triangularised Hessenberg (host)
    g: np.ndarray          # (m+1,) least-squares right-hand side (host)
    cs: np.ndarray         # (m,) Givens cosines (host)
    sn: np.ndarray         # (m,) Givens sines (host)
    x_base: torch.Tensor   # x at cycle start
    quasi_res: np.ndarray  # (1,) |g[j+1]|
    j: int                 # last completed column of the cycle
    beta: Optional[torch.Tensor]  # ‖r‖ awaiting the next fetch into g[0]


class _GMRESBase(Solver):
    #: keep the preconditioned basis Z (FGMRES), else rebuild x from V
    flexible = False

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.restart = int(cfg.get("gmres_n_restart", scope))
        krylov_dim = int(cfg.get("gmres_krylov_dim", scope))
        if krylov_dim > 0:
            self.restart = min(self.restart, krylov_dim)

    def solver_setup(self):
        self._setup_preconditioner(True)

    def solve_init(self, b, x):
        m, n = self.restart, b.shape[0]
        r = b - spmv(self.Ad, x)
        beta = ordered.wnrm2(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = _normalized(r, beta)
        Z = torch.zeros((m, n), dtype=b.dtype, device=b.device) \
            if self.flexible else None
        ndt = numpy_dtype(b.dtype)
        return _GMRESState(
            V=V, Z=Z, R=np.zeros((m + 1, m), ndt), g=np.zeros(m + 1, ndt),
            cs=np.zeros(m, ndt), sn=np.zeros(m, ndt), x_base=x,
            quasi_res=np.zeros(1, ndt), j=-1, beta=beta)

    def _solve_ls_and_update(self, st: _GMRESState, j: int):
        """x = x_base + Z[:j+1]ᵀ·y (FGMRES) or x_base + M·(V[:j+1]ᵀ·y)
        (GMRES) where R[:j+1, :j+1]·y = g[:j+1]; x_base itself when y is
        0 (no column yet, or right after a cycle end)."""
        if j < 0:
            return st.x_base
        y = scipy.linalg.solve_triangular(st.R[:j + 1, :j + 1],
                                          st.g[:j + 1], lower=False)
        if not np.any(y):
            return st.x_base
        y = torch.from_numpy(np.ascontiguousarray(y, st.g.dtype)).to(
            st.V.device)
        if self.flexible:
            return st.x_base + ordered.lincomb(st.Z[:j + 1], y)
        return st.x_base + self._apply_M(ordered.lincomb(st.V[:j + 1], y))

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
        if self.krylov_comm != "CLASSIC":
            # fused Arnoldi: the second pass and ‖w‖² share one stacked
            # product; ‖w − V·h2‖² = ‖w‖² − ‖h2‖² (h2 is O(ε)·‖w‖)
            h2, ww = ordered.wgram_dots_with_norm(Vj, w)
            w = w - ordered.lincomb(Vj, h2)
            h_next = torch.sqrt(torch.clamp(ww - ordered.wdot(h2, h2),
                                            min=0.0))
        else:
            h2 = ordered.wgram_dots(Vj, w)
            w = w - ordered.lincomb(Vj, h2)
            h_next = ordered.wnrm2(w)
        st.V[j + 1] = _normalized(w, h_next)
        if self.flexible:
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


@register_solver("PCG_CA")
class PCGCASolver(PCGSolver):
    """Single-reduction (Chronopoulos–Gear) PCG: ``PCG`` with
    ``krylov_comm=CA`` baked in."""

    forced_comm = "CA"


@register_solver("PCG_PIPE")
class PCGPipeSolver(PCGSolver):
    """Pipelined (Ghysels–Vanroose) PCG: ``PCG`` with
    ``krylov_comm=PIPELINED`` baked in."""

    forced_comm = "PIPELINED"


@dataclasses.dataclass
class _PCGFState:
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    brk: torch.Tensor


@register_solver("PCGF")
class PCGFSolver(_PrecondMixin, Solver):
    """Flexible PCG (reference ``pcgf_solver.cu``): the Polak–Ribière β
    ⟨z_new, r_new − r_old⟩/⟨z_old, r_old⟩ tolerates a preconditioner
    that changes between iterations.  Its inner products sum an f32
    pair in f64 (``ordered.wdot``)."""

    def solver_setup(self):
        self._setup_preconditioner(True)

    def solve_init(self, b, x):
        r = b - spmv(self.Ad, x)
        z = self._apply_M(r)
        return _PCGFState(r=r, z=z, p=z, rz=_wdot(r, z),
                          brk=_no_breakdown(r.device))

    def solve_iteration(self, b, x, st: _PCGFState, iter_idx: int):
        q = spmv(self.Ad, st.p)
        pq = _wdot(st.p, q)
        brk = _cg_breakdown(st.brk, st.rz, pq)
        alpha = _guarded_div(st.rz, pq)
        x = x + alpha * st.p
        r_new = st.r - alpha * q
        z_new = self._apply_M(r_new)
        rz_new = _wdot(r_new, z_new)
        beta = _guarded_div(rz_new - _wdot(st.r, z_new), st.rz)
        return x, _PCGFState(r=r_new, z=z_new, p=z_new + beta * st.p,
                             rz=rz_new, brk=brk)

    def residual_norm_estimate(self, b, x, st: _PCGFState):
        return self.norm(st.r)


@register_solver("GMRES")
class GMRESSolver(_PrecondMixin, _GMRESBase):
    """Restarted right-preconditioned GMRES (reference
    ``gmres_solver.cu``)."""


@register_solver("FGMRES")
class FGMRESSolver(_PrecondMixin, _GMRESBase):
    """Flexible GMRES: stores the preconditioned vectors Z so the
    preconditioner (an AMG cycle) may change every iteration."""

    flexible = True


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
