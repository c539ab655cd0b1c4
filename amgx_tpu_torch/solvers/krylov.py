"""Flexible GMRES (port of ``_PrecondMixin``, ``_GMRESBase`` and
``FGMRESSolver`` of ``amgx_tpu/solvers/krylov.py``; reference
``core/src/solvers/fgmres_solver.cu``).

Orthogonalisation is two-pass classical Gram–Schmidt (CGS2, the CLASSIC
reduction layout): two matrix-vector products against the live basis
rows per Arnoldi step.  The restart position ``j = iter % m`` is a host
int, so the basis slices are exact and no masks are needed.

Each iteration fetches ONE small array from the device: the new
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
from ..errors import NotImplementedError_
from ..ops import blas
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
        if str(cfg.get("krylov_comm", scope)) != "CLASSIC":
            raise NotImplementedError_(
                "krylov_comm CA/PIPELINED (the fused Arnoldi pass) is a "
                "later slice of the port")

    def solver_setup(self):
        self._setup_preconditioner(True)

    def solve_init(self, b, x):
        m, n = self.restart, b.shape[0]
        r = b - spmv(self.Ad, x)
        beta = blas.nrm2(r)
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
        return st.x_base + torch.mv(st.Z[:j + 1].T, y)

    def solve_iteration(self, b, x, st: _GMRESState, iter_idx: int):
        m = self.restart
        j = iter_idx % m
        if j == 0 and iter_idx > 0:
            # restart: the true residual seeds a fresh basis
            r = b - spmv(self.Ad, x)
            st.beta = blas.nrm2(r)
            st.V[0] = _normalized(r, st.beta)
            st.x_base = x
            st.g[:] = 0
            st.cs[:] = 0
            st.sn[:] = 0

        # Arnoldi step with CGS2 against the live rows 0..j
        z_j = self._apply_M(st.V[j])
        w = spmv(self.Ad, z_j)
        Vj = st.V[:j + 1]
        h1 = blas.gram_dots(Vj, w)
        w = w - torch.mv(Vj.T, h1)
        h2 = blas.gram_dots(Vj, w)
        w = w - torch.mv(Vj.T, h2)
        h_next = blas.nrm2(w)
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
        if self.norm_type == "L2":
            return st.quasi_res
        return None

    def solve_finalize(self, b, x, st):
        # mid-cycle exit: fold the pending LS solution into x
        return self._solve_ls_and_update(st, st.j)


def _normalized(v: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """v / nrm, or zeros when nrm == 0 — without a host sync."""
    safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return torch.where(nrm > 0, v / safe, torch.zeros_like(v))


@register_solver("FGMRES")
class FGMRESSolver(_PrecondMixin, _GMRESBase):
    """Flexible GMRES: stores the preconditioned vectors Z so the
    preconditioner (an AMG cycle) may change every iteration."""
