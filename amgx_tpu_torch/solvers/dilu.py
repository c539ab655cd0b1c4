"""Multicolor DILU smoother (port of ``amgx_tpu/solvers/dilu.py``:
the scalar and b×b factorisations, the device block factorisation and
the per-color slab sweeps; the distributed slabs are a later slice).

Reference: ``core/src/solvers/multicolor_dilu_solver.cu``.  DILU
preconditioner M = (E + L)·E⁻¹·(E + U), where L/U are the strict
lower/upper parts in color order and E is the diagonal chosen so that
diag(M) = diag(A):

    E_i = a_ii − Σ_{j ∈ N(i), rank(color_j) < rank(color_i)}
              a_ij · E_j⁻¹ · a_ji

Setup computes E color by color (rows of one color are independent);
b×b systems at or above 8192 block rows run the numeric sweep on the
matrix's device.  The JAX package computes that sweep in f32 on a TPU
and in ``promote(data, f32)`` elsewhere; the port uses the second rule
on every device, so on the card an f64 upload factors in f64.  A failed
device factorisation raises (the JAX package logs it and falls back to
the host loop).

The device sweep and the solve's sweeps add every sum in a fixed order
with elementwise ops (no batched product, reduction or scatter-add,
whose order the device picks): BiCGStab's f32 iteration count follows
the last bit of the preconditioner, and this way the card reproduces
the CPU's count and its own, run after run.

The solve is two color-ordered sweeps over per-color row slabs:

    forward  (E+L) y = r :  y_c = E_c⁻¹ (r − L·y)_c
    backward (E+U) z = E·y: z_c = y_c − E_c⁻¹ (U·z)_c

Rows within a color are unique, so the indexed writes are deterministic
on any device.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..coloring import color_matrix
from ..device import torch_dtype
from ..errors import BadConfigurationError
from ..ops.spmv import spmv
from .base import Solver, register_solver
from .gs import build_color_slabs, build_color_slabs_block
from .jacobi import apply_dinv


def _transpose_aligned_values(csr: sp.csr_matrix) -> np.ndarray:
    """For each stored entry (i,j) return a_ji (0 when (j,i) not stored)."""
    n = csr.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr))
    keys = rows * n + csr.indices
    tkeys = csr.indices.astype(np.int64) * n + rows
    pos = np.searchsorted(keys, tkeys)
    pos_c = np.minimum(pos, len(keys) - 1)
    hit = (pos < len(keys)) & (keys[pos_c] == tkeys)
    out = np.zeros(len(keys), dtype=csr.data.dtype)
    out[hit] = csr.data[pos_c[hit]]
    return out


def _scalar_dilu_factor(csr: sp.csr_matrix, colors: np.ndarray):
    """Scalar DILU factorisation on one matrix: returns (L, U, 1/E) with
    L/U the strict lower/upper parts in color-rank order."""
    csr = sp.csr_matrix(csr)
    csr.sort_indices()
    n = csr.shape[0]
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    cr_i = colors[rows]
    cr_j = colors[csr.indices]
    lower = cr_j < cr_i
    upper = cr_j > cr_i
    a_ji = _transpose_aligned_values(csr)
    diag = csr.diagonal().astype(np.float64)
    E = np.zeros(n, dtype=np.float64)
    Einv = np.zeros(n, dtype=np.float64)
    num_colors = int(colors.max()) + 1 if n else 1
    for c in range(num_colors):
        rc = colors == c
        contrib = np.zeros(n, dtype=np.float64)
        mask = lower & rc[rows]
        np.add.at(contrib, rows[mask],
                  csr.data[mask] * Einv[csr.indices[mask]] * a_ji[mask])
        E[rc] = diag[rc] - contrib[rc]
        bad = rc & (E == 0)
        E[bad] = 1.0
        Einv[rc] = 1.0 / E[rc]
    L = sp.csr_matrix((np.where(lower, csr.data, 0.0),
                       csr.indices.copy(), csr.indptr.copy()),
                      shape=csr.shape)
    L.eliminate_zeros()
    U = sp.csr_matrix((np.where(upper, csr.data, 0.0),
                       csr.indices.copy(), csr.indptr.copy()),
                      shape=csr.shape)
    U.eliminate_zeros()
    return L, U, Einv


def _guarded_batch_inv(E: np.ndarray, bd: int) -> np.ndarray:
    """Batched (nc, b, b) inverse with the singular-block rule shared by
    the host and device factorisations: normalise each block by its max
    entry, and blocks with zero scale or ``|det| < b·eps`` of the compute
    dtype take E⁻¹ = I."""
    eps = float(np.finfo(E.dtype).eps)
    scale = np.max(np.abs(E), axis=(-2, -1))
    nz = scale > 0
    En = E / np.where(nz, scale, 1.0)[:, None, None]
    eye = np.eye(bd, dtype=E.dtype)
    En = np.where(nz[:, None, None], En, eye)
    bad = ~nz | (np.abs(np.linalg.det(En)) < bd * eps)
    inv = np.linalg.inv(np.where(bad[:, None, None], eye, En))
    return np.where(bad[:, None, None], eye,
                    inv / np.where(nz, scale, 1.0)[:, None, None])


def _block_structure(bsr: sp.bsr_matrix, colors: np.ndarray, bd: int):
    """Host index work of a block factorisation: (n, rows, cols, lower,
    upper, pos_c, hit) — the color masks and the transpose alignment
    (``pos_c[e]`` is the stored position of block (j, i) for entry
    (i, j), valid where ``hit``)."""
    n = bsr.shape[0] // bd
    rows = np.repeat(np.arange(n), np.diff(bsr.indptr))
    cols_ = bsr.indices
    lower = colors[cols_] < colors[rows]
    upper = colors[cols_] > colors[rows]
    keys = rows.astype(np.int64) * n + cols_
    tkeys = cols_.astype(np.int64) * n + rows
    pos = np.searchsorted(keys, tkeys)
    pos_c = np.minimum(pos, len(keys) - 1)
    hit = (pos < len(keys)) & (keys[pos_c] == tkeys)
    return n, rows, cols_, lower, upper, pos_c, hit


def _lower_upper(bsr, cols_, lower, upper):
    Lb = sp.bsr_matrix((np.where(lower[:, None, None], bsr.data, 0.0),
                        cols_.copy(), bsr.indptr.copy()),
                       shape=bsr.shape)
    Ub = sp.bsr_matrix((np.where(upper[:, None, None], bsr.data, 0.0),
                        cols_.copy(), bsr.indptr.copy()),
                       shape=bsr.shape)
    return Lb, Ub


def _block_dilu_factor(bsr: sp.bsr_matrix, colors: np.ndarray, bd: int):
    """Block DILU factorisation on the host (the b×b path of
    ``multicolor_dilu_solver.cu:48-112``): returns (Lb, Ub, Einv) with
    L/U the strict lower/upper block parts in color-rank order and
    (n, b, b) inverted E blocks."""
    bsr = bsr.copy()
    bsr.sort_indices()
    n, rows, cols_, lower, upper, pos_c, hit = \
        _block_structure(bsr, colors, bd)
    Bt = np.zeros_like(bsr.data)
    Bt[hit] = bsr.data[pos_c[hit]]
    diagblocks = np.zeros((n, bd, bd))
    on_diag = cols_ == rows
    diagblocks[rows[on_diag]] = bsr.data[on_diag]
    E = np.zeros((n, bd, bd))
    Einv = np.zeros((n, bd, bd))
    num_colors = int(colors.max()) + 1 if n else 1
    for c in range(num_colors):
        rc = colors == c
        contrib = np.zeros((n, bd, bd))
        mask = lower & rc[rows]
        if mask.any():
            prod = np.einsum("eab,ebc,ecd->ead", bsr.data[mask],
                             Einv[cols_[mask]], Bt[mask])
            np.add.at(contrib, rows[mask], prod)
        E[rc] = diagblocks[rc] - contrib[rc]
        Einv[rc] = _guarded_batch_inv(E[rc], bd)
    Lb, Ub = _lower_upper(bsr, cols_, lower, upper)
    return Lb, Ub, Einv


#: block rows from which the numeric sweep runs on the device
#: (``_DILU_DEVICE_MIN_ROWS`` upstream)
_DILU_DEVICE_MIN_ROWS = 8192


def _block_dilu_factor_device(bsr: sp.bsr_matrix, colors: np.ndarray,
                              bd: int, device, compute_dtype=None):
    """Block DILU factorisation with the numeric per-color sweep on
    ``device``: for each color the b×b triple products ``A_ij·E_j⁻¹·A_ji``
    of its rows' lower entries, summed per row, and the E-block inverses
    under the singular rule of :func:`_guarded_batch_inv` (relative to
    the compute dtype).  Index classification stays host integer work.

    Every sum is spelled out as elementwise ops in a fixed order — the
    b-term products of :func:`_bmm`, each row's entries in stored order,
    the Gauss–Jordan inverse of :func:`_guarded_inv` — where the JAX
    package's batched einsum, scatter-add and inverse order (and on the
    card, atomically add) their sums as the device pleases: so the card
    reproduces the CPU bit for bit and itself from run to run.

    Returns ``(Lb, Ub, Einv)``; ``Einv`` is a tensor on ``device`` in
    ``compute_dtype`` (default ``promote(data, f32)``)."""
    bsr = bsr.copy()
    bsr.sort_indices()
    n, rows, cols_, lower, upper, pos_c, hit = \
        _block_structure(bsr, colors, bd)
    cdt = torch_dtype(np.promote_types(bsr.data.dtype, np.float32)
                      if compute_dtype is None else compute_dtype)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    data = up(bsr.data).to(cdt)
    Bt = torch.where(up(hit)[:, None, None], data[up(pos_c)],
                     torch.zeros((), dtype=cdt, device=data.device))
    on_diag = cols_ == rows
    db = torch.zeros((n, bd, bd), dtype=cdt, device=data.device)
    db[up(rows[on_diag])] = data[up(np.flatnonzero(on_diag))]
    Einv = torch.zeros((n, bd, bd), dtype=cdt, device=data.device)
    num_colors = int(colors.max()) + 1 if n else 1
    for c in range(num_colors):
        rc_idx = np.flatnonzero(colors == c)
        if rc_idx.size == 0:
            continue
        rc_t = up(rc_idx)
        me = np.flatnonzero(lower & (colors[rows] == c))
        Ec = db[rc_t]
        if me.size:
            me_t = up(me)
            prod = _bmm(_bmm(data[me_t], Einv[up(cols_[me])]), Bt[me_t])
            # the color's rows × their most lower entries, in stored
            # order, padded with zero blocks (x + 0 = x exactly)
            slot = np.searchsorted(rc_idx, rows[me])
            deg = np.bincount(slot, minlength=rc_idx.size)
            k = np.arange(me.size) - np.repeat(np.cumsum(deg) - deg, deg)
            pad = torch.zeros((rc_idx.size, int(deg.max()), bd, bd),
                              dtype=cdt, device=data.device)
            pad[up(slot), up(k)] = prod
            contrib = pad[:, 0]
            for j in range(1, pad.shape[1]):
                contrib = contrib + pad[:, j]
            Ec = Ec - contrib
        Einv[rc_t] = _guarded_inv(Ec)
    Lb, Ub = _lower_upper(bsr, cols_, lower, upper)
    return Lb, Ub, Einv


def _bmm(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Batched (m, b, b) product, each entry's b products added left to
    right as elementwise ops."""
    p = X[:, :, :, None] * Y[:, None, :, :]           # (m, a, k, c)
    out = p[:, :, 0]
    for j in range(1, p.shape[2]):
        out = out + p[:, :, j]
    return out


def _guarded_inv(E: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_guarded_batch_inv` on (m, b, b) tensors:
    each block normalised by its largest entry and inverted by
    Gauss–Jordan elimination with partial pivoting (the first largest
    pivot candidate wins), as elementwise ops; blocks with zero scale or
    ``|det| < b·eps`` take E⁻¹ = I."""
    m, bd = E.shape[0], E.shape[-1]
    eps = float(torch.finfo(E.dtype).eps)
    eye = torch.eye(bd, dtype=E.dtype, device=E.device)
    scale = torch.amax(torch.abs(E), dim=(-2, -1))
    nz = scale > 0
    sc = torch.where(nz, scale, torch.ones_like(scale))[:, None, None]
    M = torch.where(nz[:, None, None], E / sc, eye)
    inv = eye.expand(m, bd, bd).clone()
    det = torch.ones(m, dtype=E.dtype, device=E.device)
    ar = torch.arange(m, device=E.device)
    for c in range(bd):
        piv = c + torch.argmax(torch.abs(M[:, c:, c]), dim=1)
        swap = piv != c
        det = torch.where(swap, -det, det)
        for T in (M, inv):
            top, other = T[:, c].clone(), T[ar, piv].clone()
            T[ar, piv] = top
            T[:, c] = other
        p = M[:, c, c].clone()
        det = det * p
        safe = torch.where(p != 0, p, torch.ones_like(p))[:, None]
        M[:, c] = M[:, c] / safe
        inv[:, c] = inv[:, c] / safe
        for r in range(bd):
            if r != c:
                f = M[:, r, c].clone()[:, None]
                M[:, r] = M[:, r] - f * M[:, c]
                inv[:, r] = inv[:, r] - f * inv[:, c]
    bad = ~nz | (torch.abs(det) < bd * eps)
    return torch.where(bad[:, None, None], eye, inv / sc)


def _slab_times(vals: torch.Tensor, yg: torch.Tensor) -> torch.Tensor:
    """A slab's rows times the gathered vector: Σ_k vals[:, k]·yg[:, k]
    for a scalar (nc, K) slab, or Σ_k Σ_c vals[:, k, :, c]·yg[:, k, c]
    for a block (nc, K, b, b) slab.  The products are added left to
    right, one elementwise op at a time: a batched product or a reduction
    orders its sums its own way on each device, and the card's f32
    sweeps would then round otherwise than the CPU's."""
    if vals.dim() == 2:
        p = vals * yg
        terms = [p[:, k] for k in range(p.shape[1])]
    else:
        p = vals * yg[:, :, None, :]
        terms = [p[:, k, :, c] for k in range(p.shape[1])
                 for c in range(p.shape[3])]
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


@register_solver("MULTICOLOR_DILU")
class MulticolorDILUSolver(Solver):
    is_smoother = True

    def solver_setup(self):
        if self.A is None:
            raise BadConfigurationError(
                "MULTICOLOR_DILU setup requires the host matrix")
        coloring = color_matrix(self.A, self.cfg, self.scope)
        colors = coloring.colors
        self.num_colors = coloring.num_colors
        b = self.A.block_dim
        dev, dt = self.Ad.device, self.Ad.dtype
        if b == 1:
            csr = self.A.scalar_csr()
            csr.sort_indices()
            L, U, Einv = _scalar_dilu_factor(csr, colors)
            self.set_state(
                torch.from_numpy(Einv).to(dev, dt),
                build_color_slabs(L, colors, self.num_colors, dt, dev),
                build_color_slabs(U, colors, self.num_colors, dt, dev))
            return
        bsr = self.A.host if isinstance(self.A.host, sp.bsr_matrix) else \
            sp.bsr_matrix(self.A.host, blocksize=(b, b))
        if bsr.shape[0] // b >= _DILU_DEVICE_MIN_ROWS:
            Lb, Ub, Einv = _block_dilu_factor_device(bsr, colors, b, dev)
            Einv = Einv.to(dt)
        else:
            Lb, Ub, Einv = _block_dilu_factor(bsr, colors, b)
            Einv = torch.from_numpy(Einv).to(dev, dt)
        self.num_colors = int(colors.max()) + 1
        self.set_state(
            Einv,
            build_color_slabs_block(Lb, colors, self.num_colors, dt, b, dev),
            build_color_slabs_block(Ub, colors, self.num_colors, dt, b, dev))

    def set_state(self, Einv: torch.Tensor, L_slabs, U_slabs):
        """Install E⁻¹ ((n,) or (n, b, b)) and the per-color slabs.  Each
        slab's E⁻¹ rows are gathered once here (``einv``), so a sweep
        gathers only the vectors."""
        self.Einv = Einv
        self.L_slabs, self.U_slabs = L_slabs, U_slabs
        for s in L_slabs + U_slabs:
            s.einv = Einv[s.rows]
        self.num_colors = len(L_slabs)
        self.block = Einv.dim() == 3
        self.block_dim = int(Einv.shape[-1]) if self.block else 1

    def _apply_dilu(self, r: torch.Tensor) -> torch.Tensor:
        """z = M⁻¹ r via the two color-ordered sweeps over the slabs."""
        bd = self.block_dim
        if not self.block:
            y = torch.zeros_like(r)
            for s in self.L_slabs:
                t = _slab_times(s.vals, y[s.cols])
                y[s.rows] = s.einv * (r[s.rows] - t)
            z = y.clone()
            for s in reversed(self.U_slabs):
                t = _slab_times(s.vals, z[s.cols])
                z[s.rows] = y[s.rows] - s.einv * t
            return z
        rb = r.reshape(-1, bd)
        y = torch.zeros_like(rb)
        for s in self.L_slabs:
            t = _slab_times(s.vals, y[s.cols])
            y[s.rows] = apply_dinv(s.einv, rb[s.rows] - t).reshape(-1, bd)
        z = y.clone()
        for s in reversed(self.U_slabs):
            t = _slab_times(s.vals, z[s.cols])
            z[s.rows] = y[s.rows] - apply_dinv(s.einv, t).reshape(-1, bd)
        return z.reshape(-1)

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + self.relaxation_factor * self._apply_dilu(r), state
