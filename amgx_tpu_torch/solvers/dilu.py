"""Multicolor DILU smoother (port of ``amgx_tpu/solvers/dilu.py``:
the scalar and b×b factorisations, the device block factorisation, the
per-color slab sweeps and the distributed slabs).

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

On a sharded pack (``_setup_dist_slabs`` upstream) each rank factors its
local block alone (scalar or b×b; the cross-rank couplings relax through
the outer residual, as the reference's distributed smoother does,
``multicolor_dilu_solver.cu:4167-4209``) and every rank's slabs of a
color join one slab over the flat padded vector, rows and columns
rebased to p·n_loc + l: the sweeps are the single-device sweeps, and
they make no halo exchange at all.  Padding rows belong to no color, so
M⁻¹r is 0 there.  MULTICOLOR_ILU refuses a sharded pack, as upstream
(``solvers/ilu.py``).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..coloring import color_matrix
from ..device import torch_dtype
from ..errors import BadConfigurationError
from ..ops import ordered
from ..ops.ordered import guarded_block_inv
from ..ops.spmv import spmv
from .base import Solver, register_solver
from .gs import (ColorSlab, build_color_slabs, build_color_slabs_block,
                 host_bsr, slab_times)
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
    the Gauss–Jordan inverse of
    :func:`~..ops.ordered.guarded_block_inv` — where the JAX
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
        Einv[rc_t] = guarded_block_inv(Ec)
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


def _local_bsr(blk: sp.bsr_matrix, lo: int, hi: int, b: int
               ) -> sp.bsr_matrix:
    """Rank block ``blk`` (b×b, global block columns) restricted to its
    local block columns [lo, hi), renumbered from 0."""
    blk = sp.bsr_matrix(blk, blocksize=(b, b))
    blk.sort_indices()
    deg = np.diff(blk.indptr)
    rows = np.repeat(np.arange(hi - lo), deg)
    keep = (blk.indices >= lo) & (blk.indices < hi)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        rows[keep], minlength=hi - lo))])
    return sp.bsr_matrix((blk.data[keep], blk.indices[keep] - lo, indptr),
                         shape=((hi - lo) * b, (hi - lo) * b),
                         blocksize=(b, b))


def _joined_slab(per_rank, c: int, n_loc: int, dev) -> ColorSlab:
    """Color ``c``'s slabs of every rank as one slab of the flat padded
    vector: rows and columns rebased to p·n_loc + l, every rank's rows
    padded to the widest (column 0, value 0)."""
    K = max(int(s[c].cols.shape[1]) for s in per_rank)
    rows, cols, vals = [], [], []
    for p, slabs in enumerate(per_rank):
        sc = slabs[c]
        k = int(sc.cols.shape[1])
        base = p * n_loc
        rows.append(sc.rows.long() + base)
        cc = torch.zeros((sc.cols.shape[0], K), dtype=torch.int64)
        cc[:, :k] = sc.cols.long() + base
        cols.append(cc)
        vv = sc.vals.new_zeros((sc.vals.shape[0], K) + sc.vals.shape[2:])
        vv[:, :k] = sc.vals
        vals.append(vv)
    return ColorSlab(torch.cat(rows).to(dev), torch.cat(cols).to(dev),
                     torch.cat(vals).to(dev))


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
        if self.Ad.fmt == "sharded-ell":
            self._setup_dist_slabs(colors)
            return
        if b == 1:
            csr = self.A.scalar_csr()
            csr.sort_indices()
            L, U, Einv = _scalar_dilu_factor(csr, colors)
            self.set_state(
                torch.from_numpy(Einv).to(dev, dt),
                build_color_slabs(L, colors, self.num_colors, dt, dev),
                build_color_slabs(U, colors, self.num_colors, dt, dev))
            return
        bsr = host_bsr(self.A, b)
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

    def _setup_dist_slabs(self, colors: np.ndarray):
        """Distributed DILU (``_setup_dist_slabs`` and
        ``_setup_dist_slabs_block`` upstream): each rank's local block
        factored alone (a b×b block at or above 8192 block rows by the
        device factorisation, as on one device), its slabs built, and
        each color's slabs of every rank joined into one slab over the
        flat padded vector."""
        Ad = self.Ad
        offs = np.asarray(Ad.offsets)
        P, n_loc, b = Ad.n_parts, Ad.n_loc, Ad.block_dim
        dev, dt = Ad.device, Ad.dtype
        host = torch.device("cpu")
        per_L, per_U, einv = [], [], []
        for p, blk in enumerate(self.A.rank_blocks()):
            lo, hi = int(offs[p]), int(offs[p + 1])
            cp = colors[lo:hi]
            if b == 1:
                sub = sp.csr_matrix(sp.csr_matrix(blk)[:, lo:hi])
                Lp, Up, Ep = _scalar_dilu_factor(sub, cp)
                Ep = torch.from_numpy(Ep).to(dev, dt)
                pad = torch.ones(n_loc - (hi - lo), dtype=dt, device=dev)
                per_L.append(build_color_slabs(Lp, cp, self.num_colors, dt,
                                               host))
                per_U.append(build_color_slabs(Up, cp, self.num_colors, dt,
                                               host))
            else:
                sub = _local_bsr(blk, lo, hi, b)
                if hi - lo >= _DILU_DEVICE_MIN_ROWS:
                    Lp, Up, Ep = _block_dilu_factor_device(sub, cp, b, dev)
                    Ep = Ep.to(dt)
                else:
                    Lp, Up, Ep = _block_dilu_factor(sub, cp, b)
                    Ep = torch.from_numpy(Ep).to(dev, dt)
                pad = torch.eye(b, dtype=dt, device=dev).expand(
                    n_loc - (hi - lo), b, b)
                per_L.append(build_color_slabs_block(
                    Lp, cp, self.num_colors, dt, b, host))
                per_U.append(build_color_slabs_block(
                    Up, cp, self.num_colors, dt, b, host))
            einv += [Ep, pad]
        self.set_state(
            torch.cat(einv),
            [_joined_slab(per_L, c, n_loc, dev)
             for c in range(self.num_colors)],
            [_joined_slab(per_U, c, n_loc, dev)
             for c in range(self.num_colors)])

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
                t = slab_times(s.vals, y[s.cols])
                y[s.rows] = ordered.mul(s.einv, r[s.rows] - t)
            z = y.clone()
            for s in reversed(self.U_slabs):
                t = slab_times(s.vals, z[s.cols])
                z[s.rows] = y[s.rows] - ordered.mul(s.einv, t)
            return z
        rb = r.reshape(-1, bd)
        y = torch.zeros_like(rb)
        for s in self.L_slabs:
            t = slab_times(s.vals, y[s.cols])
            y[s.rows] = apply_dinv(s.einv, rb[s.rows] - t).reshape(-1, bd)
        z = y.clone()
        for s in reversed(self.U_slabs):
            t = slab_times(s.vals, z[s.cols])
            z[s.rows] = y[s.rows] - apply_dinv(s.einv, t).reshape(-1, bd)
        return z.reshape(-1)

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + self.relaxation_factor * self._apply_dilu(r), state
