"""Gauss–Seidel family and Kaczmarz smoothers, color-parallel, with the
per-color row slabs DILU and ILU share (port of ``amgx_tpu/solvers/gs.py``
for a single device; reference
``core/src/solvers/multicolor_gauss_seidel_solver.cu``,
``fixcolor_gauss_seidel_solver.cu``, ``gauss_seidel_solver.cu``,
``kaczmarz_solver.cu``; ``symmetric_GS``, ``GS_L1_variant``
core.cu:425-427).

Rows of one color are independent.  Each color's rows are gathered at
setup into a compact ELL slab (rows, padded columns, values), so a sweep
costs O(nnz) in all: the update of a color reads only that color's slab
and writes only that color's rows, like the reference's per-color kernels
(``multicolor_dilu_solver.cu``).  A smoother set up without a host matrix
colors every row alike and relaxes through masked full-width sweeps, as
the JAX package does.

On a sharded scalar pack (:mod:`..distributed`) the color slabs are
per-shard row selections of the pack, their columns rebased into one
flat extended vector ``[x (P·n_loc) | every shard's halo (P·H) | 0]``:
a sweep exchanges the halo once, at its start (the halo values stay
frozen, the local updates are seen), then relaxes color by color with
no further exchange (``_dist_color_sweep`` upstream,
``multicolor_dilu_solver.cu:4167-4209``).  A b×b sharded pack and
Kaczmarz keep the JAX package's masked sweeps with the distributed
SpMV; Kaczmarz projects through the true transpose, a sharded pack of
Aᵀ collected send-side from the row blocks (``_shard_transpose``).

Every sum of a sweep runs in one order on every device: a slab row's
products add left to right (:func:`slab_times`), and the writes go to
unique indices — Kaczmarz's projections too, whose columns are unique
within a color of the A·Aᵀ graph, so a plain indexed add replaces the
JAX package's scatter-add.  No setup value is fetched during a sweep, so
a sweep runs inside the AMG's CUDA graph.
"""
from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from ..coloring import color_matrix, create_coloring
from ..core.matrix import Matrix, ell_layout
from ..device import numpy_dtype, torch_dtype
from ..ops import ordered
from ..ops.spmv import spmv
from ..utils.logging import amgx_output
from .base import Solver, register_solver
from .jacobi import apply_dinv, setup_dinv


class ColorSlab:
    """One color's compact row slab: ELL rows with global column ids."""

    def __init__(self, rows, cols, vals):
        self.rows = rows        # (nc,) int32 — this color's (block) rows
        self.cols = cols        # (nc, K) int32
        self.vals = vals        # (nc, K[, b, b])
        #: (nc[, b, b]) the rows' diagonal inverse, set by the smoother
        self.einv = None


def _host_dtype(data: np.ndarray):
    """The host dtype of a slab built from ``data``: f64, or c128 for a
    complex matrix (the device dtype is applied on upload)."""
    return np.complex128 if np.iscomplexobj(data) else np.float64


def _wrap(device: torch.device, dtype):
    """numpy → tensors on ``device``, floating arrays cast to ``dtype``."""
    tdt = torch_dtype(dtype)

    def up(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, tdt if t.is_floating_point() or t.is_complex()
                    else None)
    return up


def build_color_slabs(csr, colors, num_colors, dtype,
                      device: torch.device) -> List[ColorSlab]:
    """Per-color packed ELL slabs from a scalar CSR matrix, padded with
    column 0 and value 0."""
    wrap = _wrap(device, dtype)
    slabs = []
    for c in range(num_colors):
        rows = np.where(colors == c)[0]
        sub = csr[rows]
        sub.sort_indices()
        for_rows, pos, k = ell_layout(sub.indptr, sub.indices)
        cols = np.zeros((len(rows), k), dtype=np.int32)
        vals = np.zeros((len(rows), k), dtype=_host_dtype(sub.data))
        cols[for_rows, pos] = sub.indices
        vals[for_rows, pos] = sub.data
        slabs.append(ColorSlab(wrap(rows.astype(np.int32)), wrap(cols),
                               wrap(vals)))
    return slabs


def build_color_slabs_block(bsr, colors, num_colors, dtype, bd,
                            device: torch.device) -> List[ColorSlab]:
    """Per-color packed block-ELL slabs from a BSR matrix: columns are
    block columns, values (nc, K, b, b)."""
    wrap = _wrap(device, dtype)
    bsr.sort_indices()
    ind = sp.csr_matrix(
        (np.arange(len(bsr.indices)), bsr.indices, bsr.indptr),
        shape=(bsr.shape[0] // bd, bsr.shape[1] // bd))
    slabs = []
    for c in range(num_colors):
        rows = np.where(colors == c)[0]
        sub = ind[rows]
        for_rows, pos, k = ell_layout(sub.indptr, sub.indices)
        cols = np.zeros((len(rows), k), dtype=np.int32)
        vals = np.zeros((len(rows), k, bd, bd),
                        dtype=_host_dtype(bsr.data))
        cols[for_rows, pos] = sub.indices
        vals[for_rows, pos] = bsr.data[sub.data]
        slabs.append(ColorSlab(wrap(rows.astype(np.int32)), wrap(cols),
                               wrap(vals)))
    return slabs


def slab_times(vals: torch.Tensor, yg: torch.Tensor) -> torch.Tensor:
    """A slab's rows times the gathered vector: Σ_k vals[:, k]·yg[:, k]
    for a scalar (nc, K) slab, or Σ_k Σ_c vals[:, k, :, c]·yg[:, k, c]
    for a block (nc, K, b, b) slab.  The products are added left to
    right, one elementwise op at a time: a batched product or a reduction
    orders its sums its own way on each device, and the card's f32
    sweeps would then round otherwise than the CPU's."""
    if vals.dim() == 2:
        p = ordered.mul(vals, yg)
        terms = [p[:, k] for k in range(p.shape[1])]
    else:
        p = ordered.mul(vals, yg[:, :, None, :])
        terms = [p[:, k, :, c] for k in range(p.shape[1])
                 for c in range(p.shape[3])]
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def host_bsr(A, b: int) -> sp.bsr_matrix:
    """The host matrix of a b×b block Matrix as a BSR."""
    return A.host if isinstance(A.host, sp.bsr_matrix) else \
        sp.bsr_matrix(A.host, blocksize=(b, b))


class _ColoredSmootherBase(Solver):
    """Shared setup: the coloring, the per-color slabs (on a sharded
    scalar pack the per-shard slabs of the flat extended vector; without
    a host matrix, or on a b×b sharded pack, the masks of the masked
    sweep) and D⁻¹."""

    def _setup_colors(self, build_slabs: bool = True,
                      dist_slabs: bool = True):
        Ad = self.Ad
        if self.A is not None:
            coloring = color_matrix(self.A, self.cfg, self.scope)
            colors = coloring.colors
            self.num_colors = coloring.num_colors
        else:
            # device-only fallback: one color (degenerates to Jacobi)
            colors = np.zeros(Ad.n_rows, dtype=np.int32)
            self.num_colors = 1
        b, dev, dt = Ad.block_dim, Ad.device, Ad.dtype
        sharded = Ad.fmt == "sharded-ell"
        self.color_slabs = None
        self.color_masks = None
        self.dist_slabs = None
        if build_slabs and self.A is not None and not sharded:
            if b == 1:
                self.color_slabs = build_color_slabs(
                    self.A.scalar_csr(), colors, self.num_colors, dt, dev)
            else:
                self.color_slabs = build_color_slabs_block(
                    host_bsr(self.A, b), colors, self.num_colors, dt, b,
                    dev)
        elif build_slabs and dist_slabs and sharded and b == 1 and \
                self.A is not None:
            self.dist_slabs = dist_color_slabs(Ad, colors, self.num_colors)
        elif sharded:
            from ..distributed.matrix import shard_vector
            self.color_masks = [
                shard_vector(Ad, np.repeat(colors == c, b)
                             .astype(np.float64)).real > 0.5
                for c in range(self.num_colors)]
        else:
            self.color_masks = [
                torch.from_numpy(np.repeat(colors == c, b)).to(dev)
                for c in range(self.num_colors)]
        self.dinv = setup_dinv(self)


def dist_color_slabs(Ad, colors: np.ndarray, num_colors: int
                     ) -> List[ColorSlab]:
    """Per-color slabs of a sharded scalar pack: each color's real rows of
    every shard (flat padded ids p·n_loc + l), their pack slots, the
    columns rebased into the flat extended vector — a local column c of
    shard p to p·n_loc + c, halo slot h to P·n_loc + p·H + h
    (``_stack_dist_color_rows`` upstream, one slab for all shards)."""
    offs = np.asarray(Ad.offsets)
    P, n_loc = Ad.n_parts, Ad.n_loc
    H = int(Ad.halo_src.shape[1])
    hc = Ad.host_cols.astype(np.int64)
    shard = np.arange(P, dtype=np.int64)[:, None, None]
    ext = np.where(hc < n_loc, shard * n_loc + hc,
                   P * n_loc + shard * H + (hc - n_loc)).reshape(P * n_loc,
                                                                 -1)
    dev = Ad.device
    slabs = []
    for c in range(num_colors):
        rows = np.concatenate([
            p * n_loc + np.flatnonzero(colors[offs[p]:offs[p + 1]] == c)
            for p in range(P)]).astype(np.int64)
        rows_t = torch.from_numpy(rows).to(dev)
        slabs.append(ColorSlab(rows_t, torch.from_numpy(ext[rows]).to(dev),
                               Ad.vals[rows_t]))
    return slabs


def _abs_row_sums_and_diag(A):
    """(Σ_j |a_ij|, |a_ii|) per scalar row of a host Matrix (per rank for
    a block-distributed upload)."""
    if A._host is None and A.blocks is not None:
        offs = A.block_offsets
        absrow = np.concatenate([
            np.asarray(np.abs(b).sum(axis=1)).ravel() for b in A.blocks])
        d = np.concatenate([
            np.abs(np.asarray(b[:, offs[p]:offs[p + 1]].diagonal()))
            for p, b in enumerate(A.blocks)])
        return absrow, d
    csr = A.scalar_csr()
    return (np.asarray(np.abs(csr).sum(axis=1)).ravel(),
            np.abs(csr.diagonal()))


def _sharded_or_local(Ad, vec: np.ndarray) -> torch.Tensor:
    """A real-sized per-row vector on the pack's device: padded to the
    sharded layout for a sharded pack."""
    if Ad.fmt == "sharded-ell":
        from ..distributed.matrix import shard_vector
        return shard_vector(Ad, vec)
    return torch.from_numpy(vec).to(Ad.device)


def _shard_transpose(A, Ad):
    """The sharded pack of Aᵀ from the row blocks of A
    (``_shard_transpose`` upstream): each rank routes its entries to
    their column owners (send-side, as the classical R blocks are
    collected); the row partition of Aᵀ is A's column partition, the
    same offsets."""
    from ..distributed.matrix import shard_matrix_from_blocks
    offs = np.asarray(Ad.offsets)
    n_parts = Ad.n_parts
    n = int(offs[-1])
    tri = [([], [], []) for _ in range(n_parts)]
    for p, blk in enumerate(A.rank_blocks()):
        coo = sp.coo_matrix(blk)
        gl_rows = coo.row.astype(np.int64) + offs[p]
        owner = np.searchsorted(offs, coo.col, side="right") - 1
        for q in np.unique(owner) if len(coo.col) else []:
            m = owner == q
            tri[q][0].append(coo.col[m] - offs[q])   # Aᵀ local rows
            tri[q][1].append(gl_rows[m])             # Aᵀ global columns
            tri[q][2].append(coo.data[m])
    t_blocks = []
    for q in range(n_parts):
        rr, cc, vv = tri[q]
        t_blocks.append(sp.csr_matrix(
            (np.concatenate(vv) if vv else [],
             (np.concatenate(rr) if rr else [],
              np.concatenate(cc) if cc else [])),
            shape=(int(offs[q + 1] - offs[q]), n)))
    return shard_matrix_from_blocks(t_blocks, offs, Ad.mesh, axis=Ad.axis,
                                    dtype=numpy_dtype(Ad.dtype),
                                    n_loc=Ad.n_loc)


def _structurally_symmetric(A) -> bool:
    """Pattern symmetry of a host Matrix (global, or per-rank blocks
    compared through their (i, j) and (j, i) keys); True when unknown."""
    if A is None or (A._host is None and A.blocks is None):
        return True
    if A.blocks is None:
        csr = sp.csr_matrix(A.host)
        pat = sp.csr_matrix(
            (np.ones(csr.nnz, np.int8), csr.indices, csr.indptr),
            shape=csr.shape)
        return (pat != pat.T).nnz == 0
    n = int(A.block_offsets[-1]) * A.block_dim
    keys, rkeys = [], []
    for p, b in enumerate(A.blocks):
        coo = sp.coo_matrix(b)
        rows = coo.row.astype(np.int64) + \
            int(A.block_offsets[p]) * A.block_dim
        cols = coo.col.astype(np.int64)
        keys.append(rows * n + cols)
        rkeys.append(cols * n + rows)
    return bool(np.array_equal(np.sort(np.concatenate(keys)),
                               np.sort(np.concatenate(rkeys))))


@register_solver("MULTICOLOR_GS")
class MulticolorGSSolver(_ColoredSmootherBase):
    """Multicolor Gauss–Seidel: colors in order (and back again with
    ``symmetric_GS``), each color's rows relaxed together,
    ``x_c += ω·D_c⁻¹·(b − A·x)_c``; ``GS_L1_variant`` damps the scalar
    diagonal to |a_ii| + ½·Σ_{j≠i}|a_ij|."""

    is_smoother = True

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.symmetric = bool(cfg.get("symmetric_GS", scope))
        self.l1_variant = bool(cfg.get("GS_L1_variant", scope))

    def solver_setup(self):
        self._setup_colors()
        if self.l1_variant and self.A is not None:
            absrow, d = _abs_row_sums_and_diag(self.A)
            dl1 = d + 0.5 * (absrow - d)
            dl1[dl1 == 0] = 1.0
            self.dinv = _sharded_or_local(
                self.Ad, (1.0 / dl1).astype(numpy_dtype(self.Ad.dtype)))
        bd = self.Ad.block_dim
        for s in list(self.color_slabs or ()) + list(self.dist_slabs or ()):
            rows = s.rows.long()
            s.einv = self.dinv.reshape(-1, bd)[rows] \
                if self.dinv.dim() == 1 and bd > 1 else self.dinv[rows]

    def _dist_color_sweep(self, b, x, order):
        """The sweep on a sharded scalar pack: one halo exchange at its
        start, then each color's rows relaxed against the flat extended
        vector (halo values frozen, local updates seen)."""
        from ..distributed.matrix import exchange_halo
        relax = self.relaxation_factor
        halo = exchange_halo(self.Ad, x, 1).reshape(-1)
        xe = torch.cat([x, halo, x.new_zeros(1)])
        for c in order:
            s = self.dist_slabs[c]
            r_c = b[s.rows] - slab_times(s.vals, xe[s.cols])
            xe[s.rows] = xe[s.rows] + ordered.mul(relax * s.einv, r_c)
        return xe[:x.shape[0]]

    def _color_sweep(self, b, x, order):
        relax = self.relaxation_factor
        if self.dist_slabs is not None:
            return self._dist_color_sweep(b, x, order)
        if self.color_slabs is None:
            for c in order:
                r = b - spmv(self.Ad, x)
                dx = relax * apply_dinv(self.dinv, r)
                x = torch.where(self.color_masks[c], x + dx, x)
            return x
        bd = self.Ad.block_dim
        if bd == 1:
            x = x.clone()
            for c in order:
                s = self.color_slabs[c]
                r_c = b[s.rows] - slab_times(s.vals, x[s.cols])
                x[s.rows] = x[s.rows] + ordered.mul(relax * s.einv, r_c)
            return x
        xb = x.reshape(-1, bd).clone()
        bb = b.reshape(-1, bd)
        for c in order:
            s = self.color_slabs[c]
            r_c = bb[s.rows] - slab_times(s.vals, xb[s.cols])
            if s.einv.dim() == 2:       # L1 variant: scalar damped diag
                dx = ordered.mul(relax * s.einv, r_c)
            else:
                dx = relax * apply_dinv(s.einv, r_c.reshape(-1)) \
                    .reshape(-1, bd)
            xb[s.rows] = xb[s.rows] + dx
        return xb.reshape(-1)

    def solve_iteration(self, b, x, state, iter_idx):
        x = self._color_sweep(b, x, range(self.num_colors))
        if self.symmetric:
            x = self._color_sweep(b, x, range(self.num_colors - 1, -1, -1))
        return x, state


@register_solver("GS")
class GSSolver(MulticolorGSSolver):
    """Serial GS (reference ``gauss_seidel_solver.cu``), realised as the
    color-ordered sweep, which performs the same relaxation on a properly
    colored matrix."""


@register_solver("FIXCOLOR_GS")
class FixcolorGSSolver(MulticolorGSSolver):
    """GS with a fixed color count (``fixcolor_gauss_seidel_solver.cu``):
    the ROUND_ROBIN coloring, unless the matrix is colored already."""

    def solver_setup(self):
        if self.A is not None and getattr(self.A, "coloring", None) is None:
            cfg2 = self.cfg.clone()
            cfg2.set("matrix_coloring_scheme", "ROUND_ROBIN", "default")
            self.A.coloring = color_matrix(self.A, cfg2, self.scope)
        super().solver_setup()


class _Projection:
    """One color's Kaczmarz projection data: every stored entry of the
    color's rows as (slab row, column, value); the columns are unique
    within the color."""

    def __init__(self, rows, cols, vals):
        self.rows, self.cols, self.vals = rows, cols, vals


@register_solver("KACZMARZ")
class KaczmarzSolver(_ColoredSmootherBase):
    """Multicolor Kaczmarz (reference ``kaczmarz_solver.cu``): row
    projections x += ω·a_i·(b_i − a_i·x)/‖a_i‖², one color at a time,
    the colors those of the A·Aᵀ graph (MIN_MAX), so rows of one color
    share no column and their projections are orthogonal."""

    is_smoother = True

    def solver_setup(self):
        Ad, A = self.Ad, self.A
        sharded = Ad.fmt == "sharded-ell"
        blocks_mode = A is not None and A._host is None and \
            A.blocks is not None
        if A is not None and Ad.block_dim == 1 and \
                not (sharded and blocks_mode):
            # the scalar A·Aᵀ coloring (kaczmarz_coloring_needed), also on
            # a sharded pack with a host view; a block-distributed upload
            # keeps the default coloring, as upstream
            csr = A.scalar_csr()
            pat = sp.csr_matrix(
                (np.ones(len(csr.data), dtype=np.int8),
                 csr.indices.copy(), csr.indptr.copy()), shape=csr.shape)
            G = sp.csr_matrix(pat @ pat.T)
            A.coloring = create_coloring("MIN_MAX", self.cfg,
                                         self.scope).color(G)
        # slab projections are scalar-row based; block and sharded packs
        # relax through masks
        self._setup_colors(build_slabs=Ad.block_dim == 1, dist_slabs=False)
        dev = Ad.device
        if A is not None:
            if blocks_mode:
                rn = np.concatenate([
                    np.asarray(b.multiply(b).sum(axis=1)).ravel()
                    for b in A.blocks])
            else:
                csr = A.scalar_csr()
                rn = np.asarray(csr.multiply(csr).sum(axis=1)).ravel()
            rn[rn == 0] = 1.0
            self.rowinv = _sharded_or_local(
                Ad, (1.0 / rn).astype(numpy_dtype(Ad.dtype)))
            if not sharded:
                self.AdT = Matrix(csr.T.tocsr().astype(
                    numpy_dtype(Ad.dtype)), device=dev).device()
            elif Ad.block_dim == 1:
                # the true distributed transpose (kaczmarz_solver.cu
                # builds Aᵀ)
                self.AdT = _shard_transpose(A, Ad)
            else:
                # no block transpose pack upstream either: A stands in,
                # exact only under structural symmetry
                self.AdT = Ad
                if not _structurally_symmetric(A):
                    amgx_output(
                        "WARNING: distributed block KACZMARZ substitutes A "
                        "for A^T but this matrix is NOT structurally "
                        "symmetric — projections use wrong couplings and "
                        "convergence will degrade\n")
        else:
            self.rowinv = torch.ones(Ad.n, dtype=Ad.dtype, device=dev)
            self.AdT = Ad
        self.projections = None
        if self.color_slabs is not None:
            self.projections = self._projections(A.scalar_csr())
            for s in self.color_slabs:
                s.einv = self.rowinv[s.rows.long()]

    def _projections(self, csr) -> List[_Projection]:
        colors = self.A.coloring.colors
        up = _wrap(self.Ad.device, self.Ad.dtype)
        out = []
        for c in range(self.num_colors):
            sub = sp.csr_matrix(csr[np.where(colors == c)[0]])
            sub.sort_indices()
            rows = np.repeat(np.arange(sub.shape[0], dtype=np.int64),
                             np.diff(sub.indptr))
            out.append(_Projection(up(rows), up(sub.indices.astype(
                np.int64)), up(sub.data.astype(_host_dtype(sub.data)))))
        return out

    def solve_iteration(self, b, x, state, iter_idx):
        relax = self.relaxation_factor
        if self.projections is not None:
            x = x.clone()
            for s, pr in zip(self.color_slabs, self.projections):
                r_c = b[s.rows] - slab_times(s.vals, x[s.cols])
                w = ordered.mul(relax * r_c, s.einv)
                x[pr.cols] = x[pr.cols] + ordered.mul(pr.vals, w[pr.rows])
            return x, state
        for c in range(self.num_colors):
            r = b - spmv(self.Ad, x)
            w = torch.where(self.color_masks[c],
                            ordered.mul(r, self.rowinv), torch.zeros_like(r))
            x = x + relax * spmv(self.AdT, w)
        return x, state
