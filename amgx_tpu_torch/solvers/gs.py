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
the JAX package does.  The JAX package's sharded sweeps belong to the
distribution slice of the port.

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
from ..ops.spmv import spmv
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


def _wrap(device: torch.device, dtype):
    """numpy → tensors on ``device``, floating arrays cast to ``dtype``."""
    tdt = torch_dtype(dtype)

    def up(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, tdt if t.is_floating_point() else None)
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
        vals = np.zeros((len(rows), k), dtype=np.float64)
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
        vals = np.zeros((len(rows), k, bd, bd), dtype=np.float64)
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


def host_bsr(A, b: int) -> sp.bsr_matrix:
    """The host matrix of a b×b block Matrix as a BSR."""
    return A.host if isinstance(A.host, sp.bsr_matrix) else \
        sp.bsr_matrix(A.host, blocksize=(b, b))


class _ColoredSmootherBase(Solver):
    """Shared setup: the coloring, the per-color slabs (or, without a host
    matrix, the masks of the single-color fallback) and D⁻¹."""

    def _setup_colors(self, build_slabs: bool = True):
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
        self.color_slabs = None
        self.color_masks = None
        if build_slabs and self.A is not None:
            if b == 1:
                self.color_slabs = build_color_slabs(
                    self.A.scalar_csr(), colors, self.num_colors, dt, dev)
            else:
                self.color_slabs = build_color_slabs_block(
                    host_bsr(self.A, b), colors, self.num_colors, dt, b,
                    dev)
        else:
            self.color_masks = [
                torch.from_numpy(np.repeat(colors == c, b)).to(dev)
                for c in range(self.num_colors)]
        self.dinv = setup_dinv(self)


def _abs_row_sums_and_diag(A):
    """(Σ_j |a_ij|, |a_ii|) per scalar row of a host Matrix."""
    csr = A.scalar_csr()
    return (np.asarray(np.abs(csr).sum(axis=1)).ravel(),
            np.abs(csr.diagonal()))


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
            vec = (1.0 / dl1).astype(numpy_dtype(self.Ad.dtype))
            self.dinv = torch.from_numpy(vec).to(self.Ad.device)
        bd = self.Ad.block_dim
        for s in self.color_slabs or ():
            rows = s.rows.long()
            s.einv = self.dinv.reshape(-1, bd)[rows] \
                if self.dinv.dim() == 1 and bd > 1 else self.dinv[rows]

    def _color_sweep(self, b, x, order):
        relax = self.relaxation_factor
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
                x[s.rows] = x[s.rows] + relax * s.einv * r_c
            return x
        xb = x.reshape(-1, bd).clone()
        bb = b.reshape(-1, bd)
        for c in order:
            s = self.color_slabs[c]
            r_c = bb[s.rows] - slab_times(s.vals, xb[s.cols])
            if s.einv.dim() == 2:       # L1 variant: scalar damped diag
                dx = relax * s.einv * r_c
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
        if A is not None and Ad.block_dim == 1:
            csr = A.scalar_csr()
            pat = sp.csr_matrix(
                (np.ones(len(csr.data), dtype=np.int8),
                 csr.indices.copy(), csr.indptr.copy()), shape=csr.shape)
            G = sp.csr_matrix(pat @ pat.T)
            A.coloring = create_coloring("MIN_MAX", self.cfg,
                                         self.scope).color(G)
        # slab projections are scalar-row based; block packs use masks
        self._setup_colors(build_slabs=Ad.block_dim == 1)
        dev = Ad.device
        if A is not None:
            csr = A.scalar_csr()
            rn = np.asarray(csr.multiply(csr).sum(axis=1)).ravel()
            rn[rn == 0] = 1.0
            self.rowinv = torch.from_numpy(
                (1.0 / rn).astype(numpy_dtype(Ad.dtype))).to(dev)
            self.AdT = Matrix(csr.T.tocsr().astype(numpy_dtype(Ad.dtype)),
                              device=dev).device()
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
                np.int64)), up(sub.data.astype(np.float64))))
        return out

    def solve_iteration(self, b, x, state, iter_idx):
        relax = self.relaxation_factor
        if self.projections is not None:
            x = x.clone()
            for s, pr in zip(self.color_slabs, self.projections):
                r_c = b[s.rows] - slab_times(s.vals, x[s.cols])
                w = relax * r_c * s.einv
                x[pr.cols] = x[pr.cols] + pr.vals * w[pr.rows]
            return x, state
        for c in range(self.num_colors):
            r = b - spmv(self.Ad, x)
            w = torch.where(self.color_masks[c], r * self.rowinv,
                            torch.zeros_like(r))
            x = x + relax * spmv(self.AdT, w)
        return x, state
