"""Multicolor ILU(k) smoother (port of ``amgx_tpu/solvers/ilu.py``;
reference ``core/src/solvers/multicolor_ilu_solver.cu``,
``ilu_sparsity_level`` core.cu:423).

The matrix is factorised on the host in color-rank order (the reference
reorders by color, ``reorderColumnsByColor``), with the coloring computed
on the filled pattern L+U so that the rows of one color stay independent
at any fill level k.  The factors go to the device as per-color L and U
row slabs; each application is two color-ordered sweeps over them,
O(nnz(LU)), whose sums add left to right (:func:`~.gs.slab_times`) and
whose writes go to unique rows — the same on every device, and with no
host sync, so a sweep runs inside the AMG's CUDA graph.

:func:`_ilu_factorize` is the JAX package's host loop over rows, copied:
its setup time grows with the rows (ROADMAP: vectorise it).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..coloring import create_coloring
from ..errors import BadConfigurationError
from ..ops import ordered
from ..ops.spmv import spmv
from .base import Solver, register_solver
from .gs import _wrap, build_color_slabs, slab_times


def _symbolic_fill(A: sp.csr_matrix, level: int) -> sp.csr_matrix:
    """ILU(k) sparsity pattern via k rounds of symbolic products
    (pattern of L·U grows like powers of the adjacency)."""
    pat = sp.csr_matrix(
        (np.ones(len(A.data), dtype=np.int8), A.indices.copy(),
         A.indptr.copy()), shape=A.shape)
    base = pat.copy()
    for _ in range(level):
        pat = ((pat @ base) + pat).tocsr()
        pat.data[:] = 1
    pat.sort_indices()
    return pat


def _ilu_factorize(A: sp.csr_matrix, pattern: sp.csr_matrix,
                   rank: np.ndarray):
    """IKJ ILU on the given pattern with rows processed in ``rank`` order.

    Returns (LU_csr) holding L (strict lower by rank, unit diagonal
    implicit) and U (upper incl. diagonal) in one matrix, plus 1/diag.
    Host-side, O(nnz·avg_row); runs once per setup.
    """
    n = A.shape[0]
    # build working rows on the fill pattern
    pat = pattern.tocsr()
    pat.sort_indices()
    work = sp.csr_matrix((np.zeros(len(pat.data)), pat.indices.copy(),
                          pat.indptr.copy()), shape=A.shape)
    # scatter A into the pattern: positions of A entries inside pattern
    # rows
    arows = np.repeat(np.arange(n), np.diff(A.indptr))
    akeys = arows.astype(np.int64) * n + A.indices
    prows = np.repeat(np.arange(n), np.diff(pat.indptr))
    pkeys = prows.astype(np.int64) * n + pat.indices
    pos = np.searchsorted(pkeys, akeys)
    work.data[pos] = A.data

    indptr, indices, data = work.indptr, work.indices, work.data
    inv_rank = np.empty(n, dtype=np.int64)
    order = np.argsort(rank, kind="stable")
    inv_rank[order] = np.arange(n)
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        sl = slice(indptr[i], indptr[i + 1])
        dloc = np.flatnonzero(indices[sl] == i)
        if len(dloc):
            diag_pos[i] = indptr[i] + dloc[0]
    # IKJ in rank order
    for i in order:
        sl = slice(indptr[i], indptr[i + 1])
        cols_i = indices[sl]
        row_i = data[sl]
        lower_mask = rank[cols_i] < rank[i]
        for t in np.flatnonzero(lower_mask)[np.argsort(
                rank[cols_i[np.flatnonzero(lower_mask)]])]:
            k = cols_i[t]
            dk = data[diag_pos[k]] if diag_pos[k] >= 0 else 1.0
            if dk == 0:
                dk = 1.0
            lik = row_i[t] / dk
            row_i[t] = lik
            # row_i -= lik * row_k (restricted to row_i's pattern, upper
            # of k)
            slk = slice(indptr[k], indptr[k + 1])
            cols_k = indices[slk]
            upk = rank[cols_k] > rank[k]
            ck = cols_k[upk]
            vk = data[slk][upk]
            posr = np.searchsorted(cols_i, ck)
            posr_c = np.minimum(posr, len(cols_i) - 1)
            hit = (posr < len(cols_i)) & (cols_i[posr_c] == ck)
            row_i[posr_c[hit]] -= lik * vk[hit]
        data[sl] = row_i
    dvals = np.array([data[diag_pos[i]] if diag_pos[i] >= 0 else 1.0
                      for i in range(n)])
    dvals[dvals == 0] = 1.0
    return work, 1.0 / dvals


@register_solver("MULTICOLOR_ILU")
class MulticolorILUSolver(Solver):
    is_smoother = True

    def __init__(self, cfg, scope="default"):
        super().__init__(cfg, scope)
        self.sparsity_level = int(cfg.get("ilu_sparsity_level", scope))

    def solver_setup(self):
        if self.A is None:
            raise BadConfigurationError(
                "MULTICOLOR_ILU setup requires the host matrix")
        if self.Ad.fmt == "sharded-ell":
            # refused as upstream (``ilu.py:117-120``)
            raise BadConfigurationError(
                "distributed MULTICOLOR_ILU not supported yet — use "
                "MULTICOLOR_DILU (the reference default) instead")
        csr = self.A.scalar_csr().astype(np.float64)
        csr.sort_indices()
        pattern = _symbolic_fill(csr, self.sparsity_level)
        # color the FILLED graph so per-color independence survives fill-in
        algo = create_coloring(
            str(self.cfg.get("matrix_coloring_scheme", self.scope)),
            self.cfg, self.scope)
        coloring = algo.color(pattern)
        colors = coloring.colors
        self.num_colors = coloring.num_colors
        rank = colors.astype(np.int64)
        LU, dinv = _ilu_factorize(csr, pattern, rank)
        n = csr.shape[0]
        rows = np.repeat(np.arange(n), np.diff(LU.indptr))
        lower = rank[LU.indices] < rank[rows]
        upper = rank[LU.indices] > rank[rows]
        L = sp.csr_matrix((np.where(lower, LU.data, 0.0),
                           LU.indices.copy(), LU.indptr.copy()),
                          shape=LU.shape)
        L.eliminate_zeros()
        U = sp.csr_matrix((np.where(upper, LU.data, 0.0),
                           LU.indices.copy(), LU.indptr.copy()),
                          shape=LU.shape)
        U.eliminate_zeros()
        dev, dt = self.Ad.device, self.Ad.dtype
        self.L_slabs = build_color_slabs(L, colors, self.num_colors, dt,
                                         dev)
        self.U_slabs = build_color_slabs(U, colors, self.num_colors, dt,
                                         dev)
        self.dinv_f = _wrap(dev, dt)(dinv)
        for s in self.U_slabs:
            s.einv = self.dinv_f[s.rows.long()]

    def _apply_ilu(self, r):
        # L y = r (unit lower): y_c = r_c − (L·y)_c
        y = r.new_zeros(r.shape)
        for s in self.L_slabs:
            y[s.rows] = r[s.rows] - slab_times(s.vals, y[s.cols])
        # U z = y: z_c = dinv_c·(y − U·z)_c
        z = r.new_zeros(r.shape)
        for s in reversed(self.U_slabs):
            z[s.rows] = ordered.mul(s.einv, y[s.rows] - slab_times(s.vals,
                                                          z[s.cols]))
        return z

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + self.relaxation_factor * self._apply_ilu(r), state
