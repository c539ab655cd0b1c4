"""Per-color row slabs of the color-parallel smoothers (port of
``ColorSlab``, ``build_color_slabs`` and ``build_color_slabs_block`` of
``amgx_tpu/solvers/gs.py``; the Gauss–Seidel solvers themselves are a
later slice).

Rows of one color are independent.  Each color's rows are gathered at
setup into a compact ELL slab (rows, padded columns, values), so a sweep
costs O(nnz) in all: the update of a color reads only that color's slab
and writes only that color's rows, like the reference's per-color kernels
(``multicolor_dilu_solver.cu``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from ..core.matrix import ell_layout
from ..device import torch_dtype


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
