"""Pairwise (index-order {2I, 2I+1}) aggregation on DIA operators, the
host half (port of ``amgx_tpu/amg/pairwise.py``, numpy, copied).

The planned levels of a GEO hierarchy derive on the device
(:mod:`amgx_tpu_torch.amg.dia_device`); :func:`pairwise_galerkin_dia`
is the host step of a DIA level past that plan (its coarse operator
would exceed the plan's diagonal budget), at setup and at a
values-only resetup.  :func:`dia_to_scipy` assembles a DIA level's CSR
view.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def pairwise_galerkin_dia(offsets, vals: np.ndarray):
    """Coarse operator for strict pairing {2I, 2I+1}, diagonal-wise.

    A fine entry A[i, i+d] with i = 2I + r lands at coarse offset
    o = (d + r) >> 1 (arithmetic floor shift), row I: strided adds over
    the (nd, n) diagonal arrays, no sparse product (the DIA analog of
    ``csr_galerkin_product``, csr_multiply.h:100-126)."""
    nd, n = vals.shape
    nc = (n + 1) // 2
    coarse = {}
    for k, d in enumerate(offsets):
        for r in (0, 1):
            o = (d + r) >> 1
            row_vals = vals[k, r::2]
            buf = coarse.get(o)
            if buf is None:
                buf = np.zeros(nc, dtype=vals.dtype)
                coarse[o] = buf
            m = len(row_vals)
            buf[:m] += row_vals
    offs_c = sorted(coarse)
    vals_c = np.stack([coarse[o] for o in offs_c])
    # out-of-range coarse columns need no mask: a fine value exists only
    # for 0 ≤ i+d < n, which implies 0 ≤ I+o < nc for its coarse slot
    return offs_c, vals_c


def dia_to_scipy(offsets, vals: np.ndarray, n: int,
                 n_cols: int = None) -> sp.csr_matrix:
    """Row-aligned diagonals (``A[i, i+d_k] = vals[k, i]``) → scipy CSR
    with explicit zeros dropped.  ``n_cols`` supports rectangular
    operators (default square)."""
    nd = len(offsets)
    m = int(n_cols) if n_cols is not None else n
    if nd == 0:
        return sp.csr_matrix((n, m), dtype=vals.dtype)
    idx_t = np.int32 if (n + m - 1) < 2**31 else np.int64
    offs = np.asarray(offsets, dtype=idx_t)
    rows = np.arange(n, dtype=idx_t)
    cols = rows[:, None] + offs[None, :]              # (n, nd)
    vt = vals.T
    keep = (vt != 0) & (cols >= 0) & (cols < m)
    ptr_t = np.int32 if n * nd < 2**31 - 1 else np.int64
    indptr = np.zeros(n + 1, dtype=ptr_t)
    np.cumsum(keep.sum(axis=1, dtype=ptr_t), out=indptr[1:])
    csr = sp.csr_matrix((vt[keep], cols[keep], indptr), shape=(n, m))
    csr.has_sorted_indices = True
    return csr
