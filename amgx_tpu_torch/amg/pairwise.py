"""Row-aligned DIA arrays → scipy CSR (port of the host half of
``amgx_tpu/amg/pairwise.py``).

The pairwise (index-order {2I, 2I+1}) Galerkin itself runs on the device
in :mod:`amgx_tpu_torch.amg.dia_device`; the host pairwise coarsening
loop belongs to a later slice.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
