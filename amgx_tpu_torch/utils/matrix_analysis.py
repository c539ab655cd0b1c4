"""Matrix diagnostics (a copy of ``amgx_tpu/utils/matrix_analysis.py``:
numpy and scipy only, so the port keeps its own).

Reference: ``core/src/matrix_analysis.cu`` (~700 LoC) — structural and
spectral analysis used for debugging solver behaviour.  Both functions
take a scipy matrix or a port :class:`~amgx_tpu_torch.core.Matrix`,
whose host CSR (``scalar_csr()``) they read.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.sparse as sp


def _host_csr(A) -> sp.csr_matrix:
    """The scalar host CSR of a port ``Matrix``, else ``A`` as a CSR."""
    if hasattr(A, "scalar_csr"):
        return A.scalar_csr()
    return sp.csr_matrix(A)


def analyze_matrix(A) -> Dict:
    """Structure + conditioning diagnostics of a (scalar view of a)
    sparse matrix."""
    csr = _host_csr(A)
    n = csr.shape[0]
    deg = np.diff(csr.indptr)
    diag = csr.diagonal()
    absrow = np.asarray(abs(csr).sum(axis=1)).ravel()
    offsum = absrow - np.abs(diag)
    dd = np.abs(diag) - offsum            # diagonal dominance margin
    sym_err = 0.0
    if csr.shape[0] == csr.shape[1]:
        d = (csr - csr.T).tocsr()
        sym_err = float(np.abs(d.data).max()) if d.nnz else 0.0
    rowsum = np.asarray(csr.sum(axis=1)).ravel()
    out = {
        "n_rows": int(n),
        "n_cols": int(csr.shape[1]),
        "nnz": int(csr.nnz),
        "avg_nnz_per_row": float(deg.mean()) if n else 0.0,
        "max_nnz_per_row": int(deg.max()) if n else 0,
        "empty_rows": int((deg == 0).sum()),
        "zero_diagonal_entries": int((diag == 0).sum()),
        "diag_dominant_rows_frac": float((dd >= 0).mean()) if n else 0.0,
        "structurally_symmetric": _struct_symmetric(csr),
        "symmetry_error_max": sym_err,
        "zero_row_sum_rows": int((np.abs(rowsum) < 1e-14).sum()),
        "norm_inf": float(absrow.max()) if n else 0.0,
        "bandwidth": _bandwidth(csr),
    }
    return out


def _struct_symmetric(csr: sp.csr_matrix) -> bool:
    if csr.shape[0] != csr.shape[1]:
        return False
    pat = sp.csr_matrix((np.ones(len(csr.data), dtype=np.int8),
                         csr.indices.copy(), csr.indptr.copy()),
                        shape=csr.shape)
    return (pat != pat.T).nnz == 0


def _bandwidth(csr: sp.csr_matrix) -> int:
    if csr.nnz == 0:
        return 0
    rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
    return int(np.abs(rows - csr.indices).max())


def estimate_spectral_bounds(A, n_iters: int = 30) -> Dict:
    """λmax estimate (power iteration) + Gershgorin bounds."""
    csr = _host_csr(A).astype(np.float64)
    n = csr.shape[0]
    x = np.random.default_rng(0).standard_normal(n)
    lam = 0.0
    for _ in range(n_iters):
        y = csr @ x
        nrm = np.linalg.norm(y)
        if nrm == 0:
            break
        lam = x @ y / (x @ x)
        x = y / nrm
    diag = csr.diagonal()
    absrow = np.asarray(abs(csr).sum(axis=1)).ravel()
    r = absrow - np.abs(diag)
    return {
        "lambda_max_estimate": float(lam),
        "gershgorin_upper": float((diag + r).max()),
        "gershgorin_lower": float((diag - r).min()),
    }
