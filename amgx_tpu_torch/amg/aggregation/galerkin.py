"""Galerkin coarse-matrix generation for aggregation AMG (the scalar
host generator of ``amgx_tpu/amg/aggregation/galerkin.py``, copied).

Reference: ``core/src/aggregation/coarseAgenerators/`` — LOW_DEG
(shared-memory hash SpGEMM specialised for piecewise-constant aggregation,
``low_deg_coarse_A_generator.cu:94-448``), THRUST (sort-based), HYBRID.

With unsmoothed aggregation R = Sᵀ and P = S for the 0/1 selector matrix S,
so RAP collapses to a segment-sum over (agg[row], agg[col]) block pairs —
no general SpGEMM needed.

The JAX package runs the same segment semantics on its device through a
pattern-keyed setup engine and keeps this sort-based generator as its
fallback; the port runs the generator on the host (the device engine is
a later slice).  Both sum each coarse entry's fine terms, so their f64
results differ only in the order of each sum.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def galerkin_coarse_scalar(A: sp.csr_matrix, agg: np.ndarray
                           ) -> sp.csr_matrix:
    """Ac = Sᵀ A S for scalar matrices."""
    n = A.shape[0]
    nc = int(agg.max()) + 1 if len(agg) else 0
    S = sp.csr_matrix((np.ones(n, dtype=A.dtype), (np.arange(n), agg)),
                      shape=(n, nc))
    Ac = sp.csr_matrix(S.T @ A @ S)
    Ac.sum_duplicates()
    Ac.sort_indices()
    return Ac
