"""Galerkin coarse-matrix generation for aggregation AMG (the host
generators of ``amgx_tpu/amg/aggregation/galerkin.py``, copied).

Reference: ``core/src/aggregation/coarseAgenerators/`` — LOW_DEG
(shared-memory hash SpGEMM specialised for piecewise-constant aggregation,
``low_deg_coarse_A_generator.cu:94-448``), THRUST (sort-based), HYBRID.

With unsmoothed aggregation R = Sᵀ and P = S for the 0/1 selector matrix S,
so RAP collapses to a segment-sum over (agg[row], agg[col]) block pairs —
no general SpGEMM needed.

These host generators are the reference and the path of a level the
device setup engine declines (below ``device_setup_min_rows``, or with
``device_setup=0``): the engine
(:meth:`~..device_setup.DeviceSetupEngine.galerkin_agg`) runs the same
segment semantics on the level's device.  Both sum each coarse entry's
fine terms, so their f64 results differ only in the order of each sum.
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


def galerkin_coarse_block(A_bsr: sp.bsr_matrix, agg: np.ndarray,
                          block_dim: int) -> sp.bsr_matrix:
    """Blockwise Ac: coarse block (I,J) = Σ blocks (i,j) with agg[i]=I,
    agg[j]=J (reference LOW_DEG semantics for b×b systems)."""
    b = block_dim
    bsr = A_bsr if isinstance(A_bsr, sp.bsr_matrix) else sp.bsr_matrix(
        A_bsr, blocksize=(b, b))
    bsr.sort_indices()
    n = bsr.shape[0] // b
    nc = int(agg.max()) + 1
    rows = np.repeat(np.arange(n), np.diff(bsr.indptr))
    key = agg[rows] * nc + agg[bsr.indices]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    blocks = bsr.data[order]
    uniq, start = np.unique(key_s, return_index=True)
    out = np.add.reduceat(blocks, start, axis=0)
    ci_u, cj_u = uniq // nc, uniq % nc
    indptr = np.zeros(nc + 1, dtype=np.int64)
    np.add.at(indptr, ci_u + 1, 1)
    indptr = np.cumsum(indptr)
    return sp.bsr_matrix((out, cj_u.astype(np.int32), indptr),
                         shape=(nc * b, nc * b))


def galerkin_coarse(A_host, agg: np.ndarray, block_dim: int = 1):
    """Ac = Sᵀ A S on the host: scalar CSR, or b×b BSR blocks."""
    if block_dim == 1:
        return galerkin_coarse_scalar(sp.csr_matrix(A_host), agg)
    return galerkin_coarse_block(A_host, agg, block_dim)
