"""NVAMG binary system format (a copy of ``amgx_tpu/io/binary.py``:
numpy and scipy only, so a file is byte-equal to the JAX package's).

Reference: the ``%%NVAMGBinary`` reader/writer
(``core/src/readers.cu:1700-1960``).  Layout (studied from the reader's
field order; implementation is fresh):

    "%%NVAMGBinary\\n"                     14 bytes
    uint32[9]: is_mtx, is_rhs, is_soln, matrix_format(0=CSR), diag,
               block_dimx, block_dimy, num_rows, num_nz
    int32 row_offsets[num_rows+1]
    int32 col_indices[num_nz]
    float64 values[num_nz·bx·by]
    [float64 diag[num_rows·bx·by]]   when diag flag set (external diagonal)
    [float64 rhs[num_rows·bx]]        when is_rhs
    [float64 soln[num_rows·bx]]       when is_soln
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..errors import IOError_
from .matrix_market import SystemData

_MAGIC = b"%%NVAMGBinary\n"


def read_binary(path: str) -> SystemData:
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise IOError_(f"{path}: not an NVAMGBinary file")
        flags = np.fromfile(f, dtype=np.uint32, count=9)
        (_is_mtx, is_rhs, is_soln, _fmt, diag_flag, bx, by, n_rows,
         n_nz) = (int(v) for v in flags)
        indptr = np.fromfile(f, dtype=np.int32, count=n_rows + 1)
        indices = np.fromfile(f, dtype=np.int32, count=n_nz)
        vals = np.fromfile(f, dtype=np.float64, count=n_nz * bx * by)
        if len(vals) != n_nz * bx * by:
            raise IOError_(f"{path}: truncated values")
        if bx == 1:
            A = sp.csr_matrix((vals, indices, indptr),
                              shape=(n_rows, n_rows))
        else:
            A = sp.bsr_matrix((vals.reshape(-1, bx, by), indices, indptr),
                              shape=(n_rows * bx, n_rows * by))
        if diag_flag:
            dvals = np.fromfile(f, dtype=np.float64,
                                count=n_rows * bx * by)
            if bx == 1:
                A = sp.csr_matrix(A + sp.diags(dvals))
            else:
                D = sp.block_diag(list(dvals.reshape(-1, bx, by)),
                                  format="bsr")
                A = sp.bsr_matrix(A + D, blocksize=(bx, by))
        rhs = soln = None
        if is_rhs:
            rhs = np.fromfile(f, dtype=np.float64, count=n_rows * bx)
        if is_soln:
            soln = np.fromfile(f, dtype=np.float64, count=n_rows * bx)
    return SystemData(A=A, rhs=rhs, solution=soln, block_dimx=bx,
                      block_dimy=by)


def write_binary(path: str, A, rhs: Optional[np.ndarray] = None,
                 solution: Optional[np.ndarray] = None, block_dim: int = 1):
    b = int(block_dim)
    if b == 1:
        csr = sp.csr_matrix(A)
        csr.sort_indices()
        indptr, indices = csr.indptr, csr.indices
        vals = csr.data.astype(np.float64)
        n_rows = csr.shape[0]
        n_nz = csr.nnz
    else:
        bsr = A if isinstance(A, sp.bsr_matrix) else sp.bsr_matrix(
            A, blocksize=(b, b))
        bsr.sort_indices()
        indptr, indices = bsr.indptr, bsr.indices
        vals = bsr.data.astype(np.float64).ravel()
        n_rows = bsr.shape[0] // b
        n_nz = len(bsr.indices)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        flags = np.array([1, rhs is not None, solution is not None, 0, 0,
                          b, b, n_rows, n_nz], dtype=np.uint32)
        flags.tofile(f)
        indptr.astype(np.int32).tofile(f)
        indices.astype(np.int32).tofile(f)
        vals.tofile(f)
        if rhs is not None:
            np.asarray(rhs, dtype=np.float64).tofile(f)
        if solution is not None:
            np.asarray(solution, dtype=np.float64).tofile(f)


def read_system_auto(path: str) -> SystemData:
    """Dispatch MatrixMarket vs binary by magic (MatrixIO reader registry,
    matrix_io.h:51-107)."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
    if head == _MAGIC:
        return read_binary(path)
    from .matrix_market import read_matrix_market
    return read_matrix_market(path)
