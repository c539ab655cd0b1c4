"""MatrixMarket reader/writer with the reference's AMGX extensions (a
copy of ``amgx_tpu/io/matrix_market.py``: numpy and scipy only).

Reference: ``base/src/matrix_io.cu`` (reader/writer registry) and
``core/src/readers.cu:666-1500`` (``ReadMatrixMarket``).  Supported beyond
standard MatrixMarket:

* a second header line ``%%AMGX <tokens>`` (also accepts ``%%NVAMG``) with
  tokens: ``rhs`` / ``solution`` (vectors appended after the entries),
  ``diagonal`` (external diagonal block stored after the entries),
  ``sorted``, ``base0``, and one or two integers giving the block size
  (``readers.cu:795-835``).
* ``symmetric`` / ``skew-symmetric`` / ``hermitian`` qualifiers (mirrored on
  read).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..errors import IOError_


@dataclasses.dataclass
class SystemData:
    """A linear system read from disk: A, and optionally b and x0."""

    A: sp.spmatrix
    rhs: Optional[np.ndarray]
    solution: Optional[np.ndarray]
    block_dimx: int = 1
    block_dimy: int = 1

    @property
    def block_dim(self):
        return self.block_dimx


def _tokens(line: str):
    return line.strip().lower().split()


def read_matrix_market(path: str,
                       block_dim: Optional[int] = None) -> SystemData:
    """Read a MatrixMarket system; ``block_dim`` re-blocks a SCALAR
    file into a b×b BSR system on the way in (the gauntlet loader for
    elasticity/CFD matrices stored entry-wise):
    dimensions must be divisible by ``block_dim`` — the error names the
    failing dimension — and a file that itself declares a conflicting
    block size is rejected rather than silently re-interpreted."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise IOError_(f"{path}: missing %%MatrixMarket header")
        htok = _tokens(header[2:])
        is_complex = "complex" in htok
        symmetric = "symmetric" in htok or "skew-symmetric" in htok
        skew = "skew-symmetric" in htok
        hermitian = "hermitian" in htok
        if "pattern" in htok:
            raise IOError_("'pattern' matrices are not supported")

        block_dimx = block_dimy = 1
        index_base = 1
        has_rhs = has_soln = has_diag = False
        # comment lines; %%AMGX/%%NVAMG extension line
        pos = f.tell()
        line = f.readline()
        while line.startswith("%"):
            if line.startswith("%%AMGX") or line.startswith("%%NVAMG"):
                sizes = []
                for t in _tokens(line[2:])[1:]:
                    if t == "rhs":
                        has_rhs = True
                    elif t == "solution":
                        has_soln = True
                    elif t == "diagonal":
                        has_diag = True
                    elif t == "base0":
                        index_base = 0
                    elif t and t[0].isdigit():
                        sizes.append(int(t))
                if len(sizes) == 1:
                    block_dimx = block_dimy = sizes[0]
                elif len(sizes) >= 2:
                    block_dimx, block_dimy = sizes[0], sizes[1]
            pos = f.tell()
            line = f.readline()
        first_data_line = line

        parts = first_data_line.split()
        if len(parts) != 3:
            raise IOError_(f"{path}: expected 'rows cols nnz' line")
        rows, cols, entries = (int(p) for p in parts)

        rest = f.read().split()

    vals_per_entry = 4 if is_complex else 3
    need = entries * vals_per_entry
    if len(rest) < need:
        raise IOError_(f"{path}: truncated entry data "
                       f"({len(rest)} tokens < {need})")
    entry_tok = np.asarray(rest[:need])
    rest = rest[need:]
    ijv = entry_tok.reshape(entries, vals_per_entry)
    i = ijv[:, 0].astype(np.int64) - index_base
    j = ijv[:, 1].astype(np.int64) - index_base
    if is_complex:
        v = ijv[:, 2].astype(np.float64) + 1j * ijv[:, 3].astype(np.float64)
    else:
        v = ijv[:, 2].astype(np.float64)

    if symmetric or hermitian:
        off = i != j
        i2, j2 = j[off], i[off]
        v2 = v[off]
        if skew:
            v2 = -v2
        elif hermitian:
            v2 = np.conj(v2)
        i = np.concatenate([i, i2])
        j = np.concatenate([j, j2])
        v = np.concatenate([v, v2])

    A = sp.csr_matrix((v, (i, j)), shape=(rows, cols))
    A.sum_duplicates()
    A.sort_indices()

    if has_diag:
        # external diagonal: one value per row appended (readers.cu diag
        # path) — 're im' pairs in complex files, like every other block
        per = 2 if is_complex else 1
        ntok = rows * per
        tok = np.asarray(rest[:ntok])
        rest = rest[ntok:]
        if is_complex:
            t = tok.reshape(rows, 2)
            dvals = t[:, 0].astype(np.float64) \
                + 1j * t[:, 1].astype(np.float64)
        else:
            dvals = tok.astype(np.float64)
        A = A + sp.diags(dvals, shape=(rows, cols))
        A = sp.csr_matrix(A)

    def read_vec(rest):
        """rhs/solution block: complex systems carry 're im' pairs per
        entry (same convention as the coordinate entries)."""
        per = 2 if is_complex else 1
        if len(rest) < rows * per:
            raise IOError_(f"{path}: truncated vector block")
        tok = np.asarray(rest[:rows * per])
        rest = rest[rows * per:]
        if is_complex:
            t = tok.reshape(rows, 2)
            return (t[:, 0].astype(np.float64)
                    + 1j * t[:, 1].astype(np.float64)), rest
        return tok.astype(np.float64), rest

    rhs = soln = None
    if has_rhs:
        rhs, rest = read_vec(rest)
    if has_soln:
        soln, rest = read_vec(rest)

    if block_dim is not None:
        b = int(block_dim)
        if b < 1:
            raise IOError_(f"{path}: block_dim must be >= 1, got {b}")
        if (block_dimx, block_dimy) not in ((1, 1), (b, b)):
            raise IOError_(
                f"{path}: file declares {block_dimx}x{block_dimy} "
                f"blocks; explicit block_dim={b} conflicts")
        if b > 1:
            bad = []
            if rows % b:
                bad.append(f"rows {rows} % {b} = {rows % b}")
            if cols % b:
                bad.append(f"cols {cols} % {b} = {cols % b}")
            if bad:
                raise IOError_(
                    f"{path}: cannot re-block a {rows}x{cols} scalar "
                    f"matrix into {b}x{b} blocks ({'; '.join(bad)})")
            A = sp.bsr_matrix(A, blocksize=(b, b))
        block_dimx = block_dimy = b

    return SystemData(A=A, rhs=rhs, solution=soln,
                      block_dimx=block_dimx, block_dimy=block_dimy)


def write_matrix_market(path: str, A: sp.spmatrix,
                        rhs: Optional[np.ndarray] = None,
                        solution: Optional[np.ndarray] = None,
                        block_dim: int = 1):
    """Write a system in the reference's extended MatrixMarket format
    (``MatrixIO::writeSystemMatrixMarket``, base/src/matrix_io.cu)."""
    A = sp.coo_matrix(A)
    is_complex = (np.iscomplexobj(A.data)
                  or (rhs is not None and np.iscomplexobj(rhs))
                  or (solution is not None
                      and np.iscomplexobj(solution)))
    field = "complex" if is_complex else "real"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        ext = []
        if block_dim != 1:
            ext.append(str(block_dim))
        if rhs is not None:
            ext.append("rhs")
        if solution is not None:
            ext.append("solution")
        if ext:
            f.write("%%AMGX " + " ".join(ext) + "\n")
        f.write(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n")
        if is_complex:
            data_c = A.data.astype(np.complex128)
            for i, j, v in zip(A.row, A.col, data_c):
                f.write(f"{i+1} {j+1} {v.real:.17g} {v.imag:.17g}\n")
        else:
            for i, j, v in zip(A.row, A.col, A.data):
                f.write(f"{i+1} {j+1} {v:.17g}\n")
        for vec in (rhs, solution):
            if vec is not None:
                vv = np.asarray(vec).ravel()
                if is_complex:
                    for v in vv.astype(np.complex128):
                        f.write(f"{v.real:.17g} {v.imag:.17g}\n")
                else:
                    for v in vv:
                        f.write(f"{v:.17g}\n")
