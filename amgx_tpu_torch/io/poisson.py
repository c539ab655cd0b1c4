"""Poisson problem generators (port of the scalar part of
``amgx_tpu/io/poisson.py``): the CUSP gallery's 5/7/9/27-point Laplacians
(``base/include/cusp/gallery/poisson.h``) as host scipy CSR, and the
canonical analytic DIA arrays of the 7-point operator.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _laplace_1d(n: int) -> sp.csr_matrix:
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")


def _eye(n):
    return sp.identity(n, format="csr")


def poisson5pt(nx: int, ny: int) -> sp.csr_matrix:
    """2D 5-point Laplacian on an nx×ny grid."""
    return (sp.kron(_eye(ny), _laplace_1d(nx)) +
            sp.kron(_laplace_1d(ny), _eye(nx))).tocsr()


def poisson7pt_offsets(nx: int, ny: int, nz: int):
    """THE canonical 7-pt diagonal order: ``[(flat offset, kept)]``;
    ``kept`` is False for the all-zero diagonals of a size-1 axis.  The
    host arrays and the device generator follow this order row for
    row."""
    return [(-nx * ny, nz > 1), (-nx, ny > 1), (-1, nx > 1), (0, True),
            (1, nx > 1), (nx, ny > 1), (nx * ny, nz > 1)]


def poisson7pt_dia(nx: int, ny: int, nz: int):
    """Analytic row-aligned DIA arrays ``(offsets, vals)`` (f64) of the
    3D 7-point Laplacian, degenerate-axis diagonals dropped."""
    n = nx * ny * nz
    X = np.tile(np.arange(nx), ny * nz)
    Y = np.tile(np.repeat(np.arange(ny), nx), nz)
    Z = np.repeat(np.arange(nz), nx * ny)
    vals = np.empty((7, n), dtype=np.float64)
    vals[0] = np.where(Z > 0, -1.0, 0.0)
    vals[1] = np.where(Y > 0, -1.0, 0.0)
    vals[2] = np.where(X > 0, -1.0, 0.0)
    vals[3] = 6.0
    vals[4] = np.where(X < nx - 1, -1.0, 0.0)
    vals[5] = np.where(Y < ny - 1, -1.0, 0.0)
    vals[6] = np.where(Z < nz - 1, -1.0, 0.0)
    spec = poisson7pt_offsets(nx, ny, nz)
    keep = [k for k, (o, kept) in enumerate(spec) if kept]
    return [spec[k][0] for k in keep], vals[keep]


def poisson7pt(nx: int, ny: int, nz: int) -> sp.csr_matrix:
    """3D 7-point Laplacian on an nx×ny×nz grid (BASELINE.md configs 2-3).
    The CSR carries its analytic diagonals as ``A._amgx_dia`` and its
    grid as ``A._amgx_grid_dims``, which :class:`Matrix` adopts."""
    n = nx * ny * nz
    offsets, vals = poisson7pt_dia(nx, ny, nz)
    from ..amg.pairwise import dia_to_scipy
    A = dia_to_scipy(offsets, vals, n)
    A._amgx_dia = (offsets, vals)
    A._amgx_grid_dims = (nz, ny, nx)
    return A


def poisson9pt(nx: int, ny: int) -> sp.csr_matrix:
    """2D 9-point stencil (8 neighbours + center)."""
    n = nx * ny
    ii, jj, vv = [], [], []
    idx = lambda x, y: y * nx + x
    for y in range(ny):
        for x in range(nx):
            r = idx(x, y)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    X, Y = x + dx, y + dy
                    if 0 <= X < nx and 0 <= Y < ny:
                        ii.append(r)
                        jj.append(idx(X, Y))
                        vv.append(8.0 if (dx == 0 and dy == 0) else -1.0)
    return sp.csr_matrix((vv, (ii, jj)), shape=(n, n))


def poisson27pt(nx: int, ny: int, nz: int) -> sp.csr_matrix:
    """3D 27-point stencil."""
    n = nx * ny * nz
    idx3 = lambda x, y, z: (z * ny + y) * nx + x
    ii, jj, vv = [], [], []
    X, Y, Z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    X, Y, Z = X.ravel(), Y.ravel(), Z.ravel()
    rows = idx3(X, Y, Z)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                Xn, Yn, Zn = X + dx, Y + dy, Z + dz
                ok = ((0 <= Xn) & (Xn < nx) & (0 <= Yn) & (Yn < ny) &
                      (0 <= Zn) & (Zn < nz))
                ii.append(rows[ok])
                jj.append(idx3(Xn[ok], Yn[ok], Zn[ok]))
                center = (dx == 0 and dy == 0 and dz == 0)
                vv.append(np.full(ok.sum(), 26.0 if center else -1.0))
    return sp.csr_matrix(
        (np.concatenate(vv), (np.concatenate(ii), np.concatenate(jj))),
        shape=(n, n))


def generate_distributed_poisson_7pt(nx: int, ny: int, nz: int,
                                     px: int = 1, py: int = 1, pz: int = 1):
    """The global 7-point Poisson and its partition vector for a
    px×py×pz processor grid over the (nx·px, ny·py, nz·pz) global grid
    (``AMGX_generate_distributed_poisson_7pt``; port of
    ``amgx_tpu/io/poisson.py:124-153``): each rank owns an nx×ny×nz
    brick and rows are numbered rank-contiguously (the renumbered layout
    of ``generate_poisson7_dist_renum.cu``).  Returns
    ``(A_global_csr, partition_vector)``."""
    gx, gy, gz = nx * px, ny * py, nz * pz
    n = gx * gy * gz
    X, Y, Z = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                          indexing="ij")
    X, Y, Z = X.ravel(), Y.ravel(), Z.ravel()
    lex = (Z * gy + Y) * gx + X
    rank = (Z // nz) * (px * py) + (Y // ny) * px + (X // nx)
    local = ((Z % nz) * ny + (Y % ny)) * nx + (X % nx)
    per_rank = nx * ny * nz
    perm = np.empty(n, dtype=np.int64)
    perm[lex] = rank * per_rank + local
    A = poisson7pt(gx, gy, gz)
    P = sp.csr_matrix((np.ones(n), (perm, np.arange(n))), shape=(n, n))
    A_renum = (P @ A @ P.T).tocsr()
    partition = np.repeat(np.arange(px * py * pz), per_rank)
    return A_renum, partition
