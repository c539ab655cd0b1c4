"""Poisson problem generators (port of the scalar part of
``amgx_tpu/io/poisson.py``): the CUSP gallery's 5/7-point Laplacians
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
