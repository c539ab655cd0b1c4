"""The pressure Poisson operator of the DFG "flow around a cylinder"
benchmark (Schäfer & Turek 1996, *Benchmark computations of laminar flow
around a cylinder*, cases 2D-1/2D-2), on a uniform cell-centred grid.

The channel is [0, 2.2] × [0, 0.41] with a cylinder of diameter 0.1
centred at (0.2, 0.2).  With ``h = 0.41/ny`` and ``nx = round(2.2/h)``,
a cell is dropped when its centre lies inside the cylinder, the active
cells are numbered x-fastest, and each row is the 5-point stencil: −1 to
each active neighbour and 4 on the diagonal (homogeneous Dirichlet
through ghost cells on every face, the cylinder's included).

Each blanked grid line shifts the north/south column differences by its
own chord width, so the matrix has many distinct global diagonals while a
tile of a few grid lines holds only a handful: the shape of operator the
tile-DIA shift pack (``ops/shift_spmv.py``) is made for.  Host scipy CSR,
uploaded through ``Matrix(csr)`` like any user matrix.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

#: channel length and height, cylinder centre and radius (DFG 2D-1/2D-2)
LENGTH, HEIGHT = 2.2, 0.41
CENTRE, RADIUS = (0.2, 0.2), 0.05


def dfg_cylinder_pressure(ny: int) -> sp.csr_matrix:
    """The DFG cylinder pressure Poisson matrix with ``ny`` cells across
    the channel (f64 CSR, sorted indices)."""
    h = HEIGHT / ny
    nx = int(round(LENGTH / h))
    xc = (np.arange(nx) + 0.5) * h
    yc = (np.arange(ny) + 0.5) * h
    inside = ((xc[None, :] - CENTRE[0]) ** 2
              + (yc[:, None] - CENTRE[1]) ** 2) < RADIUS ** 2
    active = ~inside
    idx = np.full((ny, nx), -1, dtype=np.int64)
    n = int(active.sum())
    idx[active] = np.arange(n)          # row-major over (y, x): x-fastest
    rows = [idx[active]]
    cols = [idx[active]]
    vals = [np.full(n, 4.0)]
    for dy, dx in ((-1, 0), (0, -1), (0, 1), (1, 0)):
        src = idx[max(0, -dy):ny - max(0, dy), max(0, -dx):nx - max(0, dx)]
        dst = idx[max(0, dy):ny - max(0, -dy), max(0, dx):nx - max(0, -dx)]
        keep = (src >= 0) & (dst >= 0)
        rows.append(src[keep])
        cols.append(dst[keep])
        vals.append(np.full(int(keep.sum()), -1.0))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    A.sort_indices()
    return A
