"""Structured (grid-aware) GEO aggregation helpers — host numpy
(port of ``amgx_tpu/amg/structured.py``).

For stencil matrices on an (nz, ny, nx) grid the hierarchy aggregates
full 2×2×2 cells, so a 7-point operator stays 7-point on every coarse
level.  These functions decode flat diagonal offsets into stencil
triples, check that no coupling wraps around the grid, and infer grid
dims from the offsets.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Dims = Tuple[int, int, int]          # (nz, ny, nx)
Off3 = Tuple[int, int, int]          # (dz, dy, dx)


def _sym_mod(v: int, m: int) -> int:
    """Symmetric remainder of v mod m in (-m/2, m/2]."""
    r = v % m
    if r > m // 2:
        r -= m
    return r


def decompose_offsets(offsets: Sequence[int], dims: Dims,
                      max_extent: int = 3) -> Optional[List[Off3]]:
    """Split flat offsets d = dz·ny·nx + dy·nx + dx into stencil triples
    with minimal per-axis extent; None when an offset is not a local
    stencil move or its decode is ambiguous (2·|d_axis| ≥ axis extent)."""
    nz, ny, nx = dims
    out: List[Off3] = []
    for d in offsets:
        dx = _sym_mod(d, nx) if nx > 1 else 0
        rem = (d - dx) // nx if nx > 1 else d
        dy = _sym_mod(rem, ny) if ny > 1 else 0
        dz = (rem - dy) // ny if ny > 1 else rem
        if max(abs(dx), abs(dy), abs(dz)) > max_extent:
            return None
        if (nx > 1 and dx and 2 * abs(dx) >= nx) or \
           (ny > 1 and dy and 2 * abs(dy) >= ny) or \
           (dz and abs(dz) >= nz):
            return None
        out.append((dz, dy, dx))
    return out


def stencil_values_consistent(offsets3: List[Off3], vals: np.ndarray,
                              dims: Dims) -> bool:
    """A decoded stencil move that leaves the grid must sit on zero
    values everywhere (periodic/wrap couplings fail this)."""
    nz, ny, nx = dims
    for k, (dz, dy, dx) in enumerate(offsets3):
        V = vals[k].reshape(nz, ny, nx)
        for axis, d, size in ((0, dz, nz), (1, dy, ny), (2, dx, nx)):
            if d == 0:
                continue
            sl = [slice(None)] * 3
            sl[axis] = slice(size - d, None) if d > 0 else slice(0, -d)
            if np.any(V[tuple(sl)]):
                return False
    return True


def infer_grid_dims(offsets: Sequence[int], n: int) -> Optional[Dims]:
    """Guess (nz, ny, nx) from a stencil's flat offsets (symmetric
    5/7/9/27-point families); None when no factorisation decodes every
    offset."""
    pos = sorted(o for o in offsets if o > 0)
    if not pos or pos[0] > 2:
        return None

    def valid(dims) -> bool:
        nz, ny, nx = dims
        return (nz * ny * nx == n
                and decompose_offsets(offsets, dims) is not None)

    for sy in (a for a in pos if a > 2 and n % a == 0):
        for sz in (b for b in pos
                   if b > 2 * sy and b % sy == 0 and n % b == 0):
            if valid((n // sz, sz // sy, sy)):
                return (n // sz, sz // sy, sy)
        if valid((1, n // sy, sy)):
            return (1, n // sy, sy)
    if valid((1, 1, n)):
        return (1, 1, n)
    return None


def coarse_dims(dims: Dims) -> Dims:
    """Halve every dim > 1 (ceil), leave singleton dims alone."""
    return tuple((d + 1) // 2 if d > 1 else 1 for d in dims)
