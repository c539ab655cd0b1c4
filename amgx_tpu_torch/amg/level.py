"""AMG levels (port of ``AMGLevel``, ``PairwiseLevel`` and
``StructuredLevel`` of ``amgx_tpu/amg/level.py``; reference
``base/include/amg_level.h:73-238``).

Both level kinds carry implicit piecewise-constant transfers: restriction
sums the fine values of each aggregate, prolongation copies each coarse
value back to its aggregate.  Both are exact reshapes/strided sums and
``repeat_interleave`` copies — no matrix product, so no TF32 rounding on
the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import Matrix


class AMGLevel:
    kind = "?"

    def __init__(self, A: Matrix, level_index: int):
        self.A = A
        self.level_index = level_index
        self.smoother = None

    @property
    def Ad(self):
        return self.A.device()

    def restrict_residual(self, r: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def prolongate_and_correct(self, x: torch.Tensor,
                               e: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def level_stats(self) -> tuple:
        """(rows, nnz) of this level."""
        return (self.Ad.n_rows, self.A.nnz)


class PairwiseLevel(AMGLevel):
    """Strict index-order pairing {2I, 2I+1} (GEO fast path without grid
    geometry)."""

    kind = "pairwise"

    def __init__(self, A: Matrix, level_index: int, n_fine: int):
        super().__init__(A, level_index)
        self.n_fine = int(n_fine)
        self.n_coarse = (self.n_fine + 1) // 2

    def restrict_residual(self, r):
        if self.n_fine % 2:
            r = torch.nn.functional.pad(r, (0, 1))
        return r.reshape(self.n_coarse, 2).sum(dim=1)

    def prolongate_and_correct(self, x, e):
        return x + e.repeat_interleave(2)[:self.n_fine]


class StructuredLevel(AMGLevel):
    """Isotropic 2×2×2 cell aggregation on an (nz, ny, nx) grid (GEO
    selector with grid geometry)."""

    kind = "structured"

    def __init__(self, A: Matrix, level_index: int, dims, cdims):
        super().__init__(A, level_index)
        self.dims = tuple(int(d) for d in dims)
        self.cdims = tuple(int(d) for d in cdims)
        self.n_fine = int(np.prod(self.dims))
        self.n_coarse = int(np.prod(self.cdims))
        # per-axis aggregation factor (2 where coarsened, 1 on singletons)
        self._f = tuple(2 if c < d or d > 1 else 1
                        for d, c in zip(self.dims, self.cdims))
        self._pad = tuple(c * f for c, f in zip(self.cdims, self._f))

    def restrict_residual(self, r):
        nz, ny, nx = self.dims
        pz, py, px = self._pad
        r3 = r.reshape(nz, ny, nx)
        if (pz, py, px) != (nz, ny, nx):
            r3 = torch.nn.functional.pad(
                r3, (0, px - nx, 0, py - ny, 0, pz - nz))
        if self._f[0] == 2:
            r3 = r3[0::2] + r3[1::2]
        if self._f[1] == 2:
            r3 = r3[:, 0::2] + r3[:, 1::2]
        if self._f[2] == 2:
            r3 = r3[:, :, 0::2] + r3[:, :, 1::2]
        return r3.reshape(-1)

    def prolongate_and_correct(self, x, e):
        nz, ny, nx = self.dims
        e3 = e.reshape(self.cdims)
        for axis in (2, 1, 0):
            if self._f[axis] == 2:
                e3 = e3.repeat_interleave(2, dim=axis)
        return x + e3[:nz, :ny, :nx].reshape(-1)
