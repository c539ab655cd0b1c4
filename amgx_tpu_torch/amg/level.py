"""AMG levels (port of ``AMGLevel``, ``AggregationLevel``,
``PairwiseLevel``, ``StructuredLevel`` and ``ClassicalLevel`` of
``amgx_tpu/amg/level.py``; reference ``base/include/amg_level.h:73-238``).

The aggregation, pairwise and structured levels carry implicit
piecewise-constant transfers: restriction sums the fine values of each
aggregate, prolongation copies each coarse value back to its aggregate —
ordered elementwise adds, reshapes/strided sums and gathers, no matrix
product and no atomic scatter, so every sum runs in one order on every
device.  Classical levels carry explicit P and R packs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import Matrix
from ..ops.spmv import spmv


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
        """(rows, nnz) of this level; device-born classical levels report
        their LOGICAL rows (pad rows are not rows of the operator)."""
        return (getattr(self.A, "logical_rows", None) or self.Ad.n_rows,
                self.A.nnz)


def member_table(aggregates: np.ndarray, n_coarse: int) -> np.ndarray:
    """The (max aggregate size, n_coarse) int64 table of every
    aggregate's fine rows in increasing order, padded with the index n
    (a zero appended to the restricted vector)."""
    n = len(aggregates)
    order = np.argsort(aggregates, kind="stable")
    counts = np.bincount(aggregates, minlength=n_coarse)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    a_sorted = aggregates[order]
    pos = np.arange(n) - start[a_sorted]
    table = np.full((max(int(counts.max(initial=0)), 1), n_coarse), n,
                    dtype=np.int64)
    table[pos, a_sorted] = order
    return table


class AggregationLevel(AMGLevel):
    """Implicit piecewise-constant transfer over ``aggregates`` (scalar
    or b×b block systems; reference ``aggregation_amg_level.cu:115-196``).

    Restriction adds each aggregate's fine values in increasing fine
    index, one elementwise add per member slot over the table of
    :func:`member_table` built at setup — the JAX package's segment sum
    in the same order, without the card's atomic scatter-add, whose
    order changes from run to run.  Prolongation is a gather.  A block
    level works on ``(-1, b)`` views: an aggregate's block rows move
    together."""

    kind = "aggregation"

    def __init__(self, A: Matrix, level_index: int, aggregates: np.ndarray,
                 n_coarse: int):
        super().__init__(A, level_index)
        agg = np.asarray(aggregates, dtype=np.int64)
        self.n_coarse = int(n_coarse)
        self.block_dim = int(A.block_dim)
        dev = A.placement
        self.aggregates = torch.from_numpy(agg).to(dev)
        self.members = torch.from_numpy(member_table(agg, self.n_coarse)) \
            .to(dev)

    def restrict_residual(self, r):
        b = self.block_dim
        rb = r if b == 1 else r.reshape(-1, b)
        rp = torch.cat([rb, rb.new_zeros((1,) + rb.shape[1:])])
        out = rp[self.members[0]]
        for k in range(1, self.members.shape[0]):
            out = out + rp[self.members[k]]
        return out if b == 1 else out.reshape(-1)

    def prolongate_and_correct(self, x, e):
        if self.block_dim == 1:
            return x + e[self.aggregates]
        b = self.block_dim
        return x + e.reshape(-1, b)[self.aggregates].reshape(-1)


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


class ClassicalLevel(AMGLevel):
    """Explicit P/R transfers (classical AMG; reference
    ``classical_amg_level.cu``): restriction is ``R·r``, prolongation
    ``x + P·e``, each one SpMV.

    ``P``/``R`` are host :class:`Matrix` handles (host-built levels; their
    device packs are built on first use) or device packs (device-born
    levels: DIA at the embedded fine level, ELL below)."""

    kind = "classical"

    def __init__(self, A: Matrix, level_index: int, P, R, cf_map=None):
        super().__init__(A, level_index)
        self._P, self._R = P, R
        self.n_coarse = (P.n_block_cols if isinstance(P, Matrix)
                         else P.n_cols)
        self.cf_map = cf_map
        if cf_map is not None:
            # the C/F split where the level's smoother reads it
            # (CF_JACOBI, cf_jacobi_solver.cu)
            A.cf_map = cf_map

    @property
    def P(self):
        return self._P.device() if isinstance(self._P, Matrix) else self._P

    @property
    def R(self):
        return self._R.device() if isinstance(self._R, Matrix) else self._R

    def restrict_residual(self, r):
        return spmv(self.R, r)

    def prolongate_and_correct(self, x, e):
        return x + spmv(self.P, e)
