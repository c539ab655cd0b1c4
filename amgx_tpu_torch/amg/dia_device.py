"""Device-side DIA hierarchy derivation (port of
``amgx_tpu/amg/dia_device.py``; reference analog: the on-accelerator
setup loop ``amg.cu:177-450`` with device Galerkin products).

For a stencil hierarchy the *structure* of every coarse level is a pure
function of the fine offsets and grid dims:

* **plan** (host, no values): the per-level coarsening decisions —
  structured 2×2×2 cells vs 1D pairing, coarse offset sets,
  termination — exactly as the JAX package plans them;
* **derive** (device): every coarse level's diagonal values, main
  diagonal and inverted diagonal from the fine values by strided adds.

The structured Galerkin is written as strided slab adds in the
accumulation order of ``_structured_coarse_offsets`` (the JAX package
expresses the same sum as a stride-2 convolution; a float32 convolution
on the card would run in TF32 by default, which keeps about three
digits — the adds are exact for stencil values and need no precision
switch).
"""
from __future__ import annotations

import dataclasses
from itertools import product
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .structured import Dims, Off3, coarse_dims, decompose_offsets

#: DIA diagonal budget shared with ``Matrix.device`` — a planned level
#: that would exceed it ends the plan
DIA_MAX_DIAGS = 48


@dataclasses.dataclass(frozen=True)
class StructuredStep:
    """One isotropic 2×2×2 coarsening step (plan record)."""
    kind = "structured"
    offsets: Tuple[int, ...]          # fine flat offsets
    offsets3: Tuple[Off3, ...]        # their decoded (dz, dy, dx) triples
    dims: Dims
    cdims: Dims
    c_offsets: Tuple[int, ...]        # coarse flat offsets (sorted)
    c_offsets3: Tuple[Off3, ...]      # their triples (for the next step)


@dataclasses.dataclass(frozen=True)
class PairwiseStep:
    """One strict index-pairing {2I, 2I+1} step (plan record)."""
    kind = "pairwise"
    offsets: Tuple[int, ...]
    n: int
    c_offsets: Tuple[int, ...]

    @property
    def nc(self):
        return (self.n + 1) // 2


def _structured_coarse_offsets(offsets3: Sequence[Off3], dims: Dims):
    """Static replay of the structured Galerkin's accumulation keys:
    (sorted flat coarse offsets, their triples, the per-tuple term lists
    in first-occurrence order, the per-flat tuple lists)."""
    nz, ny, nx = dims
    cz, cy, cx = coarse_dims(dims)
    rz_range = (0, 1) if nz > 1 else (0,)
    ry_range = (0, 1) if ny > 1 else (0,)
    rx_range = (0, 1) if nx > 1 else (0,)
    acc: dict = {}                     # tuple o -> [(k, (rz,ry,rx)), ...]
    for k, (dz, dy, dx) in enumerate(offsets3):
        for rz, ry, rx in product(rz_range, ry_range, rx_range):
            o = ((dz + rz) >> 1 if nz > 1 else dz,
                 (dy + ry) >> 1 if ny > 1 else dy,
                 (dx + rx) >> 1 if nx > 1 else dx)
            acc.setdefault(o, []).append((k, (rz, ry, rx)))
    flat_terms: dict = {}              # flat -> [tuple o, ...] in acc order
    flat_tuple: dict = {}
    for o in acc:
        dz, dy, dx = o
        flat = (dz * cy + dy) * cx + dx
        flat_terms.setdefault(flat, []).append(o)
        flat_tuple.setdefault(flat, o)
    flat_sorted = sorted(flat_terms)
    trips = tuple(flat_tuple[f] for f in flat_sorted)
    return flat_sorted, trips, acc, flat_terms


def _pairwise_coarse_offsets(offsets: Sequence[int]):
    """Static replay of the pairwise Galerkin's coarse offset set."""
    seen = []
    for d in offsets:
        for r in (0, 1):
            o = (d + r) >> 1
            if o not in seen:
                seen.append(o)
    return sorted(seen)


def plan_dia_hierarchy(offsets: Sequence[int], n: int,
                       dims: Optional[Dims],
                       max_levels: int, min_coarse_rows: int,
                       coarsen_threshold: float,
                       existing_levels: int = 0):
    """Statically derive the DIA coarsening plan from structure alone:
    structured 2×2×2 while the grid dims are known and the offsets
    decompose, 1D pairing otherwise; stop on max_levels /
    min_coarse_rows / the coarsening-rate guard / the DIA budget.

    Returns (steps, bailed): ``bailed`` is True when the plan ended on
    the diagonal budget rather than a genuine termination."""
    steps: List = []
    offsets = tuple(int(o) for o in offsets)
    offsets3 = None
    if dims is not None:
        offsets3 = decompose_offsets(offsets, dims)
        if offsets3 is not None:
            offsets3 = tuple(offsets3)
    while True:
        n_levels = existing_levels + len(steps)
        if n_levels + 1 >= max_levels or n <= min_coarse_rows:
            return steps, False
        if dims is not None and offsets3 is not None and max(dims) > 1:
            cdims = coarse_dims(dims)
            nc = int(np.prod(cdims))
            if nc >= n:
                return steps, False
            flat, trips, _, _ = _structured_coarse_offsets(offsets3, dims)
            if len(flat) > DIA_MAX_DIAGS:
                return steps, True
            if nc >= coarsen_threshold * n or nc == 0:
                return steps, False
            steps.append(StructuredStep(
                offsets=offsets, offsets3=offsets3, dims=dims,
                cdims=cdims, c_offsets=tuple(flat), c_offsets3=trips))
            offsets, offsets3, dims, n = tuple(flat), trips, cdims, nc
        else:
            nc = (n + 1) // 2
            c_offs = _pairwise_coarse_offsets(offsets)
            if len(c_offs) > DIA_MAX_DIAGS:
                return steps, True
            if nc >= coarsen_threshold * n or nc >= n or nc == 0:
                return steps, False
            steps.append(PairwiseStep(offsets=offsets, n=n,
                                      c_offsets=tuple(c_offs)))
            offsets, dims, offsets3, n = tuple(c_offs), None, None, nc


# ---------------------------------------------------------------- numerics
def _structured_galerkin(step: StructuredStep,
                         vals: torch.Tensor) -> torch.Tensor:
    """Structured Galerkin: ``A_c[(d+r)>>1] += A[d]`` at cell parity r,
    as strided slab adds over the zero-padded (nd, z, y, x) planes."""
    nz, ny, nx = step.dims
    cz, cy, cx = step.cdims
    pz, py, px = (2 * cz if nz > 1 else 1, 2 * cy if ny > 1 else 1,
                  2 * cx if nx > 1 else 1)
    nd = len(step.offsets3)
    V = vals.reshape(nd, nz, ny, nx)
    if (pz, py, px) != (nz, ny, nx):
        V = torch.nn.functional.pad(V, (0, px - nx, 0, py - ny, 0, pz - nz))
    _, _, acc_terms, flat_terms = _structured_coarse_offsets(
        step.offsets3, step.dims)
    rows = []
    for flat in sorted(flat_terms):
        total = None
        for o in flat_terms[flat]:
            buf = None
            for k, (rz, ry, rx) in acc_terms[o]:
                slab = V[k, rz::2, ry::2, rx::2]
                buf = slab.clone() if buf is None else buf + slab
            total = buf if total is None else total + buf
        rows.append(total.reshape(-1))
    return torch.stack(rows)


def _pairwise_galerkin(step: PairwiseStep,
                       vals: torch.Tensor) -> torch.Tensor:
    """Pairwise Galerkin: ``A_c[(d+r)>>1, I] += A[d, 2I+r]``."""
    nc = step.nc
    coarse = {}
    for k, d in enumerate(step.offsets):
        for r in (0, 1):
            o = (d + r) >> 1
            row_vals = vals[k, r::2]
            if row_vals.shape[0] < nc:
                row_vals = torch.nn.functional.pad(
                    row_vals, (0, nc - row_vals.shape[0]))
            buf = coarse.get(o)
            coarse[o] = row_vals.clone() if buf is None else buf + row_vals
    return torch.stack([coarse[o] for o in sorted(coarse)])


def _diag_dinv(offsets: Tuple[int, ...], vals: torch.Tensor):
    """(main diagonal, inverted diagonal) rows of a DIA value array."""
    if 0 in offsets:
        diag = vals[offsets.index(0)]
    else:
        diag = torch.zeros(vals.shape[1], dtype=vals.dtype,
                           device=vals.device)
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    dinv = torch.where(diag != 0, 1.0 / safe, torch.zeros_like(diag))
    return diag, dinv


def derive_hierarchy_device(steps, fine_offsets, vals_fine: torch.Tensor):
    """Fine DIA values → every level's (coarse vals, diag, dinv) plus the
    fine level's (diag, dinv), on the values' device:
    ``[(diag_f, dinv_f), (vals_1, diag_1, dinv_1), ...]``."""
    fine_offsets = tuple(int(o) for o in fine_offsets)
    outs = [_diag_dinv(fine_offsets, vals_fine)]
    v = vals_fine
    for st in steps:
        if st.kind == "structured":
            v = _structured_galerkin(st, v)
        else:
            v = _pairwise_galerkin(st, v)
        outs.append((v,) + _diag_dinv(tuple(st.c_offsets), v))
    return outs
