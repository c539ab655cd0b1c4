"""Fully-device classical setup of the fine (stencil) level (port of
``amgx_tpu/amg/classical/device_pipeline.py``; reference
``classical_amg_level.cu:240-340`` + ``csr_multiply.h:100-126``).

The P of :func:`.device_fine.fine_program` lives on the static Â
offsets, so every factor of ``Ac = Pᵀ·A·P`` is a diagonal-offset matrix
on the fine grid and the Galerkin product is static shift algebra
(:func:`~amgx_tpu_torch.ops.spgemm.dia_galerkin_fn`): the coarse
operator comes out in EMBEDDED form — coarse points keep their fine
indices; rows and columns off the C set are zero.

The embedded operator then serves twice: the solve applies level 1 as
the composition R·(A·(P·x)) of three DIA packs (kernel B1 on the card),
and the next setup level compacts it to coarse-local ELL
(:func:`coarsen_fine_embedded`'s ``cols``/``vals``) for
:mod:`.device_coarse`.  Shapes are padded as in the JAX package
(:func:`bucket`, :func:`width_bucket`), so every level compares 1:1;
pad rows carry a unit diagonal.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ...device import to_host
from ...ops.ordered import sum_along
from ...ops.spgemm import dia_galerkin_fn, top_k
from ...ops.spgemm import shift as _shift
from .device_fine import fine_program


def fine_slots(vals: torch.Tensor, offs: Sequence[int], n: int, **params):
    """(cf bool, P_rows (nh, n), hat_offs): the full-slot DIA form of P on
    the Â offsets (slot of offset 0 = the C-point identity row) —
    ``_fine_slots_fn`` upstream."""
    cf, pv, pi, hat_offs = fine_program(vals, offs, n, **params)
    dt = vals.dtype
    nh = len(hat_offs)
    h0 = hat_offs.index(0)
    ho = [e_i for e_i in range(nh) if e_i != h0]
    zero = torch.zeros(n, dtype=dt, device=vals.device)
    rows = []
    for e_i in range(nh):
        if e_i == h0:
            rows.append(torch.where(cf, 1.0, zero))
            continue
        # scatter the ≤Kp kept weights back to their Â-offset slot
        s_idx = ho.index(e_i)
        acc = zero
        for s in range(pv.shape[1]):
            acc = acc + torch.where(pi[:, s] == s_idx, pv[:, s], zero)
        rows.append(acc)
    return cf, torch.stack(rows), hat_offs


def level_arrays(Ac: torch.Tensor, P_rows: torch.Tensor, cf: torch.Tensor,
                 kept, delta_offs, p_offs, n: int):
    """(A1 (Dk, n), diag, dinv, l1row, R_rows (np, n), cnum (n,) int32) —
    ``_level_arrays_fn`` upstream.  ``R = Pᵀ`` of a DIA matrix is DIA
    again: offset −o with values ``shift(P_o, −o)``."""
    kept = list(kept)
    A1 = Ac if kept == list(range(Ac.shape[0])) else \
        Ac[torch.as_tensor(kept, dtype=torch.int64, device=Ac.device)]
    z = delta_offs.index(0)
    diag = A1[kept.index(z)] if z in kept else \
        torch.zeros(n, dtype=Ac.dtype, device=Ac.device)
    dinv = torch.where(diag != 0,
                       1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
    l1row = sum_along(torch.abs(A1), 0)
    R_rows = torch.stack([_shift(P_rows[pi], -int(p_offs[pi]))
                          for pi in range(len(p_offs))])
    cnum = (torch.cumsum(cf.to(torch.int32), 0) - 1).to(torch.int32)
    return A1, diag, dinv, l1row, R_rows, cnum


def compact(A1: torch.Tensor, cnum: torch.Tensor, cf: torch.Tensor,
            nc: int, kept_offs, n: int, ncb: int, Kb: int):
    """(foc (ncb,) int32, cols (ncb, Kb) int32 coarse-local, vals
    (ncb, Kb)) — ``_compact_fn`` upstream.

    Row compaction by one sort (C rows keep fine order = coarse
    numbering order); width compaction by a stable top-k over the kept
    diagonal slots.  Pad rows beyond nc carry a unit diagonal."""
    dev = A1.device
    Dk = len(kept_offs)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    key = torch.where(cf, iota, n).to(torch.int32)
    foc = torch.sort(key).values[:ncb]                 # (ncb,) pad = n
    valid = torch.arange(ncb, dtype=torch.int32, device=dev) < nc
    focc = torch.clamp(foc, max=n - 1).long()
    # the coarse-local column of slot j is cnum at focc + d_j (−1 past
    # the grid): the same as gathering the shifted cnum rows upstream
    d = torch.as_tensor([int(o) for o in kept_offs], dtype=torch.int64,
                        device=dev)
    src = focc[:, None] + d[None, :]
    inside = (src >= 0) & (src < n)
    cw = torch.where(inside, cnum[src.clamp(0, n - 1)], -1)
    vw = A1[:, focc].T                                  # (ncb, Dk)
    live = (vw != 0) & (cw >= 0) & valid[:, None]
    # top-k by (live, low slot): key = live·2·Dk − slot (all distinct)
    slot = torch.arange(Dk, dtype=torch.int32, device=dev)
    kkey = torch.where(live, 2 * Dk - slot, -slot)
    _, topi = top_k(kkey, min(Kb, Dk))
    cols = torch.gather(cw, 1, topi)
    vals = torch.gather(vw, 1, topi)
    live_k = torch.gather(live, 1, topi)
    if Kb > Dk:
        pad = (0, Kb - Dk)
        cols = torch.nn.functional.pad(cols, pad)
        vals = torch.nn.functional.pad(vals, pad)
        live_k = torch.nn.functional.pad(live_k, pad)
    rown = torch.arange(ncb, dtype=torch.int32, device=dev)[:, None]
    cols = torch.where(live_k, cols, rown).to(torch.int32)   # self pad
    vals = torch.where(live_k, vals, 0.0)
    # identity diagonal on pad rows: isolated F points downstream
    first = torch.arange(Kb, device=dev) == 0
    vals = torch.where((~valid[:, None]) & first, 1.0, vals)
    return foc, cols, vals


def bucket(x: int, step: int = 8192) -> int:
    """Round up to the shape bucket."""
    return max(step, -(-int(x) // step) * step)


def width_bucket(k: int) -> int:
    for b in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        if k <= b:
            return b
    return int(k)


class EmbeddedFineResult:
    """Device arrays of one embedded fine-level coarsening; everything
    stays on the device except the scalars."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def coarsen_fine_embedded(offs: Sequence[int], dvals: torch.Tensor, n: int,
                          *, theta: float, max_row_sum: float,
                          strength_all: bool, interp_d2: bool,
                          trunc_factor: float, max_elements: int, seed: int,
                          compact_step: int = 2048):
    """Run the fully-device fine-level classical coarsening.

    Returns an :class:`EmbeddedFineResult` (or None when the coarse grid
    degenerates): embedded A1/P/R DIA arrays for the solve, plus the
    compact coarse-local ELL for the next setup level."""
    offs = tuple(int(o) for o in offs)
    dt = dvals.dtype
    cf, P_rows, p_offs = fine_slots(
        dvals, offs, n, theta=float(theta), max_row_sum=float(max_row_sum),
        strength_all=bool(strength_all), interp_d2=bool(interp_d2),
        trunc_factor=float(trunc_factor), max_elements=int(max_elements),
        seed=int(seed))
    rap, delta = dia_galerkin_fn(offs, p_offs, n, dt)
    Ac, realized, nc_d, kmax_d = rap(dvals, P_rows, cf)
    realized, nc, kmax = to_host(realized, nc_d, kmax_d)
    nc, kmax = int(nc), int(kmax)
    if nc == 0 or nc >= n:
        return None
    kept = tuple(int(i) for i in np.flatnonzero(realized))
    if not kept:
        return None
    kept_offs = tuple(int(delta[i]) for i in kept)
    A1, diag, dinv, l1row, R_rows, cnum = level_arrays(
        Ac, P_rows, cf, kept, delta, p_offs, n)
    del Ac
    # a bucket larger than the fine grid would make foc shorter than its
    # shape — clamp to n (still ≥ nc)
    ncb = min(bucket(nc, compact_step), n)
    Kb = width_bucket(kmax)
    foc, ccols, cvals = compact(A1, cnum, cf, nc, kept_offs, n, ncb, Kb)
    return EmbeddedFineResult(
        p_offs=p_offs, P_rows=P_rows, R_rows=R_rows,
        a_offs=kept_offs, A_vals=A1, diag=diag, dinv=dinv,
        l1row=l1row, cf=cf, cnum=cnum, nc=nc, kmax=kmax,
        foc=foc, cols=ccols, vals=cvals, ncb=ncb, Kb=Kb)

