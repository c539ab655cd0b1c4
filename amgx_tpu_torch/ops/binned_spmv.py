"""Binned sliced-ELL SpMV: the host pack, the hand-written Hopper kernels
B4 (scalar) and B5 (block-native) and their plain versions.

Replaces ``amgx_tpu/ops/pallas_csr.py::_binned_call`` (B4,
``pl.pallas_call`` at :384) and ``_binned_block_call`` (B5, at :497).
The kernels are ``csrc/binned_spmv.cu``; see its header for the bound
and the design.

The host pack (:func:`csr_binned_pack`, with :func:`_bin_ids`,
:func:`_plan`, :func:`binned_pad_factor` and :func:`bn_block_dim`) is a
copy of the JAX package's and gives bit-equal arrays:

* rows are bucketed into power-of-two degree bins and permuted so each
  tile of T = 128 rows holds rows of near-uniform degree;
* the column space is cut into segments of SB·128 = 1024 columns; each
  (tile, segment) group's entries are laid out in chunks of W = 8 slot
  columns × 128 lanes, ``lane = chunk·1024 + slot·128 + row mod 128``;
* ``bn_codes`` (1, L) int32 holds the global (block) column of every
  lane, ``bn_vals`` its value — (1, L) for scalar packs, (b², L)
  component planes (row a·b+c = block component (a, c)) for block-native
  packs; padding lanes carry code 0 and value 0;
* ``bn_meta`` (4·C,) int32 holds per chunk its output tile, plane block,
  segment and first-chunk-of-tile flag (chunks are tile-sorted; a tile
  with no entries gets one dummy chunk on a shared zero block);
* ``bn_pos`` (n,) int32 maps an original row to its padded position
  (absent when the bin permutation is the identity).

The card does not need the segments (it gathers x directly), and
neither kernel reads a lane of the planes: every binned pack carries a
compact pack (:class:`CompactPack`, :func:`compact_pack`) derived from
them on its device at upload, which holds each row's real entries
(blocks) only, in slices of ``32 // b`` rows padded to the slice's
longest row; the kernels write each row through the inverse of
``bn_pos`` (:func:`kernel_aux`).

Contract of both kernels: ``y = A·x`` for the pack, summed per chunk over
its 8 slots in slot order and over the tile's chunks in chunk order,
kept over the real entries alone, which gives the planes' bits for
finite x (:func:`compact_pack`).  B4 (b = 1) takes (vals, x) pairs (f32,
f32) and (f64, f64); B5 (b ∈ {2, 3, 4, 5}) takes (f32, f32), (bf16, f32)
and (f64, f64), accumulating in x's type.  :func:`binned_spmv` runs a
plain version (:func:`binned_spmv_reference` over the planes for B4,
:func:`binned_compact_reference` for B5) only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import host_scalar
from ..errors import BadParametersError, DeviceError

#: rows per tile
_T = 128
#: x-segment size in 128-lane blocks (segment = _SB·128 columns)
_SB = 8
#: slot-columns per chunk plane (plane = _W·_T lanes)
_W = 8
#: refuse the pack when padded lanes exceed this × nnz
_PAD_CAP = 10.0
#: never refuse tiny matrices on the ratio alone
_PAD_FLOOR = 1 << 16

#: kernel type codes (``TypeCode`` in csrc/binned_spmv.cu)
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_SHORT = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16"}
#: (vals, x) type pairs of B4 (scalar packs) and B5 (block-native packs)
SUPPORTED_SCALAR = ((torch.float32, torch.float32),
                    (torch.float64, torch.float64))
SUPPORTED_BLOCK = ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.float32),
                   (torch.float64, torch.float64))

#: kernel launches per kernel and (vals, x) type pair, e.g.
#: ``LAUNCHES["B5"]["f32.f32"]`` — counted where a kernel is launched and
#: nowhere else; ``"B5-stacked"`` counts B5 over the stacked interior of
#: a b×b sharded pack (:func:`compact_spmv`)
LAUNCHES: Dict[str, Dict[str, int]] = {
    "B4": {f"{_SHORT[v]}.{_SHORT[x]}": 0 for v, x in SUPPORTED_SCALAR},
    "B5": {f"{_SHORT[v]}.{_SHORT[x]}": 0 for v, x in SUPPORTED_BLOCK},
    "B5-stacked": {f"{_SHORT[v]}.{_SHORT[x]}": 0
                   for v, x in SUPPORTED_BLOCK},
}

_fn = None


def launch_count(kernel: Optional[str] = None) -> int:
    """Kernel launches since the last :func:`reset_launches` (of ``"B4"``
    or ``"B5"``, or of both)."""
    keys = (kernel,) if kernel else tuple(LAUNCHES)
    return sum(sum(LAUNCHES[k].values()) for k in keys)


def reset_launches() -> None:
    for per in LAUNCHES.values():
        for k in per:
            per[k] = 0


# --------------------------------------------------------------------------
# host pack (copied from amgx_tpu/ops/pallas_csr.py:88-278)
# --------------------------------------------------------------------------

def _bin_ids(deg: np.ndarray) -> np.ndarray:
    """Power-of-two nnz bin per row (deg 0 and 1 share bin 0)."""
    bid = np.zeros(len(deg), dtype=np.int64)
    nz = deg > 1
    bid[nz] = np.ceil(np.log2(deg[nz])).astype(np.int64)
    return bid


def _plan(indptr: np.ndarray, indices: np.ndarray, n_cols: int):
    """The layout plan shared by the packer and the budget probe: None
    for an empty matrix, else everything short of the planes."""
    n = len(indptr) - 1
    nnz = len(indices)
    if n == 0 or nnz == 0:
        return None
    deg = np.diff(indptr).astype(np.int64)
    bid = _bin_ids(deg)
    # a stable sort groups rows by bin and keeps upload order inside a
    # bin; an already-sorted degree profile keeps the identity
    identity = bool(np.all(bid[1:] >= bid[:-1]))
    perm = np.arange(n, dtype=np.int64) if identity else \
        np.argsort(bid, kind="stable")
    deg_p = deg[perm]
    indptr_p = np.concatenate([[0], np.cumsum(deg_p)])
    rows_p = np.repeat(np.arange(n, dtype=np.int64), deg_p)
    # entry source index: permuted-row-major, column-sorted within rows
    ent = np.repeat(indptr[perm].astype(np.int64) - indptr_p[:-1],
                    deg_p) + np.arange(nnz, dtype=np.int64)
    S = _SB * 128
    n_seg = max(1, -(-int(n_cols) // S))
    seg = indices[ent].astype(np.int64) // S
    tile = rows_p // _T
    n_tiles = -(-n // _T)
    # (row, segment) runs are contiguous; a run's length is the row's
    # entry count in that segment
    start = np.ones(nnz, dtype=bool)
    start[1:] = (rows_p[1:] != rows_p[:-1]) | (seg[1:] != seg[:-1])
    run_first = np.flatnonzero(start)
    run_id = np.cumsum(start) - 1
    q = np.arange(nnz, dtype=np.int64) - run_first[run_id]
    run_len = np.diff(np.append(run_first, nnz))
    # group runs by (tile, segment): a group's width is the tile's
    # largest run, rounded up to _W-slot chunks
    gkey = tile[run_first] * n_seg + seg[run_first]
    order = np.argsort(gkey, kind="stable")
    gs = gkey[order]
    gnew = np.ones(len(gs), dtype=bool)
    gnew[1:] = gs[1:] != gs[:-1]
    g_of_run = np.empty(len(gs), dtype=np.int64)
    g_of_run[order] = np.cumsum(gnew) - 1
    group_key = gs[gnew]
    gmax = np.zeros(len(group_key), dtype=np.int64)
    np.maximum.at(gmax, g_of_run, run_len)
    chunks_per_group = -(-gmax // _W)
    return (perm, identity, n, nnz, n_seg, n_tiles, run_id, q,
            g_of_run, group_key, chunks_per_group, ent, seg)


def binned_pad_factor(indptr, indices, n_cols: int) -> Optional[float]:
    """Padded-lane factor (plane lanes / nnz) of the binned plan, or None
    for an empty matrix."""
    plan = _plan(np.asarray(indptr), np.asarray(indices), n_cols)
    if plan is None:
        return None
    return int(plan[10].sum()) * (_W * _T) / max(plan[3], 1)


def bn_block_dim(dims) -> int:
    """Block dimension of a binned pack's static dims: scalar (and
    scalar-expansion) packs carry the 9-tuple, block-native packs append
    ``b`` as a 10th element."""
    return int(dims[9]) if len(dims) > 9 else 1


def csr_binned_pack(indptr, indices, data, n_cols: int, dtype,
                    block_dim: int = 1) -> Optional[Tuple[dict, tuple]]:
    """Host-side binned sliced-ELL pack of a CSR (scalar) or BSR
    (``block_dim = b > 1``, ``data`` shaped (nnz, b, b)) matrix.

    Returns ``(arrays, bn_dims)`` or None when the matrix is empty, its
    padding exceeds the ``_PAD_CAP`` budget, or its columns overflow the
    int32 code space.  ``bn_dims`` = (C, n_tiles, n_seg, T, SB, W,
    identity, n, n_cols), with ``b`` appended for block packs."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    b = int(block_dim)
    if int(n_cols) >= (1 << 31):
        return None
    plan = _plan(indptr, indices, n_cols)
    if plan is None:
        return None
    (perm, identity, n, nnz, n_seg, n_tiles, run_id, q, g_of_run,
     group_key, chunks_per_group, ent, seg) = plan
    Wp = _W * _T
    n_real = int(chunks_per_group.sum())
    L = n_real * Wp
    if L > max(_PAD_CAP * nnz, _PAD_FLOOR) or L >= (1 << 31):
        return None
    chunk_off = np.concatenate([[0], np.cumsum(chunks_per_group)[:-1]])
    # entry q of its (row, segment) run lands in chunk q // _W at slot
    # q % _W: lane = chunk·Wp + slot·T + (row mod T)
    g_e = g_of_run[run_id]
    chunk_e = chunk_off[g_e] + q // _W
    rows_p = np.repeat(np.arange(n, dtype=np.int64),
                       np.diff(indptr)[perm])
    lane = chunk_e * Wp + (q % _W) * _T + (rows_p % _T)
    codes = np.zeros(L, dtype=np.int32)
    codes[lane] = indices[ent].astype(np.int32)
    if b == 1:
        vals = np.zeros(L, dtype=dtype)
        vals[lane] = data[ent]
    else:
        vals = np.zeros((b * b, L), dtype=dtype)
        vals[:, lane] = data[ent].reshape(-1, b * b).T
    c_tile = np.repeat(group_key // n_seg, chunks_per_group)
    c_seg = np.repeat(group_key % n_seg, chunks_per_group)
    c_blk = np.arange(n_real, dtype=np.int64)
    # tiles with no entries get one dummy chunk on a shared zero block
    have = np.zeros(n_tiles, dtype=bool)
    have[c_tile] = True
    miss = np.flatnonzero(~have)
    if len(miss):
        codes = np.concatenate([codes, np.zeros(Wp, dtype=np.int32)])
        vals = (np.concatenate([vals, np.zeros(Wp, dtype=dtype)])
                if b == 1 else
                np.concatenate([vals, np.zeros((b * b, Wp),
                                               dtype=dtype)], axis=1))
        c_tile = np.concatenate([c_tile, miss])
        c_seg = np.concatenate([c_seg, np.zeros(len(miss), np.int64)])
        c_blk = np.concatenate([c_blk,
                                np.full(len(miss), n_real, np.int64)])
        order2 = np.argsort(c_tile, kind="stable")
        c_tile, c_seg, c_blk = c_tile[order2], c_seg[order2], \
            c_blk[order2]
    C = len(c_tile)
    first = np.ones(C, dtype=np.int64)
    first[1:] = c_tile[1:] != c_tile[:-1]
    meta = np.concatenate([c_tile, c_blk, c_seg, first]).astype(np.int32)
    arrays = {"bn_codes": codes.reshape(1, -1),
              "bn_vals": vals.reshape(1, -1) if b == 1 else vals,
              "bn_meta": meta}
    if not identity:
        pos = np.empty(n, dtype=np.int32)
        pos[perm] = np.arange(n, dtype=np.int32)
        arrays["bn_pos"] = pos
    dims = (C, int(n_tiles), int(n_seg), _T, _SB, _W,
            1 if identity else 0, int(n), int(n_cols))
    if b > 1:
        dims = dims + (b,)
    return arrays, dims


def binned_supported(Ad) -> bool:
    """Dispatch gate: the binned arrays are present and the kernel takes
    the pack's value type (f32 or f64; bf16 value planes on the
    block-native layout only).  Unlike the JAX gate this holds on every
    device: the CPU runs the plain version of the same planes."""
    if getattr(Ad, "bn_codes", None) is None:
        return False
    dt = Ad.bn_vals.dtype
    if dt in (torch.float32, torch.float64):
        return True
    return dt == torch.bfloat16 and bn_block_dim(Ad.bn_dims) > 1


def kernel_aux(bn_pos: Optional[torch.Tensor], dims
               ) -> Optional[torch.Tensor]:
    """The array the card's kernels read beside the compact pack, derived
    once at upload on the pack's device: ``row_of_pos`` (n_tiles·T,)
    int32, the original row of every padded position (−1 for padding
    rows), or None when the bin permutation is the identity."""
    if bn_pos is None:
        return None
    n_tiles, T, n = int(dims[1]), int(dims[3]), int(dims[7])
    row_of_pos = torch.full((n_tiles * T,), -1, dtype=torch.int32,
                            device=bn_pos.device)
    row_of_pos[bn_pos.long()] = torch.arange(n, dtype=torch.int32,
                                             device=bn_pos.device)
    return row_of_pos


@dataclasses.dataclass(frozen=True)
class CompactPack:
    """The kernels' pack: a binned pack's real entries (b = 1, B4) or
    blocks (b > 1, B5), row by row.

    Padded positions p (the bin permutation's order, tile·128 + row) are
    cut into slices of ``S = 32 // b``; slice s holds ``slice_ptr[s + 1]
    − slice_ptr[s]`` slots, its longest row's count.  Entry (slot k of
    slice s, row r) sits at ``e = (slice_ptr[s] + k)·S + r``: ``codes[e]``
    is the block column, with the sign bit set on the first kept entry
    of a chunk, or −1 for padding (a row's padding trails its entries);
    ``vals[e]`` its b×b block, row-major.  ``dims`` = (S, n_slices,
    slots, widest slice, b)."""

    codes: torch.Tensor       # (slots·S,) int32
    vals: torch.Tensor        # (slots·S, b, b)
    slice_ptr: torch.Tensor   # (n_slices + 1,) int32
    dims: tuple

    def astype(self, dtype) -> "CompactPack":
        return dataclasses.replace(self, vals=self.vals.to(dtype))


#: threads of a warp: B4 and B5 serve one compact slice per warp, b
#: threads a (block) row
_WARP = 32
#: the first-entry-of-a-chunk flag on a compact code
_FIRST = -(1 << 31)


def compact_pack(bn_codes: torch.Tensor, bn_vals: torch.Tensor,
                 bn_meta: torch.Tensor, dims) -> CompactPack:
    """The compact pack of a binned pack (scalar, scalar-expansion or
    block-native), derived on the pack's device from its planes.

    It keeps every lane whose entry (block) has a nonzero value, in the
    order the planes' plain version sums it: per padded row, chunk by
    chunk in the tile's chunk order, slot by slot; the first kept lane
    of each (chunk, row) is flagged, so the kernel can still sum a chunk
    into a partial and add the partial to the row at the chunk's end.
    The dropped lanes' products are exact zeros (for finite x), and
    adding one changes neither a nonzero partial nor the row sum, which
    starts at +0 and is never −0: the compact sum has the planes' bits."""
    b = bn_block_dim(dims)
    C, n_tiles, T, w = int(dims[0]), int(dims[1]), int(dims[3]), \
        int(dims[5])
    S = _WARP // b
    Wp = w * T
    dev = bn_codes.device
    c_tile = bn_meta[:C].long()
    c_blk = bn_meta[C:2 * C].long()
    j = torch.arange(Wp, dtype=torch.int64, device=dev)
    lane = (c_blk[:, None] * Wp + j).reshape(C, w, T)
    keep = (bn_vals.reshape(b * b, -1) != 0).any(dim=0)[lane]
    first = keep & (keep.cumsum(dim=1) == 1)
    pos = c_tile[:, None, None] * T + j[:T]
    sel = keep.reshape(-1).nonzero().squeeze(1)
    p = pos.expand(C, w, T).reshape(-1)[sel]
    p, order = torch.sort(p, stable=True)
    sel = sel[order]
    lane_e = lane.reshape(-1)[sel]
    first_e = first.reshape(-1)[sel]
    n_pos = n_tiles * T
    n_slices = -(-n_pos // S)
    counts = torch.zeros(n_slices * S, dtype=torch.int64, device=dev)
    counts[:n_pos] = torch.bincount(p, minlength=n_pos)
    rank = torch.arange(len(p), dtype=torch.int64, device=dev) \
        - (torch.cumsum(counts, 0) - counts)[p]
    width = counts.reshape(n_slices, S).amax(dim=1)
    slice_ptr = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    slice_ptr[1:] = torch.cumsum(width, 0)
    slots = int(host_scalar(slice_ptr[-1]))
    widest = int(host_scalar(width.max())) if n_slices else 0
    dst = (slice_ptr[p // S] + rank) * S + p % S
    codes = torch.full((slots * S,), -1, dtype=torch.int32, device=dev)
    codes[dst] = (bn_codes.reshape(-1)[lane_e].long()
                  + first_e.long() * _FIRST).to(torch.int32)
    vals = torch.zeros((slots * S, b, b), dtype=bn_vals.dtype, device=dev)
    vals[dst] = bn_vals.reshape(b * b, -1)[:, lane_e].T.reshape(-1, b, b)
    return CompactPack(codes=codes, vals=vals,
                       slice_ptr=slice_ptr.to(torch.int32),
                       dims=(S, n_slices, slots, widest, b))


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _chunk_sums(P: torch.Tensor, bn_meta: torch.Tensor, dims
                ) -> torch.Tensor:
    """Row sums of per-lane products ``P`` (k, L), k output components:
    per chunk the _W slots in slot order, then over the tile's chunks in
    chunk order; returns the padded (k, n_tiles·T) result."""
    C, n_tiles, T, w = int(dims[0]), int(dims[1]), int(dims[3]), \
        int(dims[5])
    k = P.shape[0]
    Pb = P.reshape(k, -1, w, T)                       # (k, blocks, w, T)
    acc = Pb[:, :, 0]
    for s in range(1, w):
        acc = acc + Pb[:, :, s]                       # (k, blocks, T)
    per_chunk = acc[:, bn_meta[C:2 * C].long()]       # (k, C, T)
    # the chunks are tile-sorted: add the j-th chunk of every tile at
    # step j, so each tile sums its chunks in chunk order on any device
    # (a scatter-add on the card adds them in no fixed order)
    c_tile = bn_meta[:C].long()
    counts = torch.bincount(c_tile, minlength=n_tiles)
    rank = torch.arange(C, dtype=torch.int64, device=P.device) \
        - (torch.cumsum(counts, 0) - counts)[c_tile]
    y = torch.zeros((k, n_tiles, T), dtype=P.dtype, device=P.device)
    for j in range(int(counts.max()) if C else 0):
        sel = (rank == j).nonzero().squeeze(1)
        tiles = c_tile[sel]
        y[:, tiles] = y[:, tiles] + per_chunk[:, sel]
    return y.reshape(k, n_tiles * T)


def _acc_dtype(vals: torch.Tensor, x: torch.Tensor) -> torch.dtype:
    return x.dtype if vals.dtype == torch.bfloat16 else \
        torch.promote_types(vals.dtype, x.dtype)


def binned_spmv_reference(bn_codes, bn_vals, bn_meta, bn_pos, dims,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B4 and B5: gather x at every lane's code,
    multiply with the lane's value (block packs: the b² component planes,
    output component a summed over c in order), sum the chunks as the
    kernels do and undo the bin permutation.  ``x`` is the flat scalar
    vector (block packs: (n_cols·b,))."""
    b = bn_block_dim(dims)
    n = int(dims[7])
    ident = bool(dims[6])
    acc = _acc_dtype(bn_vals, x)
    codes = bn_codes.reshape(-1).long()
    if b == 1:
        P = (bn_vals.reshape(1, -1).to(acc) * x.to(acc)[codes][None])
    else:
        X = x.to(acc).reshape(-1, b)[codes]            # (L, b)
        V = bn_vals.to(acc)
        rows = []
        for a in range(b):
            pa = V[a * b] * X[:, 0]
            for c in range(1, b):
                pa = pa + V[a * b + c] * X[:, c]
            rows.append(pa)
        P = torch.stack(rows)                          # (b, L)
    y = _chunk_sums(P, bn_meta, dims)                  # (b, n_pad)
    yt = y.T
    yt = yt[:n] if ident else yt[bn_pos.long()]
    return yt.reshape(-1).to(x.dtype)


def binned_compact_reference(cp: CompactPack, bn_pos, dims,
                             x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B5 over the compact pack: slot by slot,
    each row's block product (output component a summed over c in
    order) added to the row's chunk partial, the partial added to the
    row at the next flagged entry and at the end, then the bin
    permutation undone.  Bit-equal to :func:`binned_spmv_reference` on
    the planes the pack came from, for finite x."""
    S, n_slices, _slots, widest, b = cp.dims
    n, ident = int(dims[7]), bool(dims[6])
    n_pos = int(dims[1]) * int(dims[3])
    acc_dt = _acc_dtype(cp.vals, x)
    X = x.to(acc_dt).reshape(-1, b)
    dev = x.device
    acc = torch.zeros((n_slices * S, b), dtype=acc_dt, device=dev)
    part = torch.zeros_like(acc)
    live = torch.zeros(n_slices * S, dtype=torch.bool, device=dev)
    ptr = cp.slice_ptr.to(dev).long()
    width = ptr[1:] - ptr[:-1]
    r = torch.arange(S, dtype=torch.int64, device=dev)
    for k in range(widest):
        sl = (width > k).nonzero().squeeze(1)
        e = ((ptr[sl] + k)[:, None] * S + r).reshape(-1)
        p = (sl[:, None] * S + r).reshape(-1)
        raw = cp.codes[e]
        valid = raw != -1
        first = valid & (raw < 0)
        col = torch.where(valid, (raw & 0x7FFFFFFF).long(), 0)
        Xg = X[col]
        V = cp.vals[e].to(acc_dt)
        prods = []
        for a in range(b):
            pa = V[:, a, 0] * Xg[:, 0]
            for c in range(1, b):
                pa = pa + V[:, a, c] * Xg[:, c]
            prods.append(pa)
        P = torch.stack(prods, dim=1)
        acc_p, part_p = acc[p], part[p]
        acc[p] = torch.where((first & live[p])[:, None], acc_p + part_p,
                             acc_p)
        part[p] = torch.where(first[:, None], P,
                              torch.where(valid[:, None], part_p + P,
                                          part_p))
        live[p] = live[p] | valid
    acc = torch.where(live[:, None], acc + part, acc)[:n_pos]
    y = acc[:n] if ident else acc[bn_pos.long()]
    return y.reshape(-1).to(x.dtype)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _kernel():
    global _fn
    if _fn is None:
        from .. import native
        fn = native.load("binned_spmv").amgx_binned_compact_spmv
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(Ad, x: torch.Tensor):
    b = bn_block_dim(Ad.bn_dims)
    pairs = SUPPORTED_SCALAR if b == 1 else SUPPORTED_BLOCK
    if (Ad.bn_vals.dtype, x.dtype) not in pairs:
        raise BadParametersError(
            f"binned_spmv: unsupported (vals, x) dtypes "
            f"({Ad.bn_vals.dtype}, {x.dtype}) for b = {b}")
    m = int(Ad.bn_dims[8]) * b
    if x.dim() != 1 or x.shape[0] != m:
        raise BadParametersError(
            f"binned_spmv: x must be ({m},), got {tuple(x.shape)}")
    if not 1 <= b <= 5:
        raise BadParametersError(f"binned_spmv: b = {b} (1..5 supported)")
    if Ad.bn_vals.device != x.device:
        raise BadParametersError(
            f"binned_spmv: pack on {Ad.bn_vals.device}, x on {x.device}")
    cp = Ad.bn_compact
    if cp is None or cp.vals.dtype != Ad.bn_vals.dtype \
            or cp.vals.device != x.device:
        raise BadParametersError(
            "binned_spmv: a binned pack needs its compact pack "
            "(compact_pack) in the planes' dtype and device")


def binned_spmv(Ad, x: torch.Tensor) -> torch.Tensor:
    """y = A·x through a binned pack (``Ad.bn_*``).  Scalar and
    scalar-expansion packs run B4, block-native packs B5, both over the
    pack's compact pack; ``x`` is the flat scalar vector.  CUDA tensors
    launch the kernel (or raise: a missing ``nvcc``, a failed build or a
    refused launch is an error, never a fallback); CPU tensors take the
    plain version (:func:`binned_spmv_reference` over the planes for B4,
    :func:`binned_compact_reference` for B5)."""
    _check(Ad, x)
    b = bn_block_dim(Ad.bn_dims)
    if not x.is_cuda:
        if b > 1:
            return binned_compact_reference(Ad.bn_compact, Ad.bn_pos,
                                            Ad.bn_dims, x)
        return binned_spmv_reference(Ad.bn_codes, Ad.bn_vals, Ad.bn_meta,
                                     Ad.bn_pos, Ad.bn_dims, x)
    return _launch(Ad.bn_compact, Ad.bn_row_of_pos, Ad.bn_dims, x,
                   "B4" if b == 1 else "B5")


def compact_spmv(cp: CompactPack, bn_pos, row_of_pos, dims,
                 x: torch.Tensor) -> torch.Tensor:
    """y = A·x over a block compact pack held without its planes (the
    stacked interior of a b×b sharded pack): kernel B5 on a CUDA tensor
    (it launches or raises), :func:`binned_compact_reference` on a CPU
    tensor.  ``x`` is the flat (dims[8]·b,) vector."""
    b = cp.dims[4]
    if (cp.vals.dtype, x.dtype) not in SUPPORTED_BLOCK or not 2 <= b <= 5:
        raise BadParametersError(
            f"compact_spmv: unsupported (vals, x) dtypes "
            f"({cp.vals.dtype}, {x.dtype}) or b = {b} (2..5 supported)")
    m = int(dims[8]) * b
    if x.dim() != 1 or x.shape[0] != m:
        raise BadParametersError(
            f"compact_spmv: x must be ({m},), got {tuple(x.shape)}")
    if cp.vals.device != x.device:
        raise BadParametersError(
            f"compact_spmv: pack on {cp.vals.device}, x on {x.device}")
    if not x.is_cuda:
        return binned_compact_reference(cp, bn_pos, dims, x)
    return _launch(cp, row_of_pos, dims, x, "B5-stacked")


def _launch(cp: CompactPack, row_of_pos, dims, x: torch.Tensor,
            kern: str) -> torch.Tensor:
    """One launch of B4 (b = 1) or B5 over a compact pack, counted under
    ``kern``."""
    x = x.contiguous()
    S, n_slices, _slots, _widest, b = cp.dims
    n = int(dims[7])
    n_pos = int(dims[1]) * int(dims[3])
    if not (cp.vals.is_contiguous() and cp.vals.data_ptr() % 16 == 0):
        raise BadParametersError("binned_spmv: the compact values must be "
                                 "contiguous and 16-byte aligned")
    out = torch.empty(n * b, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(
        _TYPE_CODE[cp.vals.dtype], _TYPE_CODE[x.dtype], b,
        cp.codes.data_ptr(), cp.vals.data_ptr(), cp.slice_ptr.data_ptr(),
        None if row_of_pos is None else row_of_pos.data_ptr(),
        n, n_pos, n_slices, x.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise DeviceError(f"binned_spmv ({kern}) kernel launch failed "
                          f"(code {rc})")
    LAUNCHES[kern][f"{_SHORT[cp.vals.dtype]}.{_SHORT[x.dtype]}"] += 1
    return out


# --------------------------------------------------------------------------
# views of a binned pack (amgx_tpu/ops/pallas_csr.py:546-587)
# --------------------------------------------------------------------------

def _row_pad_of_lane(Ad) -> torch.Tensor:
    """Padded row id per plane lane (the zero block's attribution is
    irrelevant: its values are all 0)."""
    C, _nt, _ns, T, _sb, w = (int(v) for v in Ad.bn_dims[:6])
    Wp = w * T
    L = Ad.bn_codes.numel()
    dev = Ad.bn_codes.device
    tile_of_blk = torch.zeros(L // Wp, dtype=torch.int64, device=dev)
    tile_of_blk[Ad.bn_meta[C:2 * C].long()] = Ad.bn_meta[:C].long()
    lane = torch.arange(L, dtype=torch.int64, device=dev)
    return tile_of_blk[lane // Wp] * T + (lane % Wp) % T


def binned_entries_view(Ad):
    """(rows, cols, vals) flat entry triplets reconstructed from a scalar
    pack's planes — original row ids; padding lanes carry value 0 on row
    0."""
    n_tiles, T, ident, n = (int(Ad.bn_dims[i]) for i in (1, 3, 6, 7))
    row_pad = _row_pad_of_lane(Ad)
    dev = row_pad.device
    if ident:
        rows = torch.where(row_pad < n, row_pad, 0)
    else:
        inv = torch.zeros(n_tiles * T, dtype=torch.int64, device=dev)
        inv[Ad.bn_pos.long()] = torch.arange(n, dtype=torch.int64,
                                             device=dev)
        rows = inv[row_pad]
    vals = Ad.bn_vals.reshape(-1)
    rows = torch.where(vals != 0, rows, 0)
    return rows, Ad.bn_codes.reshape(-1), vals


def binned_abs_rowsum(Ad) -> torch.Tensor:
    """Σ_j |A[i, j]| per scalar row from a scalar pack's planes alone
    (padding contributes 0): each row's lanes in plane order, summed in
    one fixed order on every device (:func:`~.ordered.segment_sum`, no
    atomic scatter)."""
    from .ordered import segment_sum
    n_tiles, T, ident, n = (int(Ad.bn_dims[i]) for i in (1, 3, 6, 7))
    row_pad = _row_pad_of_lane(Ad)
    v = Ad.bn_vals.reshape(-1).abs()
    if v.dtype == torch.bfloat16:
        v = v.float()
    rs = segment_sum(v, row_pad, n_tiles * T)
    return rs[:n] if ident else rs[Ad.bn_pos.long()]
