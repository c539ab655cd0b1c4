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

The card does not need the segments (it gathers x directly), so each
kernel walks its tile's chunks (one contiguous range of the tile-sorted
chunk list, :func:`kernel_aux`) and writes each row through the inverse
of ``bn_pos``.

Contract of both kernels: ``y = A·x`` for the pack, summed per chunk over
its 8 slots in slot order and over the tile's chunks in chunk order.  B4
takes (vals, x) pairs (f32, f32) and (f64, f64); B5 (b ∈ {2, 3, 4, 5})
takes (f32, f32), (bf16, f32) and (f64, f64), accumulating in x's type.
:func:`binned_spmv` runs the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
#: nowhere else
LAUNCHES: Dict[str, Dict[str, int]] = {
    "B4": {f"{_SHORT[v]}.{_SHORT[x]}": 0 for v, x in SUPPORTED_SCALAR},
    "B5": {f"{_SHORT[v]}.{_SHORT[x]}": 0 for v, x in SUPPORTED_BLOCK},
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


def kernel_aux(bn_meta: torch.Tensor, bn_pos: Optional[torch.Tensor],
               dims) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The two arrays the card's kernels read beside the pack, derived
    once at upload on the pack's device: ``tile_ptr`` (n_tiles + 1,)
    int32, the first chunk of every tile in the tile-sorted chunk list,
    and ``row_of_pos`` (n_tiles·T,) int32, the original row of every
    padded position (−1 for padding rows; None when the bin permutation
    is the identity)."""
    C, n_tiles, T = int(dims[0]), int(dims[1]), int(dims[3])
    n = int(dims[7])
    c_tile = bn_meta[:C].long()
    counts = torch.bincount(c_tile, minlength=n_tiles)
    tile_ptr = torch.zeros(n_tiles + 1, dtype=torch.int64,
                           device=bn_meta.device)
    tile_ptr[1:] = torch.cumsum(counts, 0)
    row_of_pos = None
    if bn_pos is not None:
        row_of_pos = torch.full((n_tiles * T,), -1, dtype=torch.int32,
                                device=bn_meta.device)
        row_of_pos[bn_pos.long()] = torch.arange(n, dtype=torch.int32,
                                                 device=bn_meta.device)
    return tile_ptr.to(torch.int32), row_of_pos


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
    y = torch.zeros((k, n_tiles, T), dtype=P.dtype, device=P.device)
    y.index_add_(1, bn_meta[:C].long(), per_chunk)
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


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _kernel():
    global _fn
    if _fn is None:
        from .. import native
        fn = native.load("binned_spmv").amgx_binned_spmv
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
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


def binned_spmv(Ad, x: torch.Tensor) -> torch.Tensor:
    """y = A·x through a binned pack (``Ad.bn_*``).  Scalar and
    scalar-expansion packs run B4, block-native packs B5; ``x`` is the
    flat scalar vector.  CUDA tensors launch the kernel (or raise: a
    missing ``nvcc``, a failed build or a refused launch is an error,
    never a fallback); CPU tensors take :func:`binned_spmv_reference`."""
    _check(Ad, x)
    if not x.is_cuda:
        return binned_spmv_reference(Ad.bn_codes, Ad.bn_vals, Ad.bn_meta,
                                     Ad.bn_pos, Ad.bn_dims, x)
    x = x.contiguous()
    b = bn_block_dim(Ad.bn_dims)
    n, n_tiles = int(Ad.bn_dims[7]), int(Ad.bn_dims[1])
    C = int(Ad.bn_dims[0])
    tile_ptr, row_of_pos = Ad.bn_tile_ptr, Ad.bn_row_of_pos
    out = torch.empty(n * b, dtype=x.dtype, device=x.device)
    L = Ad.bn_codes.numel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(
        _TYPE_CODE[Ad.bn_vals.dtype], _TYPE_CODE[x.dtype], b,
        Ad.bn_codes.data_ptr(), Ad.bn_vals.data_ptr(), L,
        Ad.bn_meta.data_ptr() + 4 * C, tile_ptr.data_ptr(),
        None if row_of_pos is None else row_of_pos.data_ptr(),
        n, n_tiles, x.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise DeviceError(f"binned_spmv kernel launch failed (code {rc})")
    LAUNCHES["B4" if b == 1 else "B5"][
        f"{_SHORT[Ad.bn_vals.dtype]}.{_SHORT[x.dtype]}"] += 1
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
    (padding contributes 0)."""
    n_tiles, T, ident, n = (int(Ad.bn_dims[i]) for i in (1, 3, 6, 7))
    row_pad = _row_pad_of_lane(Ad)
    v = Ad.bn_vals.reshape(-1).abs()
    if v.dtype == torch.bfloat16:
        v = v.float()
    rs = torch.zeros(n_tiles * T, dtype=v.dtype, device=v.device)
    rs.index_add_(0, row_pad, v)
    return rs[:n] if ident else rs[Ad.bn_pos.long()]
