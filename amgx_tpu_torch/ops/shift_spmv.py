"""Tile-DIA (shift) SpMV: the host pack, the hand-written Hopper kernel B2
and its plain version.

Replaces ``amgx_tpu/ops/pallas_shift.py::_shift_call`` (B2,
``pl.pallas_call`` at :187).  The kernel is ``csrc/shift_spmv.cu``; see
its header for the bound and the design.

The host pack (:func:`shift_pack`) is a copy of the JAX package's and
gives bit-equal arrays, refusals included.  Rows are cut into tiles of
T = min(8192, n rounded up to 128) rows; within a tile the stored
entries fall into at most 32 classes of equal column difference
``d = col − row``, padded to Dpad (a multiple of 8) slots:

* ``sh_vals`` (n_tiles·Dpad·T/128, 128) holds, for tile t and slot j, the
  class values of the tile's T rows at flat position (t·Dpad + j)·T + r
  (0 where a row has no entry of that class, and in unused slots);
* ``sh_meta`` (n_tiles·2·Dpad,) int32 holds per class the TPU kernel's
  x-window row start and sub-128 residual, ``128·rowstart + rem = pad +
  t·T + d`` with ``pad = T + 128``; unused slots hold (0, 0);
* ``sh_dims`` = (T, n_tiles, Dpad, pad, L).

The card needs only each class's difference, so :func:`class_diffs`
decodes the (n_tiles, Dpad) int32 table ``d = rowstart·128 + rem − pad −
t·T`` once at upload.  An unused slot decodes to ``−pad − t·T``, which
puts every row of its tile left of column 0.

Contract: ``y[r] = Σ_j vals[t, j, r mod T] · x[r + d[t, j]]`` over the
tile's slots in slot order, a slot contributing 0 where ``r + d`` lies
outside ``[0, n_cols)`` (the JAX package reads zero padding there),
each product and sum rounded on its own.  (vals, x) type pairs (f32,
f32) and (f64, f64).

The kernel reads no plane.  It reads the *slice-masked compact pack*
(:class:`ShiftCompact`, :func:`shift_compact`), derived from the planes
on their device at upload: each tile is cut into slices of S = 32 rows
(T is a multiple of 128, so no slice straddles a tile); ``mask[s]`` has
bit j set when a row of slice s holds a nonzero value in slot j;
``ptr[s]`` counts the set bits of the slices before s; and the slice's
32 values of its k-th set bit, in ascending slot order, sit at
``vals[(ptr[s] + k)·32 + lane]``.  Its plain version
(:func:`shift_compact_reference`) walks the set bits in slot order and
is bit for bit :func:`shift_spmv_reference` for finite x: every dropped
slot's products are exact zeros (±0, or the +0 of the column mask), and
adding one changes no row sum, which starts at +0 and is never −0 (a
sum of two nonzeros that cancel rounds to +0).  With an x holding an
inf or a NaN the two may differ (0·inf is NaN on a dropped slot only).
:func:`shift_spmv` runs that plain version for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import host_scalar
from ..errors import BadParametersError, DeviceError

#: max distinct diffs per tile (``_MAX_CLASSES`` upstream)
_MAX_CLASSES = 32
#: default rows per tile (``_TILE`` upstream)
_TILE = 8192
#: rows of a compact slice: one warp of the kernel
_SLICE = 32

#: kernel type codes (``TypeCode`` in csrc/shift_spmv.cu)
_TYPE_CODE = {torch.float32: 0, torch.float64: 1}
_SHORT = {torch.float32: "f32", torch.float64: "f64"}
SUPPORTED = ((torch.float32, torch.float32), (torch.float64, torch.float64))

#: kernel launches per (vals, x) type pair, e.g. ``"f32.f32"`` — counted
#: where the kernel is launched and nowhere else
LAUNCHES: Dict[str, int] = {f"{_SHORT[v]}.{_SHORT[x]}": 0
                            for v, x in SUPPORTED}

_fn = None


def launch_count() -> int:
    """Total kernel launches since the last :func:`reset_launches`."""
    return sum(LAUNCHES.values())


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def shift_pack(cols: np.ndarray, vals: np.ndarray,
               tile: int = _TILE,
               max_classes: int = _MAX_CLASSES,
               n_cols: Optional[int] = None) -> Optional[dict]:
    """Host-side tile-DIA pack of an (n, K) ELL pack, or None when the
    matrix is too scattered (a tile past ``max_classes`` classes, or the
    class planes past 4× the stored entries) or not square.

    Returns ``{"sh_vals": (n_tiles·Dpad·T/128, 128), "sh_meta":
    (n_tiles·2·Dpad,) int32, "_meta": (T, n_tiles, Dpad, pad, L)}``
    (``shift_pack`` upstream, line for line)."""
    n, K = cols.shape
    if n == 0 or K == 0 or (n_cols is not None and n_cols != n):
        return None
    T = min(tile, -(-n // 128) * 128)
    n_tiles = -(-n // T)
    # the first tile past max_classes refuses the pack: count its classes
    # before sorting every entry (a scattered matrix fails there)
    m0 = min(T, n) * K
    c0, v0 = cols.reshape(-1)[:m0], vals.reshape(-1)[:m0]
    d0 = c0.astype(np.int64) - np.repeat(np.arange(min(T, n)), K)
    if len(np.unique(d0[v0 != 0])) > max_classes:
        return None
    r = np.repeat(np.arange(n, dtype=np.int64), K)
    c = cols.reshape(-1).astype(np.int64)
    v = vals.reshape(-1)
    live = v != 0
    r, c, v = r[live], c[live], v[live]
    if len(r) == 0:
        return None
    d = c - r
    t_of = r // T
    # distinct (tile, diff) classes, sorted by (tile, diff)
    span_key = 4 * n + 3
    key = t_of * span_key + (d + 2 * n + 1)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    new = np.ones(len(ks), dtype=bool)
    new[1:] = ks[1:] != ks[:-1]
    cls_of_sorted = np.cumsum(new) - 1          # global class id per entry
    tile_of_cls = (ks[new] // span_key).astype(np.int64)
    diff_of_cls = (ks[new] % span_key) - (2 * n + 1)
    per_tile = np.bincount(tile_of_cls, minlength=n_tiles)
    D = int(per_tile.max())
    if D > max_classes:
        return None
    Dpad = max(8, -(-D // 8) * 8)
    # efficiency gate: the class-value array must not dwarf the nnz
    if Dpad * n_tiles * T > max(4 * len(r), 1 << 16):
        return None
    first_of_tile = np.concatenate([[0], np.cumsum(per_tile)[:-1]])
    slot_of_cls = np.arange(len(tile_of_cls)) - first_of_tile[tile_of_cls]

    pad = T + 128
    abs_start = pad + tile_of_cls * T + diff_of_cls
    rowstart_of_cls = abs_start // 128
    rem_of_cls = abs_start % 128

    sh_vals = np.zeros((n_tiles * Dpad, T), dtype=vals.dtype)
    ent_cls = np.empty(len(r), dtype=np.int64)
    ent_cls[order] = cls_of_sorted
    ent_slot = slot_of_cls[ent_cls]
    sh_vals[t_of * Dpad + ent_slot, r % T] = v

    meta = np.zeros((n_tiles, 2 * Dpad), dtype=np.int32)
    meta[tile_of_cls, 2 * slot_of_cls] = rowstart_of_cls
    meta[tile_of_cls, 2 * slot_of_cls + 1] = rem_of_cls
    L = -(-(pad + n + T + 256) // 128) * 128
    Ts = T // 128
    return {"sh_vals": sh_vals.reshape(n_tiles * Dpad * Ts, 128),
            "sh_meta": meta.reshape(-1),
            "_meta": (T, n_tiles, Dpad, pad, L)}


def shift_planes_like(cols: np.ndarray, vals: np.ndarray, dims,
                      diffs: np.ndarray) -> np.ndarray:
    """``sh_vals`` of the (n, K) ELL pack (``cols``, ``vals``) on the class
    layout of an existing shift pack (``dims`` = its ``sh_dims``,
    ``diffs`` its (n_tiles, Dpad) :func:`class_diffs`), in ``vals``'s
    dtype: the refinement's f64 planes of an f32 pack.  Raises
    BadParametersError when a nonzero entry has no class slot in its
    tile — a value that rounds to 0 in the narrow type while its class
    holds no other entry there."""
    T, n_tiles, Dpad, pad = (int(v) for v in dims[:4])
    n, K = cols.shape
    r = np.repeat(np.arange(n, dtype=np.int64), K)
    c = cols.reshape(-1).astype(np.int64)
    v = vals.reshape(-1)
    live = v != 0
    r, c, v = r[live], c[live], v[live]
    t = r // T
    # an unused slot decodes to −pad − t·T, which no column ≥ 0 reaches
    dd = np.asarray(diffs, dtype=np.int64).reshape(n_tiles, Dpad)
    tiles = np.arange(n_tiles, dtype=np.int64)[:, None]
    used = dd != -pad - tiles * T
    # (tile, diff) keys: the used slots of a tile hold ascending diffs,
    # so the flat list of their keys is sorted
    span = 4 * n + 3
    slot_keys = (np.broadcast_to(tiles, dd.shape) * span
                 + dd + 2 * n + 1)[used]
    slot_of = np.nonzero(used)[1]
    key = t * span + (c - r + 2 * n + 1)
    at = np.minimum(np.searchsorted(slot_keys, key), len(slot_keys) - 1)
    miss = slot_keys[at] != key
    if miss.any():
        i = int(np.argmax(miss))
        raise BadParametersError(
            f"shift planes: row {int(r[i])}, column {int(c[i])} (value "
            f"{v[i]!r}) has no class slot in tile {int(t[i])}: the pack it "
            f"should follow dropped that class (its values round to 0 in "
            f"the pack dtype); pack this operator in {vals.dtype}")
    planes = np.zeros((n_tiles * Dpad, T), dtype=vals.dtype)
    planes[t * Dpad + slot_of[at], r % T] = v
    return planes.reshape(n_tiles * Dpad * (T // 128), 128)


def shift_supported(Ad) -> bool:
    """Dispatch gate: the shift planes are present on a scalar pack.
    Unlike the JAX gate (f32 on a TPU or under its interpreter) this
    holds on every device and in f64 too: the CPU runs the plain version
    of the same compact pack, and :func:`shift_spmv` refuses a type pair the
    kernel does not take."""
    return getattr(Ad, "sh_vals", None) is not None and Ad.block_dim == 1


def class_diffs(sh_meta: torch.Tensor, dims) -> torch.Tensor:
    """The (n_tiles, Dpad) int32 column difference of every class slot,
    decoded from ``sh_meta`` on its device (derived once at upload)."""
    T, n_tiles, Dpad, pad, _ = (int(v) for v in dims)
    meta = sh_meta.reshape(n_tiles, 2 * Dpad).long()
    tiles = torch.arange(n_tiles, dtype=torch.int64, device=meta.device)
    d = meta[:, 0::2] * 128 + meta[:, 1::2] - pad - tiles[:, None] * T
    return d.to(torch.int32)


def shift_spmv_reference(sh_vals: torch.Tensor, sh_diffs: torch.Tensor,
                         dims, x: torch.Tensor, n_rows: int
                         ) -> torch.Tensor:
    """Plain PyTorch version of B2: per slot, gather x at every row's
    column ``r + d``, multiply with the slot's values and add, slot by
    slot, columns outside ``[0, len(x))`` contributing 0."""
    T, n_tiles, Dpad = (int(v) for v in dims[:3])
    v = sh_vals.reshape(n_tiles, Dpad, T)
    rows = torch.arange(n_tiles * T, dtype=torch.int64,
                        device=x.device).reshape(n_tiles, T)
    dd = sh_diffs.long()
    acc = torch.zeros((n_tiles, T), dtype=x.dtype, device=x.device)
    for j in range(Dpad):
        c = rows + dd[:, j:j + 1]
        ok = (c >= 0) & (c < x.shape[0])
        xg = x[torch.where(ok, c, 0)]
        acc = acc + torch.where(ok, v[:, j] * xg, 0)
    return acc.reshape(-1)[:n_rows]


@dataclasses.dataclass(frozen=True)
class ShiftCompact:
    """Kernel B2's pack: the class values of each 32-row slice for the
    slots the slice uses.

    Slice s covers rows ``s·32 … s·32 + 31`` (tile ``s // (T/32)``);
    ``mask[s]`` (int32, read as a 32-bit unsigned word) has bit j set
    when one of those rows holds a nonzero value in slot j of its tile;
    ``ptr[s]`` is the exclusive prefix sum of the popcounts (int32:
    :func:`shift_compact` refuses a pack of 2³¹ slots or more, and the
    kernel forms ``(ptr[s] + k)·32`` in 64 bits); the k-th set bit's
    values, in ascending slot order, are ``vals[(ptr[s] + k)·32 +
    lane]``.  ``dims`` = (S, n_slices, slots, widest popcount)."""

    mask: torch.Tensor   # (n_slices,) int32
    ptr: torch.Tensor    # (n_slices + 1,) int32
    vals: torch.Tensor   # (slots·32,)
    dims: tuple

    def astype(self, dtype) -> "ShiftCompact":
        """The same slots in ``dtype``: the mask stays, so a value that
        underflows to 0 leaves a slot of zero products (a mask may hold
        more slots than the values use, never fewer)."""
        return dataclasses.replace(self, vals=self.vals.to(dtype))


def shift_compact(sh_vals: torch.Tensor, dims) -> ShiftCompact:
    """The compact pack of shift planes ``sh_vals`` (``dims`` =
    ``sh_dims``), derived on their device by a few tensor operations
    (no loop over tiles)."""
    T, n_tiles, Dpad = (int(v) for v in dims[:3])
    S = _SLICE
    n_slices = n_tiles * T // S
    dev = sh_vals.device
    per_slot = sh_vals.reshape(n_tiles, Dpad, T // S, S) \
        .permute(0, 2, 1, 3).reshape(n_slices, Dpad, S)
    bits = (per_slot != 0).any(dim=2)                     # (n_slices, Dpad)
    word = (bits.long() << torch.arange(Dpad, dtype=torch.int64,
                                        device=dev)).sum(dim=1)
    # bit 31 is int32's sign bit: store the word's two's complement
    mask = torch.where(word >= 1 << 31, word - (1 << 32), word) \
        .to(torch.int32)
    pop = bits.sum(dim=1)
    ptr = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(pop, 0)
    slots = int(host_scalar(ptr[-1]))
    if slots >= 1 << 31:
        raise BadParametersError(
            f"shift_compact: {slots} slots overflow the int32 slice "
            f"pointer")
    widest = int(host_scalar(pop.max())) if n_slices else 0
    vals = per_slot[bits].reshape(-1)      # row-major: slot order a slice
    return ShiftCompact(mask=mask, ptr=ptr.to(torch.int32), vals=vals,
                        dims=(S, n_slices, slots, widest))


def shift_compact_reference(cp: ShiftCompact, sh_diffs: torch.Tensor,
                            dims, x: torch.Tensor, n_rows: int
                            ) -> torch.Tensor:
    """Plain PyTorch version of B2 over the compact pack: each slice
    walks its set bits in slot order, gathering x at ``r + d`` (columns
    outside ``[0, len(x))`` contribute 0), multiplying and adding, each
    operation rounded on its own."""
    T, Dpad = int(dims[0]), int(dims[2])
    S, n_slices, _slots, widest = cp.dims
    dev = x.device
    word = cp.mask.long() & 0xFFFFFFFF
    bits = ((word[:, None] >> torch.arange(Dpad, dtype=torch.int64,
                                           device=dev)) & 1).bool()
    s_of, j_of = bits.nonzero(as_tuple=True)    # the pack's slot order
    k_of = torch.arange(len(s_of), dtype=torch.int64, device=dev) \
        - cp.ptr.long()[s_of]
    d = sh_diffs.long()[s_of // (T // S), j_of]
    lanes = torch.arange(S, dtype=torch.int64, device=dev)
    c = s_of[:, None] * S + lanes + d[:, None]
    ok = (c >= 0) & (c < x.shape[0])
    prod = torch.where(ok, cp.vals.reshape(-1, S) * x[torch.where(ok, c, 0)],
                       0)
    per_k = torch.zeros((n_slices, widest, S), dtype=x.dtype, device=dev)
    per_k[s_of, k_of] = prod
    acc = torch.zeros((n_slices, S), dtype=x.dtype, device=dev)
    for k in range(widest):
        acc = acc + per_k[:, k]
    return acc.reshape(-1)[:n_rows]


def _kernel():
    global _fn
    if _fn is None:
        from .. import native
        fn = native.load("shift_spmv").amgx_shift_spmv
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(Ad, x: torch.Tensor):
    """The arrays the kernel (and its plain version) read: the compact
    pack, the diff table and x, on one device, contiguous, their shapes
    and types matching ``sh_dims``."""
    cp = Ad.sh_compact
    if cp is None:
        raise BadParametersError("shift_spmv: the pack carries no compact "
                                 "pack (shift_compact)")
    if (cp.vals.dtype, x.dtype) not in SUPPORTED or \
            Ad.sh_vals.dtype != cp.vals.dtype:
        raise BadParametersError(
            f"shift_spmv: unsupported (vals, x) dtypes ({cp.vals.dtype}, "
            f"{x.dtype}) or planes in {Ad.sh_vals.dtype}")
    if x.dim() != 1 or x.shape[0] != Ad.n_cols:
        raise BadParametersError(
            f"shift_spmv: x must be ({Ad.n_cols},), got {tuple(x.shape)}")
    T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
    if Ad.sh_vals.numel() != n_tiles * Dpad * T or \
            tuple(Ad.sh_diffs.shape) != (n_tiles, Dpad) or \
            Ad.sh_diffs.dtype != torch.int32:
        raise BadParametersError("shift_spmv: planes and diff table do "
                                 "not match sh_dims")
    S, n_slices, slots = (int(v) for v in cp.dims[:3])
    if S != _SLICE or n_slices * S != n_tiles * T or \
            tuple(cp.mask.shape) != (n_slices,) or \
            tuple(cp.ptr.shape) != (n_slices + 1,) or \
            cp.mask.dtype != torch.int32 or cp.ptr.dtype != torch.int32 or \
            tuple(cp.vals.shape) != (slots * S,):
        raise BadParametersError("shift_spmv: compact pack does not match "
                                 "sh_dims")
    arrays = (cp.mask, cp.ptr, cp.vals, Ad.sh_diffs)
    if any(a.device != x.device for a in arrays):
        raise BadParametersError(
            f"shift_spmv: pack on {cp.vals.device}, x on {x.device}")
    if not all(a.is_contiguous() for a in arrays):
        raise BadParametersError("shift_spmv: the compact pack and the "
                                 "diff table must be contiguous")


def shift_spmv(Ad, x: torch.Tensor) -> torch.Tensor:
    """y = A·x through a shift pack's compact pack (``Ad.sh_compact``).
    CUDA tensors launch the kernel (or raise: a missing ``nvcc``, a
    failed build or a refused launch is an error, never a fallback); CPU
    tensors take :func:`shift_compact_reference`."""
    _check(Ad, x)
    cp = Ad.sh_compact
    if not x.is_cuda:
        return shift_compact_reference(cp, Ad.sh_diffs, Ad.sh_dims, x,
                                       Ad.n_rows)
    x = x.contiguous()
    T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
    out = torch.empty(Ad.n_rows, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(_TYPE_CODE[cp.vals.dtype], _TYPE_CODE[x.dtype],
                   cp.vals.data_ptr(), cp.mask.data_ptr(), cp.ptr.data_ptr(),
                   Ad.sh_diffs.data_ptr(), x.data_ptr(), out.data_ptr(),
                   Ad.n_rows, x.shape[0], T, n_tiles, Dpad, stream)
    if rc != 0:
        raise DeviceError(f"shift_spmv kernel launch failed (code {rc})")
    LAUNCHES[f"{_SHORT[cp.vals.dtype]}.{_SHORT[x.dtype]}"] += 1
    return out
