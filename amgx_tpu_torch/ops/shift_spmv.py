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
f32) and (f64, f64).  :func:`shift_spmv` runs the plain version only for
CPU tensors; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from ..errors import BadParametersError, DeviceError

#: max distinct diffs per tile (``_MAX_CLASSES`` upstream)
_MAX_CLASSES = 32
#: default rows per tile (``_TILE`` upstream)
_TILE = 8192

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
    of the same planes, and :func:`shift_spmv` refuses a type pair the
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


def _kernel():
    global _fn
    if _fn is None:
        from .. import native
        fn = native.load("shift_spmv").amgx_shift_spmv
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(Ad, x: torch.Tensor):
    if (Ad.sh_vals.dtype, x.dtype) not in SUPPORTED:
        raise BadParametersError(
            f"shift_spmv: unsupported (vals, x) dtypes "
            f"({Ad.sh_vals.dtype}, {x.dtype})")
    if x.dim() != 1 or x.shape[0] != Ad.n_cols:
        raise BadParametersError(
            f"shift_spmv: x must be ({Ad.n_cols},), got {tuple(x.shape)}")
    T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
    if Ad.sh_vals.numel() != n_tiles * Dpad * T or \
            tuple(Ad.sh_diffs.shape) != (n_tiles, Dpad) or \
            Ad.sh_diffs.dtype != torch.int32:
        raise BadParametersError("shift_spmv: planes and diff table do "
                                 "not match sh_dims")
    if not (Ad.sh_vals.device == Ad.sh_diffs.device == x.device):
        raise BadParametersError(
            f"shift_spmv: pack on {Ad.sh_vals.device}, x on {x.device}")
    if not (Ad.sh_vals.is_contiguous() and Ad.sh_diffs.is_contiguous()):
        raise BadParametersError("shift_spmv: planes must be contiguous")


def shift_spmv(Ad, x: torch.Tensor) -> torch.Tensor:
    """y = A·x through a shift pack (``Ad.sh_*``).  CUDA tensors launch
    the kernel (or raise: a missing ``nvcc``, a failed build or a refused
    launch is an error, never a fallback); CPU tensors take
    :func:`shift_spmv_reference`."""
    _check(Ad, x)
    if not x.is_cuda:
        return shift_spmv_reference(Ad.sh_vals, Ad.sh_diffs, Ad.sh_dims, x,
                                    Ad.n_rows)
    x = x.contiguous()
    T, n_tiles, Dpad = (int(v) for v in Ad.sh_dims[:3])
    out = torch.empty(Ad.n_rows, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(_TYPE_CODE[Ad.sh_vals.dtype], _TYPE_CODE[x.dtype],
                   Ad.sh_vals.data_ptr(), Ad.sh_diffs.data_ptr(),
                   x.data_ptr(), out.data_ptr(), Ad.n_rows, x.shape[0],
                   T, n_tiles, Dpad, stream)
    if rc != 0:
        raise DeviceError(f"shift_spmv kernel launch failed (code {rc})")
    LAUNCHES[f"{_SHORT[Ad.sh_vals.dtype]}.{_SHORT[x.dtype]}"] += 1
    return out
