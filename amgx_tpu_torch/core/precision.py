"""Precision policy: dtype resolution, tolerance floors, the promotion
ladder and the narrowing of device packs (port of
``amgx_tpu/core/precision.py``).

Three tiers, as upstream:

* **storage** — AMG level operators, smoother data and transfer packs
  may live in bfloat16 (``hierarchy_dtype``): SpMV is memory-bound, and
  every SpMV over a bf16 pack accumulates in f32 (kernels B1, B3 and B5
  widen each value in registers) and returns ``promote_types(A, x)``;
* **Krylov** — the top-level solver's pack dtype (``krylov_dtype`` /
  ``tpu_matrix_dtype``) is its vectors', dots' and monitor's dtype;
* **refinement** — tolerances below the Krylov dtype's floor promote
  through the defect-correction ladder (bf16 → f32 → f64, one rung of at
  most twice the itemsize), bounded by the host matrix.

numpy has no bfloat16: the port keys a bf16 storage dtype as
``torch.bfloat16`` (:func:`~..device.storage_dtype`) and every other as
a numpy dtype.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: the names the dtype-valued config knobs accept
DTYPE_NAMES = ("default", "float64", "float32", "bfloat16")

#: relative-residual honesty multiplier: below ``FLOOR_ULPS·eps`` a
#: convergence claim in that dtype cannot be told from rounding noise
FLOOR_ULPS = 25.0

#: the promotion ladder, narrow to wide
LADDER = (np.dtype(np.float32), np.dtype(np.float64))


def resolve_dtype(name: "str | None"):
    """The storage dtype a config knob names (``torch.bfloat16`` or a
    numpy dtype), or None for ``default``; an unknown name raises."""
    if name is None:
        return None
    name = str(name).strip()
    if name in ("", "default"):
        return None
    if name not in DTYPE_NAMES:
        from ..errors import BadParametersError
        raise BadParametersError(
            f"unknown precision {name!r}; allowed: {DTYPE_NAMES}")
    from ..device import storage_dtype
    return storage_dtype(name)


def _finfo(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.finfo(dtype)
    return np.finfo(np.dtype(dtype))


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def is_floating(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return bool(np.issubdtype(np.dtype(dtype), np.floating))


def is_sub_f32(dtype) -> bool:
    """True for floating dtypes narrower than float32 (bf16/f16)."""
    return is_floating(dtype) and _itemsize(dtype) < 4


def compute_dtype(dtype):
    """The accumulation dtype of arithmetic over ``dtype`` storage: at
    least f32.  Returns the same kind (torch or numpy) it was given."""
    if is_sub_f32(dtype):
        return torch.float32 if isinstance(dtype, torch.dtype) \
            else np.dtype(np.float32)
    return dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype)


def tolerance_floor(dtype) -> float:
    """Smallest relative residual honestly reachable in ``dtype``."""
    return FLOOR_ULPS * float(_finfo(dtype).eps)


def promotion_target(device_dtype, host_dtype,
                     tolerance: float) -> Optional[np.dtype]:
    """The narrowest ladder rung that honestly reaches ``tolerance``:
    wider than the device dtype, within the host matrix's precision, at
    most twice the device itemsize (one rounding-residue plane), with a
    floor at or below the tolerance.  None when no promotion is needed
    or none is possible."""
    if not is_floating(device_dtype):
        return None
    if tolerance >= tolerance_floor(device_dtype):
        return None
    d_size, h_size = _itemsize(device_dtype), _itemsize(host_dtype)
    for rung in LADDER:
        if rung.itemsize <= d_size or rung.itemsize > h_size:
            continue
        if rung.itemsize > 2 * d_size:
            continue
        if tolerance >= tolerance_floor(rung):
            return rung
    return None


def narrowable_pack(dm) -> bool:
    """Can this device pack be narrowed to bf16 without losing its SpMV
    kernel (``narrowable_pack`` upstream, on the port's pack kinds)?
    DIA, block-DIA and ``dia3`` narrow (B1 has a (bf16, f32) pair), and
    so do block-native binned planes (B5) and a plain scalar ELL pack
    (B3); scalar binned planes (B4) and tile-DIA shift packs (B2) keep
    their dtype, as the JAX package keeps its f32-only layouts.  A CSR
    pack without planes narrows (its plain segment sum widens each
    value)."""
    if getattr(dm, "fmt", "") == "dia3":
        return True
    if getattr(dm, "bn_codes", None) is not None:
        from ..ops.binned_spmv import bn_block_dim
        return bn_block_dim(getattr(dm, "bn_dims", ())) > 1
    return getattr(dm, "sh_vals", None) is None


def device_cast(dm, dtype):
    """An already-built device pack cast to ``dtype`` on its device (no
    re-upload); ``dm`` itself when a bf16 cast would lose its kernel
    (:func:`narrowable_pack`)."""
    from ..device import storage_dtype
    dtype = storage_dtype(dtype)
    if is_sub_f32(dtype) and not narrowable_pack(dm):
        return dm
    return dm.astype(dtype)


def precision_view(parent, dtype):
    """A shallow Matrix view of ``parent`` whose device pack lives in
    ``dtype`` while every host structure (scipy matrix, diagonals,
    hints, geometry) stays shared and wide (``precision_view``
    upstream).  With a parent pack the view casts it on the device (no
    bytes over the wire) and records the value chain in
    ``_pack_cast_via`` (the view holds dtype(parent_dtype(v)), which
    the refinement's exactness test must follow); without one the view's
    ``device_dtype`` makes the next upload narrow.  Returns ``parent``
    itself when its pack may not narrow.

    The wide pack stays reachable as ``_setup_wide`` until the hierarchy
    has set up the view's smoother (:func:`release_setup_wide`): a
    narrow level's inverted diagonal, block inverse and L1 row sums are
    computed from the wide values, then stored narrow."""
    import copy
    from ..device import storage_dtype
    dtype = storage_dtype(dtype)
    m = copy.copy(parent)
    m.device_dtype = dtype
    m._dinv_dev = None
    dev = getattr(parent, "_device", None)
    if dev is not None:
        cast = device_cast(dev, dtype)
        if cast is dev:
            return parent
        m._device = cast
        m._device_dtype = dtype
        m._pack_cast_via = storage_dtype(dev.dtype)
        m._setup_wide = dev
        cached = getattr(parent, "_dinv_dev", None)
        if dev.dtype.is_complex and not cast.dtype.is_complex:
            # a complex pack cast to a real dtype keeps its real parts,
            # as the JAX package's cast does; the smoother's setup reads
            # those real parts at the wide precision (1/Re(d), not
            # Re(1/d))
            m._setup_wide = dev.astype(dev.dtype.to_real())
            cached = None
        if cached is not None:
            m._dinv_dev = (cast.dtype, cached[1].to(cast.dtype))
    else:
        m._device = None
        m._device_dtype = None
    return m


def release_setup_wide(m) -> None:
    """Drop a precision view's reference to its wide pack (after its
    smoother's setup)."""
    if m is not None:
        m.__dict__.pop("_setup_wide", None)
