"""Precision policy: tolerance floors and the promotion ladder
(port of ``amgx_tpu/core/precision.py``).

A solve whose tolerance lies below its device dtype's floor runs as
defect correction: inner solves at the pack dtype, true residuals
recomputed one rung wider (f32 → f64), bounded by the precision of the
host matrix.  Host-side dtype arithmetic only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: relative-residual honesty multiplier: below ``FLOOR_ULPS·eps`` a
#: convergence claim in that dtype cannot be told from rounding noise
FLOOR_ULPS = 25.0

#: the promotion ladder, narrow to wide
LADDER = (np.dtype(np.float32), np.dtype(np.float64))


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
