"""DIA SpMV: the hand-written Hopper kernel and its plain version.

Replaces ``amgx_tpu/ops/pallas_spmv.py::_dia_spmv_call`` (the Pallas TPU
kernel, ``pl.pallas_call`` at :101).  The kernel is
``csrc/dia_spmv.cu``; see its header for the bound and the design.

Contract: ``y[i] = Σ_k vals[k, i] · x[i + offsets[k]]`` for ``i <
vals.shape[1]``, with ``x`` read as zero outside ``[0, len(x))``, summed
in ``x``'s dtype.  The output dtype is ``promote(vals, x)``, which for
the four supported pairs (vals, x) — (bf16, f32), (f32, f32),
(f32, f64), (f64, f64) — is always ``x``'s dtype.  Any other pair
raises.

:func:`dia_spmv` runs the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from ..errors import BadParametersError, DeviceError

MAX_DIAGS = 48

#: kernel type codes (``TypeCode`` in csrc/dia_spmv.cu)
_TYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_SHORT = {torch.float32: "f32", torch.float64: "f64",
          torch.bfloat16: "bf16"}
SUPPORTED = ((torch.bfloat16, torch.float32), (torch.float32, torch.float32),
             (torch.float32, torch.float64), (torch.float64, torch.float64))

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


def _kernel():
    global _fn
    if _fn is None:
        from .. import native
        fn = native.load("dia_spmv").amgx_dia_spmv
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(vals: torch.Tensor, x: torch.Tensor, offsets: Sequence[int]):
    if vals.dim() != 2 or x.dim() != 1:
        raise BadParametersError(
            f"dia_spmv: vals must be (nd, n) and x (n_cols,), got "
            f"{tuple(vals.shape)} and {tuple(x.shape)}")
    nd = vals.shape[0]
    if len(offsets) != nd or not 1 <= nd <= MAX_DIAGS:
        raise BadParametersError(
            f"dia_spmv: {len(offsets)} offsets for {nd} diagonals "
            f"(1..{MAX_DIAGS} supported)")
    if (vals.dtype, x.dtype) not in SUPPORTED:
        raise BadParametersError(
            f"dia_spmv: unsupported (vals, x) dtypes "
            f"({vals.dtype}, {x.dtype})")
    if vals.device != x.device:
        raise BadParametersError(
            f"dia_spmv: vals on {vals.device}, x on {x.device}")
    if not (vals.is_contiguous() and x.is_contiguous()):
        raise BadParametersError("dia_spmv: vals and x must be contiguous")


def dia_spmv_reference(vals: torch.Tensor, x: torch.Tensor,
                       offsets: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version (the analog of the shifted-slices path,
    ``amgx_tpu/ops/spmv.py:135-148``): nd multiply-adds over statically
    shifted slices of one zero-padded copy of x, in x's dtype."""
    n, n_cols = vals.shape[1], x.shape[0]
    lo = max(0, -min(offsets))
    hi = max(0, n + max(offsets) - n_cols)
    xp = torch.nn.functional.pad(x, (lo, hi))
    acc = None
    for k, o in enumerate(offsets):
        term = vals[k].to(x.dtype) * xp[lo + o:lo + o + n]
        acc = term if acc is None else acc + term
    return acc


def dia_spmv(vals: torch.Tensor, x: torch.Tensor,
             offsets: Sequence[int]) -> torch.Tensor:
    """y = A·x for the row-aligned DIA operator (``vals``, ``offsets``).

    CUDA tensors launch the kernel (or raise: a missing ``nvcc``, a
    failed build or a refused launch is an error, never a fallback);
    CPU tensors take :func:`dia_spmv_reference`."""
    offsets = [int(o) for o in offsets]
    _check(vals, x, offsets)
    if not x.is_cuda:
        return dia_spmv_reference(vals, x, offsets)
    n = vals.shape[1]
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(_TYPE_CODE[vals.dtype], _TYPE_CODE[x.dtype],
                   vals.data_ptr(), x.data_ptr(), out.data_ptr(), n,
                   x.shape[0], len(offsets), ctypes.addressof(offs),
                   stream)
    if rc != 0:
        raise DeviceError(f"dia_spmv kernel launch failed (code {rc})")
    LAUNCHES[f"{_SHORT[vals.dtype]}.{_SHORT[x.dtype]}"] += 1
    return out
