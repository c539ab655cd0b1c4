"""ELL SpMV: the hand-written Hopper kernel and its plain version.

Replaces ``amgx_tpu/ops/pallas_ell.py::_ell_window_call`` (the Pallas TPU
kernel, ``pl.pallas_call`` at :209).  The kernel is
``csrc/ell_spmv.cu``; see its header for the bound and the design.

Contract: ``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` for the (n, K)
row-major pack, ``cols`` int32, rectangular allowed (``len(x)`` is the
column count), columns outside ``[0, len(x))`` skipped; ``cols=None``
means dense rows (column k is k, K == ``len(x)``: a dense matrix-vector
product with no column table, :func:`dense_matvec`); summed in ``x``'s
dtype in the kernel's order (:func:`lanes`): each of L lanes sums the
entries k = l, l + L, … left to right, then the lanes fold in halves.
Each product and sum is rounded on its own, so the card and the CPU give
the same bits.  Type pairs (vals, x): (f32, f32) and (f64, f64); any
other pair raises.

:func:`ell_spmv` runs the plain version only for CPU tensors; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..errors import BadParametersError, DeviceError

#: kernel type codes (``TypeCode`` in csrc/ell_spmv.cu)
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


def _kernel():
    global _fn
    if _fn is None:
        from .. import native
        fn = native.load("ell_spmv").amgx_ell_spmv
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(cols: Optional[torch.Tensor], vals: torch.Tensor,
           x: torch.Tensor):
    if cols is None:
        if vals.dim() != 2 or x.dim() != 1 or vals.shape[1] != x.shape[0]:
            raise BadParametersError(
                f"ell_spmv: dense rows need vals (n, len(x)), got "
                f"{tuple(vals.shape)} and x {tuple(x.shape)}")
    elif cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 1:
        raise BadParametersError(
            f"ell_spmv: cols and vals must be one (n, K) shape and x "
            f"(n_cols,), got {tuple(cols.shape)}, {tuple(vals.shape)} and "
            f"{tuple(x.shape)}")
    elif cols.dtype != torch.int32:
        raise BadParametersError(f"ell_spmv: cols must be int32, got "
                                 f"{cols.dtype}")
    if (vals.dtype, x.dtype) not in SUPPORTED:
        raise BadParametersError(
            f"ell_spmv: unsupported (vals, x) dtypes ({vals.dtype}, "
            f"{x.dtype})")
    devices = {vals.device, x.device} | ({cols.device} if cols is not None
                                         else set())
    if len(devices) != 1:
        raise BadParametersError(
            f"ell_spmv: operands on {sorted(map(str, devices))}")
    if not (vals.is_contiguous() and x.is_contiguous()
            and (cols is None or cols.is_contiguous())):
        raise BadParametersError(
            "ell_spmv: cols, vals and x must be contiguous")


def lanes(K: int) -> int:
    """The kernel's lanes a row: the smallest power of two ≥ K, at most
    32 (``launch`` in csrc/ell_spmv.cu)."""
    L = 1
    while L < min(K, 32):
        L *= 2
    return L


def ell_spmv_reference(cols: Optional[torch.Tensor], vals: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the gather path of
    ``amgx_tpu/ops/spmv.py:191-193``) in the kernel's order: the products
    ``vals · x[cols]`` (out-of-range columns count as zero; ``vals · x``
    for dense rows) summed per lane left to right, then the lanes folded
    in halves, one elementwise add at a time."""
    n, K = vals.shape
    if cols is None:
        p = vals * x
    else:
        ok = (cols >= 0) & (cols < x.shape[0])
        if bool(ok.all()):
            p = vals * x[cols]
        else:
            p = torch.where(ok, vals * x[torch.where(ok, cols, 0)], 0)
    L = lanes(K)
    if K < L:
        acc = torch.nn.functional.pad(p, (0, L - K))
    else:
        acc = p[:, :L].clone()
        for s0 in range(L, K, L):
            w = min(L, K - s0)
            acc[:, :w] += p[:, s0:s0 + w]
    while L > 1:
        L //= 2
        acc = acc[:, :L] + acc[:, L:2 * L]
    return acc[:, 0]


def ell_spmv(cols: Optional[torch.Tensor], vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A·x for the ELL operator (``cols``, ``vals``; ``cols=None``
    for dense rows).

    CUDA tensors launch the kernel (or raise: a missing ``nvcc``, a
    failed build or a refused launch is an error, never a fallback);
    CPU tensors take :func:`ell_spmv_reference`."""
    _check(cols, vals, x)
    if not x.is_cuda:
        return ell_spmv_reference(cols, vals, x)
    n, K = vals.shape
    out = torch.empty(n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()(_TYPE_CODE[vals.dtype], _TYPE_CODE[x.dtype],
                   None if cols is None else cols.data_ptr(),
                   vals.data_ptr(), x.data_ptr(),
                   out.data_ptr(), n, K, x.shape[0], stream)
    if rc != 0:
        raise DeviceError(f"ell_spmv kernel launch failed (code {rc})")
    LAUNCHES[f"{_SHORT[vals.dtype]}.{_SHORT[x.dtype]}"] += 1
    return out


def dense_matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = M·x for a dense (n, len(x)) row-major M, through the same
    kernel over dense rows (no column table), summed in its lane order."""
    return ell_spmv(None, M, x)
