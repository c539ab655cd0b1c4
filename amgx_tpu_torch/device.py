"""Device and dtype resolution shared by every entry point.

Data entry points default to ``device="cuda"`` and raise when no card is
present: a solve never carries on on the CPU unless the caller asked for
``device="cpu"`` (as the CPU tests do).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .errors import BadParametersError, DeviceError

_NP_TO_TORCH = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.complex128): torch.complex128,
    np.dtype(np.complex64): torch.complex64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on; raises for a CUDA request
    on a machine without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise BadParametersError(f"unsupported device {device!r}")
    return dev


def _is_bf16(dtype) -> bool:
    """bfloat16 in any spelling: ``torch.bfloat16``, the name, or the
    ml_dtypes numpy type where the caller has one."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    return str(getattr(dtype, "name", dtype)).replace("torch.", "") == \
        "bfloat16" or getattr(dtype, "__name__", "") == "bfloat16"


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or a name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if _is_bf16(dtype):
        return torch.bfloat16
    dt = np.dtype(dtype)
    if dt not in _NP_TO_TORCH:
        raise BadParametersError(f"unsupported dtype {dtype!r}")
    return _NP_TO_TORCH[dt]


#: device→host fetches made by the setup code since the last reset — each
#: one makes the host wait for the device (``jax.device_get`` upstream)
HOST_SYNCS = {"count": 0}


def to_host(*tensors):
    """Fetch tensors as numpy arrays: one counted host sync for the lot
    (a single tensor comes back bare)."""
    HOST_SYNCS["count"] += 1
    out = [t.detach().cpu().numpy() for t in tensors]
    return out[0] if len(out) == 1 else out


def host_scalar(t: torch.Tensor):
    """A 0-d tensor's value as a Python number: one counted host sync."""
    HOST_SYNCS["count"] += 1
    return t.item()


def numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch or numpy dtype; bfloat16 (which numpy
    lacks) raises."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NP:
            raise BadParametersError(f"no numpy dtype for {dtype}")
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def storage_dtype(dtype):
    """A pack's storage dtype as the port keys it: ``torch.bfloat16`` for
    bfloat16 (numpy has no such type), else the numpy dtype; None stays
    None."""
    if dtype is None:
        return None
    if _is_bf16(dtype):
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return numpy_dtype(dtype)
    return np.dtype(dtype)


#: one lock per card: the work one thread runs there (a serving
#: session's setup and solves) excludes every other thread's, because a
#: CUDA graph's capture is invalidated by another thread's launch and a
#: replay writes fixed buffers
_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.RLock:
    """The re-entrant lock of the card ``device`` (index None: the
    current card)."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with _DEVICE_LOCKS_GUARD:
        lock = _DEVICE_LOCKS.get(idx)
        if lock is None:
            lock = _DEVICE_LOCKS[idx] = threading.RLock()
        return lock
