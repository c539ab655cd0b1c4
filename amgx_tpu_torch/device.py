"""Device and dtype resolution shared by every entry point.

Data entry points default to ``device="cuda"`` and raise when no card is
present: a solve never carries on on the CPU unless the caller asked for
``device="cpu"`` (as the CPU tests do).
"""
from __future__ import annotations

import numpy as np
import torch

from .errors import BadParametersError, DeviceError

_NP_TO_TORCH = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
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


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or a name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt not in _NP_TO_TORCH:
        raise BadParametersError(f"unsupported dtype {dtype!r}")
    return _NP_TO_TORCH[dt]


def numpy_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch or numpy dtype; bfloat16 (which numpy
    lacks) raises."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NP:
            raise BadParametersError(f"no numpy dtype for {dtype}")
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)
