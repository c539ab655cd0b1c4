"""Determinism checker: checksum checkpoints of intermediate buffers
(port of ``amgx_tpu/utils/determinism.py``).

Reference: ``base/include/determinism_checker.h:28-52`` —
``hash_path_determinism_checker::checkpoint/checksum`` used to debug
reproducibility; pairs with the ``determinism_flag`` config.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np
import torch


def checksum(data) -> str:
    """Stable content hash of an array or tensor (a device tensor is
    copied to the host); equal to the JAX package's for equal values,
    dtype and shape."""
    if isinstance(data, torch.Tensor):
        if data.dtype == torch.bfloat16:
            raise TypeError("checksum of a bf16 tensor: numpy has no "
                            "bfloat16; cast it first")
        data = data.detach().cpu().numpy()
    arr = np.asarray(data)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


class DeterminismChecker:
    """Record named checkpoints; compare across runs
    (``checkpoint(name, buf)`` in the reference)."""

    def __init__(self):
        self.path: List[Tuple[str, str]] = []

    def checkpoint(self, name: str, data) -> str:
        c = checksum(data)
        self.path.append((name, c))
        return c

    def digest(self) -> str:
        h = hashlib.sha256()
        for name, c in self.path:
            h.update(name.encode())
            h.update(c.encode())
        return h.hexdigest()[:16]

    def compare(self, other: "DeterminismChecker") -> List[str]:
        """Return the names of mismatching checkpoints."""
        bad = []
        for (n1, c1), (n2, c2) in zip(self.path, other.path):
            if n1 != n2 or c1 != c2:
                bad.append(n1)
        if len(self.path) != len(other.path):
            bad.append("<path length mismatch>")
        return bad

    def reset(self):
        self.path = []


_checker = DeterminismChecker()


def determinism_checker() -> DeterminismChecker:
    return _checker


#: Tie-break seed used when ``determinism_flag`` is off: one fixed
#: per-process seed rather than the global numpy RNG state, so results
#: never depend on what else the process computed.
SESSION_SEED = 0x5EED
