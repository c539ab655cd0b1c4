"""Sparse matrix–vector products (port of the scalar DIA dispatch of
``amgx_tpu/ops/spmv.py``; reference dispatch ``multiply.cu:75-196``).

``DISPATCH`` counts which path served each scalar DIA apply, under the
JAX package's labels: ``dia/kernel`` is the hand-written CUDA kernel
(every apply on a CUDA tensor), ``dia/slices`` the plain shifted-slices
version (CPU tensors only).
"""
from __future__ import annotations

import torch

from .dia_spmv import dia_spmv

DISPATCH = {"dia/kernel": 0, "dia/slices": 0}


def reset_dispatch() -> None:
    for k in DISPATCH:
        DISPATCH[k] = 0


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a DIA :class:`~amgx_tpu_torch.core.DeviceMatrix`;
    the result has dtype ``promote(A.dtype, x.dtype)``."""
    DISPATCH["dia/kernel" if x.is_cuda else "dia/slices"] += 1
    return dia_spmv(A.vals, x, A.dia_offsets)


def residual(A, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b − A·x (reference ``axmb``, fixed_cycle.cu:151)."""
    return b - spmv(A, x)
