"""amgx_tpu_torch — the PyTorch/CUDA port of ``amgx_tpu`` for NVIDIA
Hopper (H100).

Three paths run end to end:

* FGMRES (restart 6) + GEO-aggregation AMG on DIA (stencil) operators;
* PCG + classical AMG (PMIS, D2, L1-Jacobi) on uploaded CSR matrices;
* BiCGStab + multicolor DILU on b×b block systems (BASELINE config 4):
  block-DIA packs, or the binned sliced-ELL planes (block-native, or the
  scalar expansion with ``AMGX_BLOCK_NATIVE=0``).

All three run the f32 → f64 defect-correction ladder.  Every SpMV on a
CUDA tensor runs a hand-written kernel under ``csrc/`` (DIA: B1, ELL:
B3, binned: B4 scalar and B5 block); CPU tensors take each kernel's
plain PyTorch version.  Data entry points default to ``device="cuda"``
and raise when no card is present.

The package imports ``torch``, ``numpy`` and ``scipy`` — never ``jax``
and nothing of ``amgx_tpu``.
"""
from __future__ import annotations

from . import errors, io
from .config import AMGConfig
from .core import DeviceMatrix, Matrix, pack_kind
from .errors import RC, AMGXError, SolveStatus
from .ops import blas
from .ops.spmv import spmv
from .solvers import Solver, SolverFactory, SolveResult

__version__ = "0.1.0"


def create_solver(config) -> Solver:
    """Build the outer solver described by a config (JSON dict/string or
    ``key=value`` string, or an :class:`AMGConfig`)."""
    cfg = config if isinstance(config, AMGConfig) else AMGConfig(config)
    return SolverFactory.allocate(cfg, "default", "solver")


__all__ = [
    "create_solver", "AMGConfig", "Matrix", "DeviceMatrix", "Solver",
    "SolverFactory", "SolveResult", "RC", "SolveStatus", "AMGXError",
    "blas", "spmv", "io", "errors", "pack_kind",
]
