"""amgx_tpu_torch — the PyTorch/CUDA port of ``amgx_tpu`` for NVIDIA
Hopper (H100).

This slice runs the headline stack end to end: FGMRES (restart 6)
preconditioned by GEO-aggregation AMG (K-cycle, block-Jacobi smoothing,
dense-LU coarsest solve) on DIA (stencil) operators, with the f32 → f64
defect-correction ladder.  Every DIA SpMV on a CUDA tensor runs the
hand-written kernel ``csrc/dia_spmv.cu``; CPU tensors take its plain
PyTorch version.  Data entry points default to ``device="cuda"`` and
raise when no card is present.

The package imports ``torch``, ``numpy`` and ``scipy`` — never ``jax``
and nothing of ``amgx_tpu``.
"""
from __future__ import annotations

from . import errors, io
from .config import AMGConfig
from .core import DeviceMatrix, Matrix
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
    "blas", "spmv", "io", "errors",
]
