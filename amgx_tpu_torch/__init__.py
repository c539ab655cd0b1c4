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
from .modes import MODE_IDS, PUBLIC_MODES, Mode, default_mode, parse_mode
from .ops import blas
from .ops.spmv import spmm, spmv
from .solvers import Solver, SolverFactory, SolveResult
from .utils import amgx_output, register_print_callback

__version__ = "0.1.0"
#: the AmgX release the port answers to (``ReleaseVersion.txt:1``;
#: ``AMGX_get_build_info_strings`` reports it)
__reference_version__ = "2.1.0.131-opensource"

_initialized = False


def initialize():
    """Library init (reference ``AMGX_initialize``, core.cu:739)."""
    global _initialized
    _initialized = True
    return RC.OK


def finalize():
    global _initialized
    _initialized = False
    return RC.OK


def get_api_version():
    return (2, 0)


def create_solver(config, mode: str = "dDDI") -> Solver:
    """Build the outer solver described by a config (JSON dict/string or
    ``key=value`` string, or an :class:`AMGConfig`).  ``mode`` is checked
    (an unknown mode raises); as in the JAX package the matrix, not the
    solver, carries the placement and the precision
    (:func:`parse_mode` gives them)."""
    parse_mode(mode)
    cfg = config if isinstance(config, AMGConfig) else AMGConfig(config)
    slv = SolverFactory.allocate(cfg, "default", "solver")
    # the outermost solver owns the solve boundary (precision knobs,
    # scaling, RCM)
    slv._toplevel = True
    return slv


__all__ = [
    "initialize", "finalize", "get_api_version", "spmm",
    "register_print_callback", "amgx_output", "create_solver", "AMGConfig", "Matrix", "DeviceMatrix", "Solver",
    "SolverFactory", "SolveResult", "RC", "SolveStatus", "AMGXError",
    "blas", "spmv", "io", "errors", "pack_kind", "Mode", "parse_mode",
    "default_mode", "PUBLIC_MODES", "MODE_IDS",
]
