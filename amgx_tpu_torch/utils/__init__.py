"""Utilities (port of ``amgx_tpu/utils``)."""
from . import faultinject
from .determinism import DeterminismChecker, checksum, determinism_checker
from .logging import (amgx_distributed_output, amgx_output, error_output,
                      get_verbosity, register_print_callback,
                      set_verbosity)
from .matrix_analysis import analyze_matrix, estimate_spectral_bounds
from .memory import MemoryInfo, memory_info
from .profiler import TimerMap, cpu_profiler, profiler_tree
from .retry import RetryPolicy, retry_call

__all__ = ["amgx_output", "error_output", "amgx_distributed_output",
           "register_print_callback", "set_verbosity", "get_verbosity",
           "cpu_profiler", "profiler_tree", "TimerMap",
           "analyze_matrix", "estimate_spectral_bounds",
           "checksum", "determinism_checker", "DeterminismChecker",
           "memory_info", "MemoryInfo",
           "RetryPolicy", "retry_call", "faultinject"]
