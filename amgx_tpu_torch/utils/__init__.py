"""Utilities (port of ``amgx_tpu/utils``; ``matrix_analysis`` comes
with the C API, ROADMAP item 9c)."""
from . import faultinject
from .determinism import DeterminismChecker, checksum, determinism_checker
from .logging import (amgx_distributed_output, amgx_output, error_output,
                      get_verbosity, register_print_callback,
                      set_verbosity)
from .memory import MemoryInfo, memory_info
from .profiler import TimerMap, cpu_profiler, profiler_tree
from .retry import RetryPolicy, retry_call

__all__ = ["amgx_output", "error_output", "amgx_distributed_output",
           "register_print_callback", "set_verbosity", "get_verbosity",
           "cpu_profiler", "profiler_tree", "TimerMap",
           "checksum", "determinism_checker", "DeterminismChecker",
           "memory_info", "MemoryInfo",
           "RetryPolicy", "retry_call", "faultinject"]
