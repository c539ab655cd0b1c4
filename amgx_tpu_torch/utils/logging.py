"""Print-callback logging (a copy of ``amgx_tpu/utils/logging.py``).

The reference routes all library output through a host-app-registered
callback (``AMGX_register_print_callback``, ``amgx_c.h:212``;
``amgx_output`` / ``error_output`` / ``amgx_distributed_output``,
``base/include/misc.h:33-36``).  Same indirection here.

Output is level-gated: each message declares a verbosity ``level``
(1 = essential solver output, 2 = informational tables such as grid
stats, 3 = chatty diagnostics) and is emitted only when the configured
``_verbosity`` is at least that level — previously any nonzero
verbosity printed everything.  ``error_output`` is never gated.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional

_print_callback: Optional[Callable[[str], None]] = None
_verbosity = 3


def register_print_callback(fn: Optional[Callable[[str], None]]):
    global _print_callback
    _print_callback = fn


def set_verbosity(level: int):
    global _verbosity
    _verbosity = int(level)


def get_verbosity() -> int:
    return _verbosity


def amgx_output(msg: str, level: int = 1):
    """Emit ``msg`` through the registered callback (or stdout) when the
    configured verbosity is at least ``level``."""
    if _verbosity <= 0 or _verbosity < int(level):
        return
    if _print_callback is not None:
        _print_callback(msg)
    else:
        sys.stdout.write(msg)


def error_output(msg: str):
    if _print_callback is not None:
        _print_callback(msg)
    else:
        sys.stderr.write(msg)


def amgx_distributed_output(msg: str, rank: int = 0, level: int = 1):
    """Only rank 0 prints (reference amgx_distributed_output)."""
    if rank == 0:
        amgx_output(msg, level=level)
