"""Error codes and the exception model (a copy of ``amgx_tpu.errors``).

Exceptions raised internally carry an ``AMGX_RC`` code
(``base/include/amgx_c.h:74-92``); :class:`FailureKind` is the
structured vocabulary a failed solve reports.  The package keeps its own
copy so that importing it never runs ``amgx_tpu/__init__.py`` (which
configures JAX process-wide).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class RC(enum.IntEnum):
    """Return codes — numeric values match ``amgx_c.h:74-92`` (AMGX_RC)."""

    OK = 0
    BAD_PARAMETERS = 1
    UNKNOWN = 2
    NOT_SUPPORTED_TARGET = 3
    NOT_SUPPORTED_BLOCKSIZE = 4
    CUDA_FAILURE = 5
    THRUST_FAILURE = 6
    NO_MEMORY = 7
    IO_ERROR = 8
    BAD_MODE = 9
    CORE = 10
    PLUGIN = 11
    BAD_CONFIGURATION = 12
    NOT_IMPLEMENTED = 13
    LICENSE_NOT_FOUND = 14
    INTERNAL = 15
    REJECTED = 16


class SolveStatus(enum.IntEnum):
    """Solve status — values match ``amgx_c.h`` AMGX_SOLVE_STATUS."""

    SUCCESS = 0
    FAILED = 1
    DIVERGED = 2
    NOT_CONVERGED = 2  # alias, as in the reference header


class FailureKind(str, enum.Enum):
    """What went wrong in a solve that did not converge (the members
    this slice's solvers can report; values as in ``amgx_tpu``)."""

    NAN_POISON = "nan_poison"
    STAGNATION = "stagnation"
    DIVERGENCE = "divergence"


@dataclasses.dataclass(frozen=True)
class FailureInfo:
    """The failure kind of a terminal solve plus the first iteration it
    was observed at (None when it has no iteration anchor)."""

    kind: FailureKind
    iteration: Optional[int] = None
    detail: str = ""


class AMGXError(Exception):
    """Internal exception carrying an RC code (reference: ``FatalError``)."""

    def __init__(self, message: str, rc: RC = RC.UNKNOWN):
        super().__init__(message)
        self.rc = RC(rc)


class BadParametersError(AMGXError):
    def __init__(self, message: str):
        super().__init__(message, RC.BAD_PARAMETERS)


class BadConfigurationError(AMGXError):
    def __init__(self, message: str):
        super().__init__(message, RC.BAD_CONFIGURATION)


class NotImplementedError_(AMGXError, NotImplementedError):
    """A feature of a later slice of the port: raised instead of taking a
    silently different path."""

    def __init__(self, message: str):
        super().__init__(message, RC.NOT_IMPLEMENTED)


class DeviceError(AMGXError):
    """The requested device (or a kernel on it) is unavailable."""

    def __init__(self, message: str):
        super().__init__(message, RC.CUDA_FAILURE)
