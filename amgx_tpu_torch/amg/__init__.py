"""AMG: hierarchy setup, levels, cycles (port of ``amgx_tpu/amg``)."""
from .energymin import interpolator as _em  # noqa: F401  (registers EM)
from .cycles import build_cycle
from .hierarchy import AMGHierarchy
from .level import AggregationLevel, AMGLevel, ClassicalLevel

__all__ = ["AMGHierarchy", "build_cycle", "AMGLevel", "AggregationLevel",
           "ClassicalLevel"]
