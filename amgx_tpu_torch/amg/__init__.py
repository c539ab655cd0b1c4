"""AMG: hierarchy setup, levels, cycles (port of ``amgx_tpu/amg``)."""
from .energymin import interpolator as _em  # noqa: F401  (registers EM)
