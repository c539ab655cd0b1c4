"""Energy-minimisation AMG: the EM interpolator (registers on import)."""
from . import interpolator  # noqa: F401
