from .poisson import (poisson5pt, poisson7pt, poisson7pt_dia,
                      poisson7pt_offsets)
from .device_gen import poisson7pt_device

__all__ = ["poisson5pt", "poisson7pt", "poisson7pt_dia",
           "poisson7pt_offsets", "poisson7pt_device"]
