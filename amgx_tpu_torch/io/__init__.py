from .poisson import (poisson5pt, poisson7pt, poisson7pt_dia,
                      poisson7pt_offsets)
from .device_gen import poisson7pt_device
from .dfg import dfg_cylinder_pressure
from .matrix_market import (SystemData, read_matrix_market,
                            write_matrix_market)
from .gauntlet import (SPE10_GRID, gauntlet_cases, load_via_matrix_market,
                       scattered_block_operator, spe10_block_system)

__all__ = ["poisson5pt", "poisson7pt", "poisson7pt_dia",
           "poisson7pt_offsets", "poisson7pt_device", "read_matrix_market",
           "write_matrix_market", "SystemData", "gauntlet_cases",
           "load_via_matrix_market", "scattered_block_operator",
           "spe10_block_system", "SPE10_GRID", "dfg_cylinder_pressure"]
