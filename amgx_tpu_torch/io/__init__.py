from .poisson import (generate_distributed_poisson_7pt, poisson5pt,
                      poisson7pt, poisson7pt_dia, poisson7pt_offsets,
                      poisson9pt, poisson27pt)
from .device_gen import poisson7pt_device
from .dfg import dfg_cylinder_pressure
from .matrix_market import (SystemData, read_matrix_market,
                            write_matrix_market)
from .binary import read_binary, read_system_auto, write_binary
from .gauntlet import (SPE10_GRID, gauntlet_cases, load_via_matrix_market,
                       scattered_block_operator, spe10_block_system)

__all__ = ["poisson5pt", "poisson7pt", "poisson7pt_dia",
           "poisson7pt_offsets", "poisson7pt_device", "poisson9pt",
           "poisson27pt", "read_matrix_market",
           "write_matrix_market", "SystemData", "gauntlet_cases",
           "load_via_matrix_market", "scattered_block_operator",
           "spe10_block_system", "SPE10_GRID", "dfg_cylinder_pressure",
           "read_binary", "write_binary", "read_system_auto",
           "generate_distributed_poisson_7pt"]
