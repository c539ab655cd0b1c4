from .base import (Solver, SolverFactory, SolveResult, check_convergence,
                   register_solver)
from . import (amg_solver, chebyshev, dense_lu, dilu, gs, idr,  # noqa: F401
               ilu, jacobi, krylov)

__all__ = ["Solver", "SolverFactory", "SolveResult", "check_convergence",
           "register_solver"]
