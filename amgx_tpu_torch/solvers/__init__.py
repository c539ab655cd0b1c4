from .base import (Solver, SolverFactory, SolveResult, check_convergence,
                   register_solver)
from . import amg_solver, dense_lu, dilu, jacobi, krylov  # noqa: F401

__all__ = ["Solver", "SolverFactory", "SolveResult", "check_convergence",
           "register_solver"]
