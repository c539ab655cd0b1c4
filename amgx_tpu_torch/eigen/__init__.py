"""Eigensolvers (port of ``amgx_tpu/eigen/``; reference plugin
``eigensolvers/``)."""
from .base import (EigenResult, EigenSolver, EigenSolverFactory,
                   register_eigensolver)
from . import algorithms  # noqa: F401  (registers the eight solvers)

__all__ = ["EigenSolver", "EigenSolverFactory", "EigenResult",
           "register_eigensolver"]
