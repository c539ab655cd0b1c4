"""AMG as a Solver (port of ``amgx_tpu/solvers/amg_solver.py``;
reference ``algebraic_multigrid_solver.cu``): one solve iteration is one
multigrid cycle, so AMG serves as the main solver, a preconditioner or a
smoother.
"""
from __future__ import annotations

from ..amg.cycles import build_cycle
from ..amg.hierarchy import AMGHierarchy
from ..errors import BadConfigurationError
from .base import Solver, register_solver


@register_solver("AMG")
class AMGSolver(Solver):
    is_smoother = True

    def solver_setup(self):
        if self.A is None:
            raise BadConfigurationError(
                "AMG setup requires the matrix handle (upload via Matrix)")
        self.hierarchy = AMGHierarchy(self.cfg, self.scope)
        self.hierarchy.setup(self.A)
        self._cycle = build_cycle(self.hierarchy)

    def solve_iteration(self, b, x, state, iter_idx):
        return self._cycle(b, x), state
