"""Damped block Jacobi smoother (port of ``BlockJacobiSolver`` and
``setup_dinv`` of ``amgx_tpu/solvers/jacobi.py``; reference
``core/src/solvers/block_jacobi_solver.cu``).

A sweep is ``x + ω·D⁻¹·(b − A·x)``: one SpMV plus elementwise work.  The
zero-initial-guess first sweep collapses to ``ω·D⁻¹·b``, as the
reference's fused kernels do (``block_jacobi_solver.cu:1240-1530``).
"""
from __future__ import annotations

import torch

from ..ops.spmv import spmv
from .base import Solver, register_solver


def invert_diag(d: torch.Tensor) -> torch.Tensor:
    """1/d where d != 0, else 0 — on the device, in d's dtype."""
    safe = torch.where(d == 0, torch.ones_like(d), d)
    return torch.where(d != 0, 1.0 / safe, torch.zeros_like(d))


def setup_dinv(slv) -> torch.Tensor:
    """The inverted diagonal of a smoother's operator: the one the
    hierarchy derived on the device with the level when present, else
    inverted from the pack's own diagonal."""
    Ad, A = slv.Ad, slv.A
    if A is not None:
        cached = getattr(A, "_dinv_dev", None)
        if cached is not None and cached[0] == Ad.dtype:
            return cached[1]
    return invert_diag(Ad.diag)


@register_solver("BLOCK_JACOBI")
class BlockJacobiSolver(Solver):
    """Damped Jacobi: x ← x + ω·D⁻¹·(b − A·x) (scalar blocks)."""

    is_smoother = True

    def solver_setup(self):
        self.dinv = setup_dinv(self)

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + self.relaxation_factor * (self.dinv * r), state

    def apply(self, b, x0=None, n_iters=None):
        n = self.max_iters if n_iters is None else n_iters
        if x0 is None:
            # fused zero-initial-guess first sweep
            x = self.relaxation_factor * (self.dinv * b)
            start = 1
        else:
            x, start = x0, 0
        for i in range(start, n):
            x, _ = self.solve_iteration(b, x, (), i)
        return x
