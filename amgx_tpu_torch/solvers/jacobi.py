"""Jacobi smoothers (port of ``BlockJacobiSolver``, ``JacobiL1Solver`` and
``setup_dinv`` of ``amgx_tpu/solvers/jacobi.py``; reference
``core/src/solvers/block_jacobi_solver.cu``, ``jacobi_l1_solver.cu``).

A sweep is ``x + ω·D⁻¹·(b − A·x)``: one SpMV plus elementwise work.  The
zero-initial-guess first sweep collapses to ``ω·D⁻¹·b``, as the
reference's fused kernels do (``block_jacobi_solver.cu:1240-1530``).
"""
from __future__ import annotations

import torch

from ..ops.spmv import abs_rowsum, spmv
from .base import Solver, register_solver


def invert_diag(d: torch.Tensor) -> torch.Tensor:
    """1/d where d != 0, else 0 — on the device, in d's dtype."""
    safe = torch.where(d == 0, torch.ones_like(d), d)
    return torch.where(d != 0, 1.0 / safe, torch.zeros_like(d))


def apply_dinv(dinv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """D⁻¹·v for a scalar (n,) or block (n, b, b) inverse diagonal and a
    flat vector (``_apply_dinv`` upstream).  The b×b form adds each row's
    b products left to right, one elementwise op at a time: a batched
    matrix product orders and fuses them its own way on each device, and
    the card's f32 results then differ from the CPU's."""
    if dinv.dim() == 1:
        return dinv * v
    b = dinv.shape[-1]
    p = dinv * v.reshape(-1, 1, b)
    out = p[..., 0]
    for c in range(1, b):
        out = out + p[..., c]
    return out.reshape(-1)


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


@register_solver("JACOBI_L1")
class JacobiL1Solver(Solver):
    """L1-Jacobi: x ← x + ω·D_l1⁻¹·(b − A·x) with D_l1[i] = Σ_j |a_ij|
    (reference ``jacobi_l1_solver.cu``).  The row sums come from the
    pack on its device (pad and explicit zeros add 0; a ``dia3`` level
    carries the row sums of its embedded form, whose rows off the C set
    are zero and so get D_l1 = 1)."""

    is_smoother = True

    def solver_setup(self):
        absrow = abs_rowsum(self.Ad)
        self.dinv = (1.0 / torch.where(absrow == 0, 1.0, absrow)) \
            .to(self.Ad.dtype)

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + self.relaxation_factor * self.dinv * r, state
