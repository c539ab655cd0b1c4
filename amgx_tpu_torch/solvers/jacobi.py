"""Jacobi smoothers (port of ``BlockJacobiSolver``, ``JacobiL1Solver``,
``CFJacobiSolver`` and ``setup_dinv`` of ``amgx_tpu/solvers/jacobi.py``;
reference ``core/src/solvers/block_jacobi_solver.cu``,
``jacobi_l1_solver.cu``, ``cf_jacobi_solver.cu``).

A sweep is ``x + ω·D⁻¹·(b − A·x)``: one SpMV plus elementwise work.  The
zero-initial-guess first sweep collapses to ``ω·D⁻¹·b``, as the
reference's fused kernels do (``block_jacobi_solver.cu:1240-1530``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.ordered import guarded_block_inv, mul, recip
from ..ops.spmv import abs_rowsum, spmv
from .base import Solver, register_solver


def invert_diag(d: torch.Tensor) -> torch.Tensor:
    """1/d where d != 0, else 0 — on the device, in d's dtype (a complex
    d by :func:`~..ops.ordered.recip`)."""
    safe = torch.where(d == 0, torch.ones_like(d), d)
    return torch.where(d != 0, recip(safe), torch.zeros_like(d))


def apply_dinv(dinv: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """D⁻¹·v for a scalar (n,) or block (n, b, b) inverse diagonal and a
    flat vector (``_apply_dinv`` upstream).  The b×b form adds each row's
    b products left to right, one elementwise op at a time: a batched
    matrix product orders and fuses them its own way on each device, and
    the card's f32 results then differ from the CPU's."""
    if dinv.dim() == 1:
        return mul(dinv, v)
    b = dinv.shape[-1]
    p = mul(dinv, v.reshape(-1, 1, b))
    out = p[..., 0]
    for c in range(1, b):
        out = out + p[..., c]
    return out.reshape(-1)


def setup_source(slv):
    """The pack a smoother's setup reads: the wide pack of a bf16 level
    while the level keeps it (``Matrix._setup_wide``,
    :func:`~..core.precision.precision_view`), else the smoother's own
    pack.  A narrow level's smoother data is computed from the wide
    values and stored narrow."""
    A = slv.A
    wide = getattr(A, "_setup_wide", None) if A is not None else None
    return wide if wide is not None else slv.Ad


def setup_dinv(slv) -> torch.Tensor:
    """The inverted (block) diagonal of a smoother's operator: the one the
    hierarchy derived on the device with the level when present, else
    inverted on the device from the diagonal of :func:`setup_source` —
    elementwise for a scalar pack, the (n, b, b) blocks under the guarded
    rule of :func:`~..ops.ordered.guarded_block_inv` for a block pack (a
    bf16 diagonal inverts in f32) — and stored in the pack's dtype."""
    Ad, A = slv.Ad, slv.A
    if A is not None:
        cached = getattr(A, "_dinv_dev", None)
        if cached is not None and cached[0] == Ad.dtype:
            return cached[1]
    d = setup_source(slv).diag
    if d.dtype == torch.bfloat16:
        d = d.float()
    if d.dim() == 1:
        return invert_diag(d).to(Ad.dtype)
    return guarded_block_inv(d).to(Ad.dtype)


@register_solver("BLOCK_JACOBI")
class BlockJacobiSolver(Solver):
    """Damped (block) Jacobi: x ← x + ω·D⁻¹·(b − A·x), D⁻¹ applied by
    :func:`apply_dinv` (scalar or b×b blocks)."""


    is_smoother = True

    def solver_setup(self):
        self.dinv = setup_dinv(self)

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + self.relaxation_factor * apply_dinv(self.dinv, r), state

    def apply(self, b, x0=None, n_iters=None):
        n = self.max_iters if n_iters is None else n_iters
        if x0 is None:
            # fused zero-initial-guess first sweep
            x = self.relaxation_factor * apply_dinv(self.dinv, b)
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
    pack on its device (the wide pack of a bf16 level,
    :func:`setup_source`; pad and explicit zeros add 0; a ``dia3`` level
    carries the row sums of its embedded form, whose rows off the C set
    are zero and so get D_l1 = 1; a sharded pack's halo entries belong to
    their row, its padding rows sum to 1)."""

    is_smoother = True

    def solver_setup(self):
        absrow = abs_rowsum(setup_source(self))
        self.dinv = (1.0 / torch.where(absrow == 0, 1.0, absrow)) \
            .to(self.Ad.dtype)

    def solve_iteration(self, b, x, state, iter_idx):
        r = b - spmv(self.Ad, x)
        return x + mul(self.relaxation_factor * self.dinv, r), state


@register_solver("CF_JACOBI")
class CFJacobiSolver(Solver):
    """C/F-split Jacobi for classical AMG (reference
    ``cf_jacobi_solver.cu``): one sweep relaxes the C points, then the F
    points (``cf_smoothing_mode`` 0 or 2; else F then C), each a masked
    ``x + ω·D⁻¹·(b − A·x)``.  The split is the ``cf_map`` (1 = C) that a
    classical level exposes on its matrix; without one no point is
    marked C, as in the JAX package."""

    is_smoother = True

    def solver_setup(self):
        self.dinv = setup_dinv(self)
        self.cf_mode = int(self.cfg.get("cf_smoothing_mode", self.scope))
        cf = getattr(self.A, "cf_map", None) if self.A is not None else None
        if cf is None:
            cf = np.zeros(self.Ad.n_rows, dtype=bool)
        c = np.repeat(np.asarray(cf, dtype=bool), self.Ad.block_dim)
        self.c_mask = torch.from_numpy(c).to(self.Ad.device)

    def _masked_sweep(self, b, x, mask):
        r = b - spmv(self.Ad, x)
        dx = self.relaxation_factor * apply_dinv(self.dinv, r)
        return x + torch.where(mask, dx, torch.zeros_like(dx))

    def solve_iteration(self, b, x, state, iter_idx):
        m1 = self.c_mask if self.cf_mode in (0, 2) else ~self.c_mask
        x = self._masked_sweep(b, x, m1)
        return self._masked_sweep(b, x, ~m1), state
