"""Dense LU coarse solver (port of ``amgx_tpu/solvers/dense_lu.py``;
reference ``core/src/solvers/dense_lu_solver.cu``).

The coarsest level is densified once at setup and LU-factorised with
``torch.linalg.lu_factor`` on its device (the JAX package uses
``jax.scipy.linalg.lu_factor`` outside Pallas: a library call, as the
reference's cusolverDn); each application is ``lu_solve``.  The factor
dtype floors at f32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import compute_dtype
from .base import Solver, register_solver


def densify_dia(Ad) -> np.ndarray:
    """Dense host copy of a (small) DIA pack."""
    vals = Ad.vals.detach().cpu().numpy()
    n, m = Ad.n_rows, Ad.n_cols
    out = np.zeros((n, m), dtype=vals.dtype)
    for k, o in enumerate(Ad.dia_offsets):
        rows = np.arange(max(0, -o), min(n, m - o))
        out[rows, rows + o] = vals[k, rows]
    return out


@register_solver("DENSE_LU_SOLVER")
class DenseLUSolver(Solver):
    is_smoother = False

    def solver_setup(self):
        fdt = compute_dtype(self.Ad.dtype)
        dense = torch.from_numpy(densify_dia(self.Ad)).to(
            device=self.Ad.device, dtype=fdt)
        self._lu, self._piv = torch.linalg.lu_factor(dense)

    def _lu_apply(self, b):
        # a wider vector than the factor promotes the factor
        wdt = torch.promote_types(b.dtype, self._lu.dtype)
        return torch.linalg.lu_solve(self._lu.to(wdt), self._piv,
                                     b.to(wdt).unsqueeze(1)).squeeze(1)

    def solve_iteration(self, b, x, state, iter_idx):
        return self._lu_apply(b), state

    def apply(self, b, x0=None, n_iters=None):
        return self._lu_apply(b)
