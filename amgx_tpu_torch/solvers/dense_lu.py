"""Dense LU coarse solver and the identity solver NOSOLVER (port of
``amgx_tpu/solvers/dense_lu.py``; reference
``core/src/solvers/dense_lu_solver.cu``,
``base/src/solvers/dummy_solver.cu``).

The coarsest level (a DIA or ELL pack, or a block level's BSR) is
densified once at setup and
LU-factorised in f64 on the host (``scipy.linalg.lu_factor``; the JAX
package uses ``jax.scipy.linalg.lu_factor``, the reference cusolverDn);
the factors give the explicit inverse, stored in the factor dtype (at
least f32) on the pack's device.  Each application is one dense
matrix-vector product with it (:func:`~..ops.ordered.dense_matvec`:
kernel B3 over dense rows, its plain version on CPU tensors), which sums
in one order on every device — a library triangular solve on the card
and on the CPU would round its sums differently, and the f32 iteration
counts of the solves above follow those bits.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..core.precision import compute_dtype
from ..device import numpy_dtype
from ..ops.ordered import dense_matvec
from .base import Solver, register_solver


def densify(Ad) -> np.ndarray:
    """Dense host copy of a (small) DIA or ELL pack (a shift pack through
    its ELL views)."""
    vals = (Ad.ell_vals_view() if Ad.fmt == "ell" else Ad.vals) \
        .detach().cpu().numpy()
    n, m = Ad.n_rows, Ad.n_cols
    out = np.zeros((n, m), dtype=vals.dtype)
    if Ad.fmt == "ell":
        cols = Ad.ell_cols_view().detach().cpu().numpy()
        rows = np.repeat(np.arange(n), cols.shape[1])
        np.add.at(out, (rows, cols.reshape(-1)), vals.reshape(-1))
        return out
    for k, o in enumerate(Ad.dia_offsets):
        rows = np.arange(max(0, -o), min(n, m - o))
        out[rows, rows + o] = vals[k, rows]
    return out


@register_solver("DENSE_LU_SOLVER")
class DenseLUSolver(Solver):
    is_smoother = False

    def solver_setup(self):
        if self.Ad.block_dim > 1 and self.A is not None:
            # a b×b block coarsest level (block aggregation): its BSR
            dense = self.A.host.toarray().astype(np.float64)
        else:
            dense = densify(self.Ad).astype(np.float64)
        n = dense.shape[0]
        inv = scipy.linalg.lu_solve(scipy.linalg.lu_factor(dense),
                                    np.eye(n))
        fdt = compute_dtype(self.Ad.dtype)
        dev = self.Ad.device
        self._inv = {fdt: torch.from_numpy(np.ascontiguousarray(
            inv, dtype=numpy_dtype(fdt))).to(dev)}

    @property
    def inverse(self) -> torch.Tensor:
        """The (n, n) inverse in the factor dtype, as the solve applies
        it."""
        return next(iter(self._inv.values()))

    def _lu_apply(self, b):
        # a wider vector than the factor promotes the factor
        wdt = torch.promote_types(b.dtype, self.inverse.dtype)
        if wdt not in self._inv:
            self._inv[wdt] = self.inverse.to(wdt)
        return dense_matvec(self._inv[wdt], b.to(wdt).contiguous())

    def solve_iteration(self, b, x, state, iter_idx):
        return self._lu_apply(b), state

    def apply(self, b, x0=None, n_iters=None):
        return self._lu_apply(b)


@register_solver("NOSOLVER")
class DummySolver(Solver):
    """The identity (reference ``dummy_solver.cu``): as a preconditioner
    M = I, so an application returns the right-hand side."""

    is_smoother = True

    def solve_iteration(self, b, x, state, iter_idx):
        return b, state

    def apply(self, b, x0=None, n_iters=None):
        return b
