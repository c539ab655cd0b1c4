"""AMG hierarchy: the setup loop, DIA path (port of the structured/GEO
part of ``amgx_tpu/amg/hierarchy.py``; reference ``AMG_Setup::setup``,
``amg.cu:177-450``).

For a stencil operator every coarsening decision is planned from the
fine offsets and grid dims (:func:`~.dia_device.plan_dia_hierarchy`),
then all coarse levels' values, diagonals and inverted diagonals are
derived on the fine operator's device in one pass
(:func:`~.dia_device.derive_hierarchy_device`).  Operators the plan does
not cover — non-GEO selectors, classical AMG, matrices past the DIA
budget — need the host coarsening loop, a later slice of the port.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..config import AMGConfig
from ..core.matrix import Matrix
from ..errors import NotImplementedError_
from ..solvers.base import SolverFactory
from .dia_device import derive_hierarchy_device, plan_dia_hierarchy
from .level import AMGLevel, PairwiseLevel, StructuredLevel
from .structured import (decompose_offsets, infer_grid_dims,
                         stencil_values_consistent)

#: knobs of the AMG scope whose non-default values select a feature of
#: a later slice of the port
_LATER_SLICE = (("structure_reuse_levels", 0), ("amg_host_levels_rows", -1),
                ("error_scaling", 0))


def _drop_zero_diagonals(offs, vals: np.ndarray):
    """Drop stored all-zero diagonals (the main diagonal always stays);
    returns ``(offs, vals, keep)`` with ``keep`` None when nothing was
    dropped, else the kept row indices."""
    offs = list(offs)
    nonzero = (vals != 0).any(axis=1) | (np.asarray(offs) == 0)
    if nonzero.all():
        return offs, vals, None
    keep = np.flatnonzero(nonzero)
    return [offs[int(k)] for k in keep], vals[keep], keep


class AMGHierarchy:
    def __init__(self, cfg: AMGConfig, scope: str):
        self.cfg = cfg
        self.scope = scope
        g = lambda name: cfg.get(name, scope)
        for name, default in _LATER_SLICE:
            if g(name) != default:
                raise NotImplementedError_(
                    f"{name}={g(name)!r} is a later slice of the port")
        self.algorithm = str(g("algorithm"))
        self.selector = str(g("selector"))
        self.max_levels = int(g("max_levels"))
        self.min_coarse_rows = int(g("min_coarse_rows"))
        self.coarsen_threshold = float(g("coarsen_threshold"))
        self.cycle_type = str(g("cycle"))
        self.presweeps = int(g("presweeps"))
        self.postsweeps = int(g("postsweeps"))
        self.finest_sweeps = int(g("finest_sweeps"))
        self.coarsest_sweeps = int(g("coarsest_sweeps"))
        self.cycle_iters = int(g("cycle_iters"))
        self.levels: List[AMGLevel] = []
        self.coarsest: Optional[Matrix] = None
        self.coarse_solver = None
        self.coarse_solver_is_smoother = False

    # ------------------------------------------------------------------ setup
    def setup(self, A: Matrix):
        t0 = time.perf_counter()
        self.levels = []
        cur = self._build_levels(A)
        self._setup_smoothers_and_coarse(cur)
        self.setup_time = time.perf_counter() - t0
        return self

    def _build_levels(self, cur: Matrix) -> Matrix:
        """The coarsening loop from ``cur``; returns the coarsest matrix."""
        cur = self._build_dia_device(cur)
        n = cur.n_block_rows
        if len(self.levels) + 1 < self.max_levels and \
                n > self.min_coarse_rows:
            raise NotImplementedError_(
                f"coarsening below {n} rows needs the host coarsening loop "
                f"(algorithm={self.algorithm}, selector={self.selector}), "
                "a later slice of the port")
        return cur

    def _dia_plan_inputs(self, cur: Matrix, max_diags: int = 48):
        """(offsets, host vals or None, dims or None, keep) of a
        DIA-eligible matrix — the structured-vs-pairwise gate; None when
        ``cur`` has no DIA decomposition."""
        if cur.n_block_rows < 2:
            return None
        n = cur.n_block_rows
        hint = getattr(cur, "_dia_offsets_hint", None)
        if hint is not None and getattr(cur, "_stencil_consistent", False):
            # device-generated stencils declare offsets and consistency
            # analytically: the plan never materialises host values
            offs = [int(o) for o in hint]
            if len(offs) > max_diags:
                return None
            dims = cur.grid_dims
            if dims is not None and int(np.prod(dims)) != n:
                dims = None
            if dims is None:
                dims = infer_grid_dims(offs, n)
            if dims is not None and max(dims) > 1 and \
                    decompose_offsets(offs, dims) is None:
                dims = None
            return offs, None, dims, None
        arrs = cur.dia_cache(max_diags)
        if arrs is None:
            return None
        offs, vals, keep = _drop_zero_diagonals(*arrs)
        dims = cur.grid_dims
        if dims is not None and int(np.prod(dims)) != n:
            dims = None
        if dims is None:
            dims = infer_grid_dims(offs, n)
        if dims is not None and max(dims) > 1:
            offs3 = decompose_offsets(offs, dims)
            if offs3 is None or \
                    not stencil_values_consistent(offs3, vals, dims):
                dims = None      # periodic/wrap stencil: decode is a lie
        return offs, vals, dims, keep

    def _build_dia_device(self, cur: Matrix) -> Matrix:
        """Plan every coarsening decision from the stencil structure,
        derive all coarse levels on the device, and append them; returns
        the coarsest planned matrix (``cur`` when nothing was planned)."""
        if self.algorithm != "AGGREGATION" or \
                self.selector not in ("GEO", "PAIRWISE"):
            return cur
        inputs = self._dia_plan_inputs(cur)
        if inputs is None:
            return cur
        offs, _, dims, keep = inputs
        steps, _ = plan_dia_hierarchy(
            offs, cur.n_block_rows, dims, self.max_levels,
            self.min_coarse_rows, self.coarsen_threshold,
            existing_levels=len(self.levels))
        if not steps:
            return cur
        curd = cur.device()
        dvals = curd.vals if keep is None else \
            curd.vals[torch.as_tensor(keep, dtype=torch.int64,
                                      device=curd.vals.device)]
        outs = derive_hierarchy_device(steps, offs, dvals)
        return self._append_dia_levels(cur, steps, outs)

    def _append_dia_levels(self, cur: Matrix, steps, outs) -> Matrix:
        """Materialise planned levels around the derived (vals, diag,
        dinv); returns the coarsest matrix."""
        cur._dinv_dev = (cur.device().dtype, outs[0][1])
        for st, (vals_c, diag_c, dinv_c) in zip(steps, outs[1:]):
            idx = len(self.levels)
            if st.kind == "structured":
                level = StructuredLevel(cur, idx, st.dims, st.cdims)
            else:
                level = PairwiseLevel(cur, idx, st.n)
            Ac = Matrix.from_dia_device(st.c_offsets, vals_c, diag_c, dinv_c)
            if st.kind == "structured":
                Ac.grid_dims = st.cdims
            self.levels.append(level)
            cur = Ac
        return cur

    def _setup_smoothers_and_coarse(self, coarsest: Matrix):
        for lvl in self.levels:
            lvl.smoother = SolverFactory.allocate(self.cfg, self.scope,
                                                  "smoother")
            lvl.smoother.setup(lvl.A)
        self.coarsest = coarsest
        self.coarse_solver = SolverFactory.allocate(self.cfg, self.scope,
                                                    "coarse_solver")
        self.coarse_solver.setup(coarsest)
        self.coarse_solver_is_smoother = self.coarse_solver.is_smoother

    # ------------------------------------------------------------------ info
    def num_levels(self):
        return len(self.levels) + 1

    def level_sizes(self) -> List[tuple]:
        """(rows, nnz) per level, fine to coarsest."""
        sizes = [lvl.level_stats() for lvl in self.levels]
        sizes.append((self.coarsest.n_block_rows, self.coarsest.nnz))
        return sizes
