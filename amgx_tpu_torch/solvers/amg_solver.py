"""AMG as a Solver (port of ``amgx_tpu/solvers/amg_solver.py``;
reference ``algebraic_multigrid_solver.cu``): one solve iteration is one
multigrid cycle, so AMG serves as the main solver, a preconditioner or a
smoother.

On the card an application (:meth:`AMGSolver.apply`) is one CUDA graph
replay: the first application after :meth:`~.base.Solver.setup` runs
eagerly on a side stream and captures the same work
(:class:`~..utils.cuda_graph.CudaGraphCall`), one graph per
``(n, dtype, n_iters, x0 is None)``; ``setup`` drops them.  A
:meth:`~.base.Solver.resetup` keeps the hierarchy object (so
``structure_reuse_levels`` applies) and keeps the graphs when the
refreshed tree pairs with the one they read (:mod:`._bind`);
``rebind`` counts the graphs kept and dropped and the reason of each
drop.  CPU tensors run the cycle eagerly, and so does an AMG nested in a
graphed AMG (its coarse solver or smoother) while the outer graph is
warmed up or captured: its kernels become nodes of the outer graph.
"""
from __future__ import annotations

from ..amg.cycles import build_cycle
from ..amg.hierarchy import AMGHierarchy
from ..errors import BadConfigurationError
from ..utils.cuda_graph import CudaGraphCall, building
from . import _bind
from .base import Solver, register_solver


@register_solver("AMG")
class AMGSolver(Solver):
    is_smoother = True

    def solver_setup(self):
        if self.A is None:
            raise BadConfigurationError(
                "AMG setup requires the matrix handle (upload via Matrix)")
        if not hasattr(self, "rebind"):
            self.rebind = dict(graphs_kept=0, graphs_dropped=0, drops=[],
                               last=None)
        graphs = getattr(self, "graphs", {})
        if getattr(self, "_numeric_resetup", False) and \
                getattr(self, "hierarchy", None) is not None:
            self.hierarchy.setup(self.A)
            self._cycle = build_cycle(self.hierarchy)
            if graphs:
                self._keep_or_drop(graphs)
            return
        if graphs:
            self.rebind["graphs_dropped"] += len(graphs)
            self.rebind["drops"].append("setup(): a full rebuild")
        self.graphs, self._bound = {}, None
        self.hierarchy = AMGHierarchy(self.cfg, self.scope)
        self.hierarchy.setup(self.A)
        self._cycle = build_cycle(self.hierarchy)

    def _keep_or_drop(self, graphs):
        """After a resetup: keep the graphs on the refreshed tree's values
        when its slots pair with those the graphs read (``_bound``), else
        drop them."""
        old = self._bound
        new = _bind.collect(self, {s.path: s for s in old})
        res = _bind.rebind(old, new)
        self.rebind["last"] = res
        if res.kept:
            _bind.release_stale_packs(old, new)
            self.rebind["graphs_kept"] += len(graphs)
            # the tree now holds the graphs' storage: walk it again
            self._bound = _bind.collect(self)
        else:
            self.rebind["graphs_dropped"] += len(graphs)
            self.rebind["drops"].append(res.reason)
            self.graphs, self._bound = {}, None

    def _bind_snapshot(self):
        """Record the slots the graphs read (after each capture)."""
        self._bound = _bind.collect(self)

    def solve_iteration(self, b, x, state, iter_idx):
        return self._cycle(b, x), state

    def apply(self, b, x0=None, n_iters=None):
        """One application as a preconditioner or smoother: on a CUDA
        tensor a replay of its graph (captured at the first call with
        this key), which returns a fresh tensor; on a CPU tensor, or
        inside another graph's warm-up or capture, the eager cycle."""
        if not b.is_cuda or building():
            return self._apply_eager(b, x0, n_iters)
        n = self.max_iters if n_iters is None else n_iters
        key = (b.shape[0], b.dtype, n, x0 is None)
        args = (b,) if x0 is None else (b, x0)
        graph = self.graphs.get(key)
        if graph is None:
            graph = CudaGraphCall(
                lambda b_, *x_: self._apply_eager(b_, *x_, n_iters=n),
                *args)
            self.graphs[key] = graph
            self._bind_snapshot()
            return graph.take_first()
        return graph(*args)

    def _apply_eager(self, b, x0=None, n_iters=None):
        """The application without a graph (the capture runs it; the card
        tests hold a replay against it)."""
        return super().apply(b, x0, n_iters)

    def grid_stats(self) -> str:
        return self.hierarchy.grid_stats()
