"""Solver sessions: the serving layer's unit of setup reuse (port of
``amgx_tpu/serve/session.py``).

A :class:`SolverSession` owns one configured solver (and, for AMG
configs, its hierarchy) keyed by :class:`SessionKey` — the pair of the
config hash and the matrix's sparsity-pattern fingerprint
(``core.matrix.Matrix.pattern_fingerprint``).  Every request carrying
the same key reuses the session; within a session the VALUES
fingerprint decides how much work reuse buys:

* equal values → the prepared solver is reused outright (``reuse``);
* same pattern, new values → ``Solver.resetup`` — the
  replace-coefficients path that keeps the hierarchy structure, the
  setup engine's plans, nested solver instances and, where the structure allows,
  the AMG's captured CUDA graphs (reference contract:
  ``AMGX_solver_resetup``, same structure / new values);
* a fresh session pays the one full ``Solver.setup``.

Sessions are thread-safe: the lock serialises prepare/solve on one
session.  On the card the work of every session also holds the card's
lock (:func:`~..device.device_lock`): a CUDA graph replays into fixed
buffers and its capture is invalidated by any other thread's launch, so
one card runs one session's setup or solve at a time, while the service's
other workers do their host work (admission, batching, the split of the
results) beside it.  CPU sessions run concurrently.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import List, Optional

import torch

from ..config import AMGConfig
from ..core.matrix import Matrix
from ..device import device_lock


def placement_view(matrix: Matrix, device) -> Matrix:
    """A shallow Matrix view of ``matrix`` whose device pack uploads to
    ``device`` — the multi-lane serving layer's placement trick (the
    precision sibling is ``core.precision.precision_view``).  Host-side
    structures (scipy CSR, DIA caches, fingerprints) stay shared, so
    two lanes replicating one hot pattern pay the value upload twice
    but the host symbolic work once; the device pack cache is cleared,
    not shared — a pack resident on another lane's card must not leak
    into this lane's hierarchy."""
    v = copy.copy(matrix)
    v._device = None
    v._device_dtype = None
    v._dinv_dev = None          # the inverted diagonal on the old card
    v.__dict__.pop("_setup_wide", None)
    v.placement = torch.device(device)
    return v


def config_hash(cfg: AMGConfig) -> str:
    """Stable digest of the resolved config — two configs that resolve
    identically share sessions regardless of the
    source text's entry order.  Canonical implementation:
    :meth:`AMGConfig.stable_hash`."""
    return cfg.stable_hash()


@dataclasses.dataclass(frozen=True)
class SessionKey:
    """(config hash, sparsity-pattern fingerprint) — equal keys may
    share one solver hierarchy via resetup."""

    config: str
    pattern: str


def session_key(cfg: AMGConfig, matrix: Matrix) -> SessionKey:
    return SessionKey(config=config_hash(cfg),
                      pattern=matrix.pattern_fingerprint())


class SolverSession:
    """One configured solver + its setup state, reusable across
    same-pattern requests."""

    def __init__(self, key: SessionKey, cfg: AMGConfig,
                 placement=None):
        from ..solvers import SolverFactory
        self.key = key
        self.lock = threading.RLock()
        #: card this session's hierarchy and solves are pinned to
        #: (multi-lane serving: one lane per card); None keeps the
        #: matrix's own device
        self.placement = placement
        #: the device the prepared solver lives on (set at setup)
        self.device: Optional[torch.device] = None
        self.solver = SolverFactory.allocate(cfg, "default", "solver")
        self.solver._toplevel = True
        #: values fingerprint the solver is currently prepared for
        self.values_fp: Optional[str] = None
        self.full_setups = 0
        self.resetups = 0
        self.value_hits = 0
        self.last_used = time.monotonic()
        #: device bytes of the prepared hierarchy (cache accounting;
        #: refreshed by the cache after each prepare)
        self.bytes = 0

    def _device_ctx(self, matrix: Optional[Matrix] = None):
        """On a card: its lock, held for the whole step, and that card as
        the current device (every tensor the prepare/solve path creates
        without an explicit device lands on the lane's card).  A CPU
        session needs neither."""
        dev = self.placement or self.device or (
            None if matrix is None else matrix.placement)
        if dev is None or torch.device(dev).type != "cuda":
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(device_lock(dev))
        stack.enter_context(torch.cuda.device(torch.device(dev)))
        return stack

    def _placed(self, matrix: Matrix) -> Matrix:
        if self.placement is None or \
                matrix.placement == torch.device(self.placement):
            return matrix
        return placement_view(matrix, self.placement)

    # ------------------------------------------------------------- prepare
    def prepare(self, matrix: Matrix) -> str:
        """Make the solver ready for ``matrix``'s values; returns the
        work actually done: ``"full"`` | ``"resetup"`` | ``"reuse"``.
        Placement-pinned sessions setup through a placement VIEW of the
        matrix so the device pack (and the hierarchy built from it)
        lives on the lane's card while host structures stay shared."""
        vfp = matrix.values_fingerprint()
        with self.lock, self._device_ctx(matrix):
            self.last_used = time.monotonic()
            if self.solver.Ad is None:
                self.solver.setup(self._placed(matrix))
                self.device = getattr(self.solver.Ad, "device", None) \
                    or self._placed(matrix).placement
                self.full_setups += 1
                self.values_fp = vfp
                return "full"
            if vfp == self.values_fp:
                self.value_hits += 1
                return "reuse"
            self.solver.resetup(self._placed(matrix))
            self.resetups += 1
            self.values_fp = vfp
            return "resetup"

    # --------------------------------------------------------------- solve
    def solve_batch(self, B, X0=None, pad_to_bucket: bool = False
                    ) -> List:
        """Multi-RHS solve under the session lock (one session's solver
        state is not reentrant)."""
        with self.lock, self._device_ctx():
            self.last_used = time.monotonic()
            return self.solver.solve_multi(B, X0=X0,
                                           pad_to_bucket=pad_to_bucket)

    def prepare_and_solve(self, matrix: Matrix, B, X0=None,
                          pad_to_bucket: bool = False,
                          on_prepared=None):
        """Atomic prepare + batched solve: (kind, results).  The lock is
        held across BOTH steps — two same-pattern batches with different
        values racing on one session must not interleave a resetup
        between the other's prepare and solve (the solve would run
        against the wrong coefficients).  ``on_prepared(kind)``, when
        given, fires between the two steps (still under the lock) —
        the request tracer's prepare/solve phase boundary."""
        with self.lock, self._device_ctx(matrix):
            kind = self.prepare(matrix)
            if on_prepared is not None:
                on_prepared(kind)
            return kind, self.solver.solve_multi(
                B, X0=X0, pad_to_bucket=pad_to_bucket)

    # ---------------------------------------------------------- accounting
    def device_bytes(self) -> int:
        """Resident device bytes of the prepared solver (hierarchy,
        smoother arrays, packs, the captured graphs' buffers) — what
        evicting this session would free; each storage counts once."""
        from ..utils.memory import device_tree_bytes
        with self.lock:
            if self.solver.Ad is None:
                return 0
            return device_tree_bytes(self.solver, device=self.device)

    def stats(self) -> dict:
        with self.lock:
            return {
                "pattern": self.key.pattern,
                "full_setups": self.full_setups,
                "resetups": self.resetups,
                "value_hits": self.value_hits,
                "bytes": self.bytes,
            }
