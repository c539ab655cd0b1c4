"""Concurrent solve serving (port of ``amgx_tpu/serve/``).

The request-level layer over the solver stack — the subsystem that
exercises it under concurrency.  The reference ships the building
blocks (``thread_manager.h``'s AsyncTask pool, the
replace-coefficients resetup path); this package ties their ports
together with the batching/caching/admission-control playbook an
inference server uses:

* :mod:`.session` — :class:`SolverSession`: one configured solver +
  hierarchy per (config hash, sparsity-pattern fingerprint); values
  fingerprints pick full setup / ``resetup`` / outright reuse;
* :mod:`.cache` — :class:`SetupCache`: LRU over sessions with a DEVICE
  byte budget bounding resident hierarchies;
* :mod:`.batch` — :class:`SolveRequest`/:class:`PendingSolve` and
  micro-batch assembly: same-operator requests stack into one
  multi-RHS ``Solver.solve_multi`` call (its right-hand sides run one
  after another, each the bits of a direct solve), per-request
  convergence split back out;
* :mod:`.router` — multi-device scale-out: one :class:`ExecutorLane`
  per visible device (own queue, dispatcher, worker pool, setup-cache
  slice, SLO window) behind a :class:`PatternRouter` doing
  pattern-affinity routing, hot-pattern replication and cold-pattern
  work stealing;
* :mod:`.service` — :class:`SolveService`: bounded per-lane admission
  (full ⇒ :data:`~amgx_tpu_torch.errors.RC.REJECTED`), per-lane batching
  dispatchers, ``ThreadManager`` workers, per-request deadlines,
  concurrent graceful drain (whole service or one card), and
  :meth:`SolveService.warmup` — setup and graph capture off the request
  path, so a fresh process is request-ready;
* :mod:`.aot` — :class:`AOTStore`: the setup engine's plans shared
  across processes (with ``compile_cache_dir``, the built kernels: the
  zero cold-start layer; keys and fallback rules in its module doc);
* :mod:`.loadgen` — open-loop Poisson load generator recording
  p50/p95/p99 and rejection rate (the SLO harness behind
  ``scripts/serve_load.py``).

Metric names live under the versioned ``METRICS`` registry
(``amgx_serve_*``); ``python -m amgx_tpu_torch.telemetry.doctor`` summarises
serving behaviour from any trace that carries them (the JAX package's
doctor reads the port's traces too).
"""
from __future__ import annotations

from . import aot
from .aot import AOTStore
from .batch import PendingSolve, SolveRequest, split_batches
from .cache import SetupCache
from .router import ExecutorLane, PatternRouter
from .service import SolveService
from .session import (SessionKey, SolverSession, config_hash,
                      placement_view, session_key)

__all__ = [
    "SolveService", "SetupCache", "SolverSession", "SessionKey",
    "SolveRequest", "PendingSolve", "split_batches", "config_hash",
    "session_key", "placement_view", "aot", "AOTStore",
    "ExecutorLane", "PatternRouter",
]
