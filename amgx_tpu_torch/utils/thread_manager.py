"""Async task pool (port of ``amgx_tpu/utils/thread_manager.py``).

Reference: ``base/include/thread_manager.h:46-173`` — ``ThreadManager``
with ``spawn_threads``/``join_threads``/``wait_threads`` running
``AsyncTask``s so smoother setup overlaps across levels, and the
``serialize_threads`` debug flag (``core.cu:356``) that forces serial
execution.

In the port the serving lanes (``amgx_tpu_torch/serve/``) run their
batch solves on it, so task failures are survivable: a raising task is
counted
(``amgx_worker_task_failures_total``) and recorded, the worker and pool
stay alive, and :meth:`wait_threads` re-raises the first failure to the
caller that asked for the results.
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, List, Optional


class ThreadManager:
    """Small task pool mirroring the reference API surface."""

    def __init__(self, max_workers: Optional[int] = None,
                 serialize: bool = False):
        self.serialize = bool(serialize)
        self._max_workers = max_workers
        self._futures: List[concurrent.futures.Future] = []
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._fail_lock = threading.Lock()
        self._spawn_lock = threading.Lock()
        #: first exception harvested from a PRUNED completed future —
        #: wait_threads re-raises it so pruning never swallows a failure
        self._pending_exc: Optional[BaseException] = None
        #: tasks that raised since construction (cumulative; the pool
        #: survives every one of them)
        self.failed_tasks = 0
        #: pools re-created after worker death / out-of-band shutdown
        #: was detected (push_work checks liveness before submitting)
        self.respawns = 0

    # ------------------------------------------------ reference API names
    def spawn_threads(self) -> None:
        # locked: concurrent first pushes auto-spawn (push_work below) —
        # an unlocked check-then-create would leak a second executor
        with self._spawn_lock:
            if not self.serialize and self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="amgx-worker")

    def ensure_alive(self) -> bool:
        """Worker-death detection: a pool that was shut down out of
        band (or whose worker threads all died) is replaced with a
        fresh one so the NEXT task runs instead of raising
        ``RuntimeError: cannot schedule new futures``.  Returns True
        when a respawn happened.  The detection AND replacement run
        under one lock so a concurrent ``push_work`` never observes a
        half-respawned (None) pool.  In-flight futures of the dead
        pool stay failed — their requests complete with a terminal
        error through the batch task's own guards, never a hang."""
        if self.serialize:
            return False
        with self._spawn_lock:
            pool = self._pool
            if pool is None:
                return False
            dead = getattr(pool, "_shutdown", False)
            if not dead:
                threads = getattr(pool, "_threads", None)
                dead = bool(threads) and all(not t.is_alive()
                                             for t in threads)
            if not dead:
                return False
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="amgx-worker")
            self.respawns += 1
        try:
            from ..telemetry import metrics as _m
            _m.counter_inc("amgx_worker_respawns_total")
        except Exception:
            pass    # telemetry must never block the respawn
        return True

    def _guard(self, task: Callable[[], None]):
        """Exception-safe task wrapper: count + record the failure (the
        telemetry counter makes silent worker deaths observable) and
        re-raise into the future so :meth:`wait_threads` keeps its
        fail-the-caller contract.  The executor worker itself survives
        and keeps draining the queue."""
        try:
            # chaos harness (utils/faultinject.py): the worker_death
            # point kills THIS task the way a crashing worker would —
            # the guard's accounting below proves the pool survives it
            from .faultinject import WorkerDeathError, maybe_raise
            maybe_raise("worker_death",
                        WorkerDeathError("injected worker death"))
            return task()
        except BaseException:
            with self._fail_lock:
                self.failed_tasks += 1
            try:
                from ..telemetry import metrics as _m
                _m.counter_inc("amgx_worker_task_failures_total")
            except Exception:
                pass    # telemetry must never mask the task's failure
            raise

    def push_work(self, task: Callable[[], None]
                  ) -> "Optional[concurrent.futures.Future]":
        """Queue one AsyncTask; runs inline under ``serialize_threads``.

        ``push_work`` before :meth:`spawn_threads` auto-spawns the pool
        (the old behaviour ran the task inline, silently serialising a
        caller that forgot to spawn).  Returns the Future (None under
        ``serialize``) so callers that must observe worker death — the
        serving lanes, whose in-flight requests would otherwise hang if
        a worker died before entering the batch body — can attach a
        done-callback."""
        if self.serialize:
            self._guard(task)
            return None
        if self._pool is None:
            self.spawn_threads()
        else:
            self.ensure_alive()
        try:
            fut = self._pool.submit(self._guard, task)
        except RuntimeError:
            # raced a shutdown between the liveness check and submit:
            # respawn once and retry — a second failure is a real bug
            self.ensure_alive()
            fut = self._pool.submit(self._guard, task)
        self._futures.append(fut)
        self._prune()
        return fut

    def _prune(self):
        if len(self._futures) >= 512:
            # long-running users (the serving dispatcher) push work for
            # the process lifetime and only wait at drain — prune
            # completed futures so the list stays bounded, harvesting
            # any failure for the next wait_threads
            keep = []
            for f in self._futures:
                if f.done():
                    exc = f.exception()
                    if exc is not None and self._pending_exc is None:
                        self._pending_exc = exc
                else:
                    keep.append(f)
            self._futures = keep

    def wait_threads(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued task finished; re-raise the first
        failure.  With ``timeout`` the wait is bounded: False when a
        task was still running (its future stays queued)."""
        futures, self._futures = self._futures, []
        first_exc, self._pending_exc = self._pending_exc, None
        _, pending = concurrent.futures.wait(futures, timeout=timeout)
        self._futures.extend(pending)
        for f in futures:
            if f in pending:
                continue
            try:
                f.result()
            except BaseException as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc
        return not pending

    def join_threads(self, timeout: Optional[float] = None) -> None:
        """Wait for the queued tasks (bounded by ``timeout``), then shut
        the pool down; a pool with a task still running is left to
        finish it on its own."""
        done = self.wait_threads(timeout)
        if self._pool is not None:
            self._pool.shutdown(wait=done)
            self._pool = None

    def __enter__(self):
        self.spawn_threads()
        return self

    def __exit__(self, *exc):
        try:
            self.join_threads()
        except Exception:
            if exc == (None, None, None):
                raise
        return False
