"""Request objects and micro-batch assembly/execution (port of
``amgx_tpu/serve/batch.py``).

The batching unit is (session key, values fingerprint): requests that
share a *prepared operator* — same config, same sparsity pattern, same
values — stack their right-hand sides into one multi-RHS solve
(``Solver.solve_multi``), exactly the shape an inference server's
micro-batcher produces.  The port's ``solve_multi`` runs the stacked
right-hand sides one by one through ``Solver.solve``, so each request's
count and x are those of a direct solve of its system.  Same-pattern
requests with *different* values never share a batch (they are
different operators); they share the SESSION, riding the resetup path
sequentially.

Each request's result is split back out with its own convergence
status, iteration count and residual — a batch where one RHS converges
and another hits the iteration limit reports both truthfully.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from ..errors import RC
from ..solvers.base import SolveResult
from .session import SessionKey, SolverSession

_trace_counter = itertools.count(1)


def _new_trace_id() -> str:
    """Process-unique request trace id (pid + counter — cheap, sortable,
    and stable across the request's log lines and trace slices)."""
    return f"{os.getpid():x}-{next(_trace_counter):06x}"


#: lifecycle mark → the phase it CLOSES (the duration since the
#: previous mark); every consumer of ``amgx_serve_phase_seconds{phase}``
#: and the doctor's phase-split table key on these names
PHASE_OF_MARK = {
    "admitted": "admit",        # submit() admission bookkeeping
    "executing": "queue_wait",  # queue + batch window + worker pickup
    "prepared": "prepare",      # session prepare (setup-cache path)
    "solved": "solve",          # the multi-RHS solve (every count on
                                # the host, so the device work is done)
    "errored": "errored",       # prepare/solve raised (failure path —
                                # keeps failed device time out of the
                                # other phases' split)
    "requeued": "errored",      # a failed execution attempt re-queued
                                # by the per-request retry budget; its
                                # wasted time folds into the error
                                # phase, then queue_wait re-opens
    "done": "finalize",         # result split-out + completion
}


@dataclasses.dataclass
class SolveRequest:
    """One queued (matrix, b) solve."""

    matrix: object                 # core.matrix.Matrix
    b: np.ndarray
    x0: Optional[np.ndarray]
    key: SessionKey
    values_fp: str
    submitted_t: float
    #: absolute ``time.monotonic`` deadline, or None
    deadline_t: Optional[float]
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: Optional[SolveResult] = None
    rc: RC = RC.OK
    error: Optional[str] = None
    # ---- request-lifecycle trace (live serving observability) ------
    trace_id: str = dataclasses.field(default_factory=_new_trace_id)
    #: (mark name, time.perf_counter()) in lifecycle order; the
    #: "submitted" mark is stamped at construction so every later
    #: phase telescopes against it
    marks: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    #: ``time.monotonic`` completion stamp (deadline_met math shares
    #: the deadline's clock; the marks use perf_counter — the
    #: recorder's clock — so trace slices align)
    completed_mono: Optional[float] = None
    #: terminal-accounting hook (the service's ``_finalize``): invoked
    #: by :meth:`complete` BEFORE the waiter event is set, so a client
    #: that wakes from ``wait()`` and immediately snapshots the SLO
    #: window always sees this request counted
    on_terminal: Optional[object] = dataclasses.field(
        default=None, repr=False)
    #: set by the deadline shed in :func:`execute_batch` — the
    #: expired-vs-rejected distinction must not hang off the free-text
    #: error message (outcome() classifies on this flag)
    deadline_shed: bool = False
    #: executor lane index the router assigned (multi-device serving;
    #: None for requests rejected before routing) and the routing
    #: decision that placed it (affinity|cold|steal|replicate|overflow)
    lane: Optional[int] = None
    route: Optional[str] = None
    #: execution retries consumed (serve_retry_max budget): a batch
    #: whose prepare/solve RAISED re-queues its requests instead of
    #: completing them, deadline permitting
    retries: int = 0

    def __post_init__(self):
        if not self.marks:
            self.marks.append(("submitted", time.perf_counter()))

    def mark(self, name: str):
        self.marks.append((name, time.perf_counter()))

    def batch_key(self):
        return (self.key, self.values_fp)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline_t is not None and \
            (now if now is not None else time.monotonic()) > self.deadline_t

    # -------------------------------------------------------- trace views
    def latency_s(self) -> float:
        """submitted → last mark, on one clock (exact telescoping sum
        of :meth:`phase_durations`)."""
        return max(self.marks[-1][1] - self.marks[0][1], 0.0)

    def phase_offsets(self) -> Dict[str, float]:
        """Mark offsets from ``submitted`` (seconds), in lifecycle
        order — monotone by construction."""
        t0 = self.marks[0][1]
        return {name: max(t - t0, 0.0) for name, t in self.marks[1:]}

    def phase_durations(self) -> Dict[str, float]:
        """Consecutive mark gaps labelled by :data:`PHASE_OF_MARK` —
        their sum telescopes to :meth:`latency_s` exactly."""
        out: Dict[str, float] = {}
        for (_, t_prev), (name, t) in zip(self.marks, self.marks[1:]):
            phase = PHASE_OF_MARK.get(name, name)
            out[phase] = out.get(phase, 0.0) + max(t - t_prev, 0.0)
        return out

    def outcome(self) -> str:
        """Terminal outcome label (the SLO window's vocabulary):
        ``ok`` | ``failed`` (completed but did not converge) |
        ``rejected`` (admission) | ``expired`` (deadline shed) |
        ``error``."""
        if self.rc == RC.OK:
            if self.result is None:
                return "error"
            return "ok" if int(self.result.status) == 0 else "failed"
        if self.rc == RC.REJECTED:
            return "expired" if self.deadline_shed else "rejected"
        return "error"

    # ----------------------------------------------------------- completion
    def complete(self, result: Optional[SolveResult], rc: RC = RC.OK,
                 error: Optional[str] = None):
        if self._event.is_set():
            return              # terminal exactly once (belt-and-braces
                                # callers re-check done() racily)
        self.result = result
        self.rc = RC(rc)
        self.error = error
        self.completed_mono = time.monotonic()
        self.mark("done")
        try:
            if self.on_terminal is not None:
                self.on_terminal(self)
        finally:
            self._event.set()   # waiters ALWAYS wake, even if terminal
                                # accounting raised

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class PendingSolve:
    """User-facing handle for a submitted request: ``wait()`` blocks for
    the result; ``rc`` is :data:`RC.OK` on success, :data:`RC.REJECTED`
    when admission control shed the request (queue full / deadline)."""

    def __init__(self, request: SolveRequest):
        self._request = request

    @property
    def rc(self) -> RC:
        return self._request.rc

    @property
    def error(self) -> Optional[str]:
        return self._request.error

    def done(self) -> bool:
        return self._request.done()

    def wait(self, timeout: Optional[float] = None
             ) -> Optional[SolveResult]:
        """Block until the request completes; returns the
        :class:`SolveResult` (None when rejected or failed — check
        ``rc``/``error``)."""
        if not self._request.wait(timeout):
            return None
        return self._request.result

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        """Block until the request completes; True when it did (even
        rejected/failed — ``wait`` returning None cannot distinguish a
        rejection from a timeout; this can)."""
        return self._request.wait(timeout)

    @property
    def result(self) -> Optional[SolveResult]:
        return self._request.result


def split_batches(requests: List[SolveRequest], max_batch: int
                  ) -> List[List[SolveRequest]]:
    """Group requests by (session key, values fp), capping each batch at
    ``max_batch`` RHS.  Arrival order is preserved within a group."""
    groups: "dict[tuple, List[SolveRequest]]" = {}
    order: List[tuple] = []
    for r in requests:
        k = r.batch_key()
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(r)
    batches: List[List[SolveRequest]] = []
    for k in order:
        g = groups[k]
        for i in range(0, len(g), max(1, int(max_batch))):
            batches.append(g[i:i + max(1, int(max_batch))])
    return batches


def _stack(vectors):
    """(k, n) of k vectors: a tensor on the device and in the dtype of
    the first tensor among them, else a numpy array."""
    first = next((v for v in vectors if isinstance(v, torch.Tensor)), None)
    if first is not None:
        return torch.stack([torch.as_tensor(v, device=first.device,
                                            dtype=first.dtype).reshape(-1)
                            for v in vectors])
    return np.stack([np.asarray(v).ravel() for v in vectors])


def execute_batch(session: SolverSession, requests: List[SolveRequest],
                  cache=None, retry=None):
    """Prepare the session for the batch's operator, run the stacked
    multi-RHS solve (``pad_to_bucket``: upstream pads to a power-of-two
    bucket so ragged batch sizes share an executable; the port's
    sequential ``solve_multi`` runs no padding lane), and split
    per-request results back out.  Failures complete every request in
    the batch with an error rc instead of raising into the worker
    pool — unless ``retry(req, msg)`` (the lane's per-request retry
    budget, serve_retry_max) claims the request by returning True, in
    which case it is re-queued and NOT completed here.  Only RAISED
    prepare/solve failures are retryable; convergence failures are
    deterministic and deadline sheds are final."""
    now = time.monotonic()
    live = []
    for r in requests:
        # queue exit: the queue_wait phase ends here for every request
        # of the batch, shed or not
        r.mark("executing")
        if r.expired(now):
            telemetry.counter_inc("amgx_serve_rejected_total",
                                  reason="deadline")
            telemetry.counter_inc("amgx_serve_requests_total",
                                  status="REJECTED")
            # the deadline shed IS the taxonomy's `deadline` kind —
            # count it where every other FailureKind counts
            from ..errors import FailureKind
            telemetry.counter_inc("amgx_solve_failures_total",
                                  kind=FailureKind.DEADLINE.value)
            r.deadline_shed = True
            r.complete(None, rc=RC.REJECTED,
                       error="deadline expired before execution")
        else:
            live.append(r)
    # a matrix mutated between submit and execution (e.g.
    # replace_coefficients on a handle with queued requests) would be
    # solved against values the request was never submitted with — fail
    # those requests loudly instead of returning a silently wrong x
    still = []
    for r in live:
        if r.matrix.values_fingerprint() != r.values_fp:
            telemetry.counter_inc("amgx_serve_requests_total",
                                  status="ERROR")
            r.complete(None, rc=RC.BAD_PARAMETERS,
                       error="matrix values changed after submit; "
                             "re-submit against the current matrix")
        else:
            still.append(r)
    live = still
    if not live:
        return
    try:
        B = _stack([r.b for r in live])
        X0 = None
        if any(r.x0 is not None for r in live):
            n = B.shape[1]
            X0 = _stack([
                r.x0 if r.x0 is not None else np.zeros(n)
                for r in live])
        telemetry.hist_observe("amgx_serve_batch_size", float(len(live)))

        def _mark_prepared(kind):
            # called by prepare_and_solve between its prepare and
            # solve, still under the session lock — the boundary the
            # prepare/solve phase split needs
            for r in live:
                r.mark("prepared")

        # prepare + solve are ATOMIC on the session: a racing batch with
        # different values must not resetup the shared solver between
        # this batch's prepare and its solve.  The span lands on the
        # WORKER thread's track with the batch's request trace ids as
        # args — the Chrome-trace link between a request slice and the
        # batch that served it
        with telemetry.span("serve_batch", batch=len(live),
                            pattern=session.key.pattern[:12],
                            trace_ids=[r.trace_id for r in live]):
            kind, results = session.prepare_and_solve(
                live[0].matrix, B, X0=X0, pad_to_bucket=True,
                on_prepared=_mark_prepared)
        # solve_multi fetched every lane's count and residual to the
        # host before returning, so this mark is fenced device time
        for r in live:
            r.mark("solved")
        telemetry.counter_inc("amgx_serve_setup_total", kind=kind)
        if cache is not None and kind in ("full", "resetup"):
            cache.account(session)
        # memory-ledger phase boundary: rate-limited snapshot after the
        # batch (a full setup / resetup just changed what is resident)
        telemetry.memledger.maybe_sample(phase="serve")
    except Exception as e:      # noqa: BLE001 — worker pool must survive
        msg = f"{type(e).__name__}: {e}"
        # device OOM post-mortem (idempotent per exception: the solver
        # layer underneath may already have emitted for this object)
        if telemetry.memledger.is_oom_error(e):
            telemetry.memledger.emit_postmortem(e, "serve")
        from ..errors import classify_exception, exception_rc
        rc = exception_rc(e)
        # classify the raised failure into the taxonomy (setup_error /
        # device_error) so serving-path failures land in the same
        # counter/event the in-loop breakdown kinds use.  Only marks of
        # the CURRENT attempt count: a retried request keeps its first
        # attempt's "prepared" mark, which must not reclassify a
        # setup-phase failure on the retry as a device error
        marks = live[0].marks
        last_exec = max((i for i, (nm, _) in enumerate(marks)
                         if nm == "executing"), default=-1)
        prepared = any(nm == "prepared"
                       for nm, _ in marks[last_exec + 1:])
        kind = classify_exception(e, during_setup=not prepared)
        telemetry.counter_inc("amgx_solve_failures_total",
                              kind=kind.value)
        telemetry.event("breakdown", solver="serve", kind=kind.value,
                        iteration=None, error=msg[:200])
        for r in live:
            if retry is not None and retry(r, msg):
                continue        # re-queued; completes on a later attempt
            telemetry.counter_inc("amgx_serve_requests_total",
                                  status="ERROR")
            # close the failed prepare/solve time under its own phase —
            # folding a 2 s device failure into "finalize" would steer
            # the doctor's congestion-vs-compute hint away from the
            # actual failing solve path
            r.mark("errored")
            r.complete(None, rc=rc, error=msg)
        return
    t_done = time.monotonic()
    for r, res in zip(live, results):
        telemetry.counter_inc(
            "amgx_serve_requests_total",
            status=("SUCCESS" if int(res.status) == 0 else "FAILED"))
        telemetry.hist_observe("amgx_serve_request_seconds",
                               t_done - r.submitted_t)
        r.complete(res)
