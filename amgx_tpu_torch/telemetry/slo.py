"""SLO monitor: the time-windowed request-outcome reservoir.

The serving layer's original latency record was a count-bounded list of
*successful* completions — deadline-expired and rejected requests
vanished from every percentile, so an overloaded service looked
*faster* the harder it shed load.  This module replaces it with the
standard SRE accounting:

* :class:`SLOWindow` keeps ``(t, latency, outcome, deadline_met)`` for
  **every** request outcome inside a sliding time window
  (``slo_window_s``), evicting by age rather than count;
* configurable objectives (``slo_latency_ms``, ``slo_target``) turn the
  window into **attainment** (good requests / all requests — a request
  is *good* when it completed OK, met its deadline and beat the latency
  objective) and **error-budget burn rate** (``(1 - attainment) /
  (1 - target)`` — 1.0 burns the budget exactly at the objective, >1
  exhausts it early);
* an **overload detector**: the windowed rejection rate plus the live
  queue depth form a trip wire (:meth:`SLOWindow.overloaded`) that
  ``/healthz`` and the doctor read.

Percentiles are computed over the outcomes that actually *waited*
(completed, failed, expired, errored) — admission rejections return in
microseconds and would drag every percentile toward zero, which is the
inverse lie of the one this module exists to fix; they count against
attainment instead.

``snapshot()`` additionally publishes the ``amgx_slo_*`` gauges and a
schema-validated ``slo_window`` event when telemetry is enabled, so a
trace carries the SLO picture the moment anyone asked for it.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Sequence

from . import metrics, recorder

#: every terminal request outcome the window labels
OUTCOMES = ("ok", "failed", "rejected", "expired", "error")
#: outcomes with a meaningful wait — the percentile population
#: (admission rejections return immediately and count against
#: attainment, not latency)
WAITED_OUTCOMES = ("ok", "failed", "expired", "error")
#: windowed rejection+expiry rate past which the service reads
#: overloaded (the rejection leg of the trip wire)
OVERLOAD_REJECT_RATE = 0.05
#: fraction of admission capacity past which the OUTSTANDING work
#: (queued + in-flight — the dispatcher drains the queue itself every
#: batch window, so the backlog lives in-flight) alone reads
#: overloaded: the queue-depth leg catches the ramp BEFORE the first
#: rejection
OVERLOAD_QUEUE_FRAC = 0.9
#: hard count cap on the reservoir — age is the eviction policy, this
#: is the memory bound (at 300 s windows a high-rps service would
#: otherwise hold O(rps×window) tuples forever)
MAX_SAMPLES = 65536


class SLOWindow:
    """Sliding-window reservoir of request outcomes + the SLO math."""

    def __init__(self, window_s: float = 300.0,
                 latency_ms: float = 0.0, target: float = 0.99):
        self.window_s = float(window_s)
        #: latency objective in seconds; 0 disables the latency
        #: criterion (attainment then counts completion + deadline only)
        self.latency_objective_s = float(latency_ms) / 1e3
        #: target >= 1.0 means a ZERO error budget — burn rate is then
        #: undefined (reported None) instead of the absurd ~1e9× a
        #: clamped denominator would print for a single failure
        self._zero_budget = float(target) >= 1.0
        self.target = min(max(float(target), 0.0), 1.0 - 1e-9)
        self._lock = threading.Lock()
        #: (t, latency_s, outcome, deadline_met) — newest at the right
        self._dq: "collections.deque[tuple]" = collections.deque(
            maxlen=MAX_SAMPLES)

    # -------------------------------------------------------------- record
    def record(self, latency_s: float, outcome: str,
               deadline_met: bool = True,
               now: Optional[float] = None):
        """Append one terminal request outcome.  ``now`` is injectable
        (``time.monotonic`` scale) so eviction math is testable."""
        if outcome not in OUTCOMES:
            raise ValueError(f"unknown SLO outcome {outcome!r} "
                             f"(one of {OUTCOMES})")
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._dq.append((t, float(latency_s), outcome,
                             bool(deadline_met)))
            self._evict_locked(t)

    def _evict_locked(self, now: float):
        cut = now - self.window_s
        dq = self._dq
        while dq and dq[0][0] < cut:
            dq.popleft()

    def _samples(self, now: Optional[float] = None):
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._evict_locked(t)
            return list(self._dq)

    def reset(self):
        with self._lock:
            self._dq.clear()

    def __len__(self) -> int:
        return len(self._samples())

    # --------------------------------------------------------------- query
    @staticmethod
    def _counts_of(samples) -> Dict[str, int]:
        out = {k: 0 for k in OUTCOMES}
        for _, _, oc, _ in samples:
            out[oc] += 1
        return out

    def counts(self, now: Optional[float] = None) -> Dict[str, int]:
        return self._counts_of(self._samples(now))

    @staticmethod
    def _percentiles_of(samples,
                        outcomes: Sequence[str] = WAITED_OUTCOMES
                        ) -> dict:
        lat = sorted(l for _, l, oc, _ in samples if oc in outcomes)
        if not lat:
            return {"p50": None, "p95": None, "p99": None}

        def pct(p):
            return lat[min(len(lat) - 1,
                           max(0, int(round(p * (len(lat) - 1)))))]

        return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}

    def percentiles(self, outcomes: Sequence[str] = WAITED_OUTCOMES,
                    now: Optional[float] = None) -> dict:
        """p50/p95/p99 latency (seconds) over the waited outcomes —
        the old ``latency_percentiles`` shape, minus its blind spot."""
        return self._percentiles_of(self._samples(now), outcomes)

    def _good(self, sample) -> bool:
        _, latency, outcome, deadline_met = sample
        if outcome != "ok" or not deadline_met:
            return False
        if self.latency_objective_s > 0 and \
                latency > self.latency_objective_s:
            return False
        return True

    def attainment(self, now: Optional[float] = None) -> Optional[float]:
        """good / total over the window; None on an empty window."""
        samples = self._samples(now)
        if not samples:
            return None
        return sum(1 for s in samples if self._good(s)) / len(samples)

    def burn_rate(self, now: Optional[float] = None) -> Optional[float]:
        """Error-budget burn rate: (1 - attainment) / (1 - target).
        1.0 spends the budget exactly at the objective; 2.0 exhausts it
        in half the period.  None on an empty window, and None when the
        configured target leaves no budget (slo_target >= 1.0)."""
        att = self.attainment(now)
        if att is None or self._zero_budget:
            return None
        return (1.0 - att) / (1.0 - self.target)

    def rejection_rate(self, now: Optional[float] = None
                       ) -> Optional[float]:
        """(rejected + expired) / total over the window — the shed
        fraction an open-loop client observes."""
        c = self.counts(now)
        total = sum(c.values())
        if not total:
            return None
        return (c["rejected"] + c["expired"]) / total

    @staticmethod
    def _tripped(rejection_rate: Optional[float],
                 queue_depth: Optional[int],
                 queue_capacity: Optional[int]) -> bool:
        if rejection_rate is not None and \
                rejection_rate > OVERLOAD_REJECT_RATE:
            return True
        if queue_depth is not None and queue_capacity:
            if queue_depth >= OVERLOAD_QUEUE_FRAC * queue_capacity:
                return True
        return False

    def overloaded(self, queue_depth: Optional[int] = None,
                   queue_capacity: Optional[int] = None,
                   now: Optional[float] = None) -> bool:
        """The trip wire: windowed shed rate past
        :data:`OVERLOAD_REJECT_RATE`, or the caller's OUTSTANDING work
        (queued + in-flight) past :data:`OVERLOAD_QUEUE_FRAC` of
        admission capacity."""
        return self._tripped(self.rejection_rate(now), queue_depth,
                             queue_capacity)

    # ------------------------------------------------------------ snapshot
    def snapshot(self, queue_depth: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 now: Optional[float] = None,
                 emit_event: bool = True,
                 include_percentiles: bool = True,
                 publish_gauges: bool = True) -> dict:
        """The full SLO picture as one dict — computed from ONE pass
        over the window (pollers call this once per scrape; the
        per-metric helpers each copy the reservoir).  Also refreshes
        the ``amgx_slo_*`` gauges and — with ``emit_event`` — a
        schema-validated ``slo_window`` event when telemetry is
        enabled.  Poll paths (``/healthz``, ``/metrics``) pass
        ``emit_event=False``: a load balancer probing at 1 Hz would
        otherwise fill the bounded event ring with SLO noise, evicting
        the solve spans and request traces ``/debug/trace`` exists to
        expose.  The gauge refresh on those paths updates the registry
        ONLY (no raw ring samples) for the same reason."""
        samples = self._samples(now)
        c = self._counts_of(samples)
        total = sum(c.values())
        att = (sum(1 for s in samples if self._good(s)) / total
               if total else None)
        burn = ((1.0 - att) / (1.0 - self.target)
                if att is not None and not self._zero_budget else None)
        rej = ((c["rejected"] + c["expired"]) / total
               if total else None)
        # the sort over the waited latencies is the expensive part of a
        # snapshot; poll paths (health/scrape at LB rates) never read
        # the percentiles, so they skip it
        pct = (self._percentiles_of(samples) if include_percentiles
               else {"p50": None, "p95": None, "p99": None})
        over = self._tripped(rej, queue_depth, queue_capacity)
        out = {
            "window_s": self.window_s,
            "objective": {"latency_ms": self.latency_objective_s * 1e3,
                          "target": self.target},
            "requests": int(total),
            "by_outcome": c,
            "attainment": att,
            "burn_rate": burn,
            "rejection_rate": rej,
            "latency_s": pct,
            "overloaded": bool(over),
        }
        # publish_gauges=False: secondary windows (the per-lane SLO
        # windows of the multi-lane serving layer) must not overwrite
        # the service-level amgx_slo_* gauges — lanes publish their own
        # amgx_serve_lane_attainment{lane} series instead
        if recorder.is_enabled() and publish_gauges:
            gset = (metrics.gauge_set if emit_event
                    else metrics.registry().gauge_set)
            gset("amgx_slo_window_requests", float(total))
            if att is not None:
                gset("amgx_slo_attainment", float(att))
            else:
                # an evicted-to-empty (or reset) window must DROP the
                # gauges: a degraded wave hours ago would otherwise
                # scrape as a live outage forever
                metrics.registry().gauge_clear("amgx_slo_attainment")
            if burn is not None:
                gset("amgx_slo_burn_rate", float(burn))
            else:
                metrics.registry().gauge_clear("amgx_slo_burn_rate")
            gset("amgx_serve_overload", 1.0 if over else 0.0)
            if emit_event:
                recorder.event(
                    "slo_window", window_s=self.window_s,
                    requests=int(total),
                    attainment=att, burn_rate=burn,
                    by_outcome=c, overloaded=bool(over),
                    latency_ms_objective=self.latency_objective_s * 1e3,
                    target=self.target)
        return out


def from_config(cfg) -> SLOWindow:
    """Build the window from the ``slo_*`` knobs of a resolved config
    (config/registry.py)."""
    return SLOWindow(window_s=float(cfg.get("slo_window_s")),
                     latency_ms=float(cfg.get("slo_latency_ms")),
                     target=float(cfg.get("slo_target")))
