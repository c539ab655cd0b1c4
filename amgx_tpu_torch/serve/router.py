"""Multi-device serving scale-out: executor lanes + pattern routing
(port of ``amgx_tpu/serve/router.py``).

One :class:`SolveService` on an N-card host would serve at 1-card
throughput if every batch funneled through a single queue, worker pool
and device.  This module is the scale-out layer — the
"millions of small user systems" analog of AmgX's domain decomposition
(PAPER.md §2.11): instead of splitting ONE matrix across cards, it
*replicates with affinity* — many independent hierarchies, each
resident on one card, with traffic routed to where the setup already
lives.

* :class:`ExecutorLane` — one per visible device: its own bounded
  queue, batching dispatcher, worker pool, :class:`SetupCache` slice
  with a per-lane device-byte budget, and SLO window.  Sessions created
  by a lane carry the lane's ``placement`` device, so their hierarchy,
  smoother arrays and CUDA graphs live on that card
  (``SolverSession`` pins setup/solve under
  ``torch.cuda.device(lane.device)``).
* :class:`PatternRouter` — the policy in front of the lanes:

  - **affinity**: repeat traffic for a known pattern fingerprint goes
    to the lane already holding that session's hierarchy (setup reuse
    is worth more than queue balance);
  - **replication**: when a hot pattern saturates its home lane
    (queue fraction ≥ ``serve_replicate_frac``) while another lane
    idles (≤ ``serve_steal_frac``), the pattern is replicated onto the
    idle lane — the shared kernel build directory and plan store mean
    the replica pays setup numeric work, value upload and its graph
    captures, not kernel builds; replicated traffic is split by VALUES fingerprint so
    one ``(key, values)`` micro-batch never splits across lanes;
  - **work stealing**: a cold (never-seen) pattern is placed on the
    least-loaded lane (ties broken toward fewest resident homes, then
    the pattern's stable hash slot) — a *steal* when its hash-home
    lane was busy (> ``serve_steal_frac``) and the work went
    elsewhere.  The chosen lane *becomes* its home, so the follow-up
    burst batches there instead of splitting.

Per-lane health feeds the lane-aware ``/healthz`` contract (503 only
when EVERY lane is saturated; the body names the saturated subset so a
load balancer — or this router — can drain one card via
``SolveService.drain_lane``).  ``amgx_serve_lane_*`` gauges and
``amgx_serve_{steals,replications}_total`` counters make the routing
observable; the doctor's "serving lanes" section reads them back.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import List, Optional, Tuple

from .. import telemetry
from ..errors import RC
from .batch import SolveRequest, execute_batch, split_batches
from .cache import SetupCache


def _stable_idx(token: str, n: int) -> int:
    """Deterministic [0, n) slot for a fingerprint string (NOT python's
    ``hash`` — that is per-process salted, and the hash-home must agree
    across restarts so a re-warmed process re-homes patterns
    identically)."""
    if n <= 1:
        return 0
    h = hashlib.blake2b(token.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") % n


class ExecutorLane:
    """One device's executor: bounded queue → batching dispatcher →
    worker pool, with a per-lane setup-cache slice and SLO window.
    The lane is the single-device :class:`SolveService` core, made
    instantiable N times."""

    def __init__(self, service, index: int, device=None,
                 cache_bytes: int = 1 << 30):
        self.service = service
        self.index = int(index)
        #: card this lane executes on; None = the matrix's own device
        #: (lane 0: the current card for CUDA matrices, the CPU for CPU
        #: matrices; no placement views)
        self.device = device
        cfg = service.cfg
        self.queue_depth = int(cfg.get("serve_queue_depth"))
        self.batch_window_s = float(cfg.get("serve_batch_window_ms")) / 1e3
        self.max_batch = int(cfg.get("serve_max_batch"))
        #: the lane's SetupCache slice — its own LRU and DEVICE-byte
        #: budget: eviction pressure on a saturated lane never evicts
        #: another card's resident hierarchies
        self.cache = SetupCache(int(cache_bytes), placement=device,
                                lane=self.index)
        from ..telemetry import slo as _slo
        #: per-lane SLO window (the service keeps the aggregate one);
        #: never emits events — the service window owns the trace
        self.slo = _slo.from_config(cfg)
        from ..utils.thread_manager import ThreadManager
        self._tm = ThreadManager(max_workers=int(cfg.get("serve_workers")))
        self._cond = threading.Condition()
        self._queue: List[SolveRequest] = []
        self._inflight = 0
        self._running = False
        self._dispatcher: Optional[threading.Thread] = None
        #: admission flag for draining ONE card while the service keeps
        #: serving (the router treats a non-accepting lane as saturated)
        self.accepting = True
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        #: cold/novel-pattern requests the router placed here instead of
        #: their hash-home lane
        self.stolen_in = 0
        #: per-request execution retry budget (serve_retry_max): a
        #: batch whose prepare/solve RAISED re-queues its requests,
        #: deadline permitting, instead of failing them outright
        self.retry_max = int(cfg.get("serve_retry_max"))
        #: circuit breaker (serve_breaker_*): N consecutive failed
        #: batches open the breaker — the router routes around this
        #: lane until the cooldown elapses (half-open).  0 disables.
        self.breaker_threshold = int(cfg.get("serve_breaker_threshold"))
        self.breaker_cooldown_s = \
            float(cfg.get("serve_breaker_cooldown_s"))
        self._consec_failures = 0
        self._tripped_until = 0.0
        self.breaker_trips = 0

    # ------------------------------------------------------------ lifecycle
    def start(self):
        with self._cond:
            if self._running:
                return self
            self._running = True
        self._tm.spawn_threads()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop,
            name=f"amgx-serve-lane{self.index}", daemon=True)
        self._dispatcher.start()
        return self

    def stop(self):
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5.0)
            self._dispatcher = None
        try:
            self._tm.join_threads(timeout=5.0)
        except Exception:   # noqa: BLE001 — worker-death exceptions
            # were already delivered through the request handles (the
            # reap callback); re-raising them would wedge shutdown
            pass

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Flush this lane's queued + in-flight work.  Returns a
        per-lane report (the service's concurrent :meth:`SolveService.
        drain` aggregates them): ``ok`` is False when the lane timed
        out with work still queued or executing — a wedged batch on one
        card must be visible as THAT lane's timeout, not as the whole
        service hanging."""
        t0 = time.monotonic()
        t_end = None if timeout is None else t0 + timeout
        ok = True
        with self._cond:
            while self._queue or self._inflight:
                left = None if t_end is None else t_end - time.monotonic()
                if left is not None and left <= 0:
                    ok = False
                    break
                self._cond.wait(timeout=min(left or 0.05, 0.05))
            queued, inflight = len(self._queue), self._inflight
        if ok:
            try:
                self._tm.wait_threads(
                    None if t_end is None
                    else max(t_end - time.monotonic(), 0.0) + 1.0)
            except Exception:   # noqa: BLE001 — a dead worker's
                # exception already failed its requests cleanly (the
                # reap callback); the drain itself completed
                pass
        return {"lane": self.index, "ok": ok, "queued": queued,
                "inflight": inflight,
                "seconds": round(time.monotonic() - t0, 4)}

    # ------------------------------------------------------------ admission
    def outstanding(self) -> int:
        with self._cond:
            return len(self._queue) + self._inflight

    def queue_fraction(self) -> float:
        """Outstanding work as a fraction of this lane's admission
        capacity — the router's load signal.  A non-accepting
        (draining) lane — or one whose circuit breaker is open — reads
        as fully loaded, so every routing policy steers around it."""
        if not self.accepting or self.breaker_open:
            return float("inf")
        return self.outstanding() / max(self.queue_depth, 1)

    # ------------------------------------------------------ circuit breaker
    @property
    def breaker_open(self) -> bool:
        return self.breaker_threshold > 0 \
            and time.monotonic() < self._tripped_until

    def record_batch_result(self, ok: bool):
        """Feed the breaker one batch outcome: N consecutive failures
        (serve_breaker_threshold) open it for the cooldown; any success
        closes it and clears the streak."""
        if self.breaker_threshold <= 0:
            return
        tripped = False
        with self._lock:
            if ok:
                self._consec_failures = 0
                self._tripped_until = 0.0
                return
            self._consec_failures += 1
            if self._consec_failures >= self.breaker_threshold \
                    and time.monotonic() >= self._tripped_until:
                self._tripped_until = time.monotonic() \
                    + self.breaker_cooldown_s
                self.breaker_trips += 1
                tripped = True
        if tripped:
            telemetry.counter_inc("amgx_serve_breaker_trips_total",
                                  lane=self.index)
            telemetry.event("lane_breaker_trip", lane=self.index,
                            consecutive_failures=self._consec_failures,
                            cooldown_s=self.breaker_cooldown_s)

    def try_admit(self, req: SolveRequest) -> bool:
        """Admit ``req`` into this lane's queue; False when over
        capacity or the lane is draining (the service then sheds with
        ``RC.REJECTED``)."""
        with self._cond:
            if not self.accepting or \
                    len(self._queue) + self._inflight >= self.queue_depth:
                return False
            req.mark("admitted")
            self._queue.append(req)
            depth = len(self._queue)
            self._cond.notify_all()
        with self._lock:
            self.submitted += 1
        telemetry.gauge_set("amgx_serve_lane_queue_depth", depth,
                            lane=self.index)
        return True

    # ------------------------------------------------------------- dispatch
    def _dispatch_loop(self):
        while True:
            with self._cond:
                while self._running and not self._queue:
                    self._cond.wait(timeout=0.05)
                if not self._running and not self._queue:
                    return
                if not self._queue:
                    continue
                if self.batch_window_s > 0 and \
                        len(self._queue) < self.max_batch:
                    self._cond.wait(timeout=self.batch_window_s)
                drained, self._queue = self._queue, []
                self._inflight += len(drained)
                telemetry.gauge_set("amgx_serve_lane_queue_depth", 0,
                                    lane=self.index)
                telemetry.gauge_set("amgx_serve_lane_inflight",
                                    self._inflight, lane=self.index)
            self.service._refresh_queue_gauges()
            for batch in split_batches(drained, self.max_batch):
                task = self._batch_task(batch)
                fut = self._tm.push_work(task)
                if fut is not None:
                    # worker-death guard: if the worker dies BEFORE the
                    # batch body runs (its own try/finally never
                    # engages), the done-callback fails the in-flight
                    # requests cleanly instead of hanging their waiters
                    fut.add_done_callback(
                        lambda f, t=task, b=batch:
                        self._reap_batch(t, b, f))

    def _reap_batch(self, task, batch: List[SolveRequest], fut):
        """Future done-callback: no-op when the batch body ran (it
        completed every request and dropped the in-flight count
        itself); when the worker died before entering it, the retry
        budget gets the same say it has for an in-body failure (the
        knob's contract cannot depend on WHERE in the worker the death
        landed), then the rest finish with a terminal error, the
        breaker is fed, and the in-flight accounting released."""
        if getattr(task, "entered", False):
            return
        exc = fut.exception()
        msg = (f"worker died before batch execution: "
               f"{type(exc).__name__}: {exc}") if exc is not None \
            else "worker died before batch execution"
        requeued: set = set()
        errored = 0
        for r in batch:
            if r.done() or self._maybe_retry(r, requeued, msg):
                continue
            r.mark("errored")
            r.complete(None, rc=RC.UNKNOWN, error=msg)
            errored += 1
        if errored:
            telemetry.counter_inc("amgx_serve_requests_total",
                                  status="ERROR", value=float(errored))
        self.record_batch_result(False)
        with self._cond:
            self._inflight -= len(batch)
            telemetry.gauge_set("amgx_serve_lane_inflight",
                                self._inflight, lane=self.index)
            self._cond.notify_all()
        self.service._refresh_queue_gauges()

    def _maybe_retry(self, req: SolveRequest, requeued: set,
                     msg: str) -> bool:
        """The per-request retry budget (serve_retry_max): re-queue a
        request whose batch RAISED, deadline permitting.  Returns True
        when the request was claimed (the caller must not complete
        it)."""
        if self.retry_max <= 0 or req.retries >= self.retry_max:
            return False
        if req.expired() or not self._running or not self.accepting:
            return False            # the deadline/drain makes it final
        req.retries += 1
        req.mark("requeued")
        requeued.add(id(req))
        telemetry.counter_inc("amgx_serve_retries_total")
        with self._cond:
            self._queue.append(req)
            self._cond.notify_all()
        return True

    def _batch_task(self, batch: List[SolveRequest]):
        svc = self.service
        profile = svc._take_profile_slot()

        def run():
            # the reap callback keys on this flag: once the body is
            # entered, ITS try/finally owns request completion and the
            # in-flight accounting
            run.entered = True
            session = None
            #: requests the retry budget re-queued — they are alive in
            #: the lane queue again and must NOT be completed here
            requeued: set = set()

            def retry(req, msg):
                return self._maybe_retry(req, requeued, msg)

            batch_ok = True
            try:
                session, _created = self.cache.get_or_create(
                    svc.cfg, batch[0].matrix, key=batch[0].key)
                execute_batch(session, batch, cache=self.cache,
                              retry=retry)
                done = sum(1 for r in batch if r.rc == RC.OK
                           and r.done())
                shed = sum(1 for r in batch if r.rc == RC.REJECTED)
                # a batch that only survived by re-queueing its
                # requests still FAILED — counting it ok would reset
                # (or even close) the breaker on every retried failure
                batch_ok = not requeued and \
                    not any(r.done() and r.outcome() == "error"
                            for r in batch)
                with self._lock:
                    self.completed += done
                    self.rejected += shed
                with svc._lat_lock:
                    svc.completed += done
                    # deadline sheds happen here, past admission — they
                    # must show in stats() like any other rejection
                    svc.rejected += shed
                if profile:
                    svc._profile_batch(session, batch)
            except Exception as e:  # noqa: BLE001 — swallowed ON PURPOSE:
                # the failure is delivered through the request handles;
                # letting it reach the future would make a later
                # drain()'s wait_threads() re-raise it mid-shutdown
                batch_ok = False
                msg = f"{type(e).__name__}: {e}"
                for r in batch:
                    if id(r) in requeued or r.done():
                        continue
                    if self._maybe_retry(r, requeued, msg):
                        continue
                    r.mark("errored")
                    r.complete(None, rc=RC.UNKNOWN, error=msg)
            finally:
                for r in batch:
                    if id(r) in requeued:
                        continue      # alive again in the lane queue
                    if not r.done():  # belt-and-braces: no waiter hangs
                        r.mark("errored")
                        r.complete(None, rc=RC.UNKNOWN,
                                   error="batch task failed")
                # the circuit breaker eats one outcome per batch —
                # worker death / poisoned setup trips it, a healthy
                # batch closes it
                self.record_batch_result(batch_ok)
                with self._cond:
                    self._inflight -= len(batch)
                    telemetry.gauge_set("amgx_serve_lane_inflight",
                                        self._inflight, lane=self.index)
                    self._cond.notify_all()
                svc._refresh_queue_gauges()
        run.entered = False
        return run

    # ---------------------------------------------------------------- state
    def health(self) -> dict:
        """This lane's liveness leg of the lane-aware ``/healthz``
        body: saturated (overloaded) is the lane's OWN windowed shed
        rate / outstanding work, so the service can 503 only when every
        lane trips while naming the saturated subset."""
        with self._cond:
            depth = len(self._queue)
            inflight = self._inflight
        snap = self.slo.snapshot(queue_depth=depth + inflight,
                                 queue_capacity=self.queue_depth,
                                 emit_event=False,
                                 include_percentiles=False,
                                 publish_gauges=False)
        if telemetry.is_enabled():
            # the scrape path (/metrics → service.health → here) must
            # refresh EVERY per-lane gauge, not just the SLO ones — the
            # queue/inflight updates on the request path may have run
            # before telemetry was enabled
            if snap["attainment"] is not None:
                telemetry.gauge_set("amgx_serve_lane_attainment",
                                    snap["attainment"], lane=self.index)
            telemetry.gauge_set("amgx_serve_lane_sessions",
                                len(self.cache), lane=self.index)
            telemetry.gauge_set("amgx_serve_lane_queue_depth", depth,
                                lane=self.index)
            telemetry.gauge_set("amgx_serve_lane_inflight", inflight,
                                lane=self.index)
        return {
            "lane": self.index,
            "device": str(self.device) if self.device is not None
            else "default",
            "accepting": bool(self.accepting),
            "queue_depth": depth,
            "queue_capacity": self.queue_depth,
            "inflight": inflight,
            "sessions": len(self.cache),
            # memory-ledger leg of healthz: what evicting this lane's
            # whole cache would free (device bytes of every resident
            # prepared hierarchy)
            "resident_bytes": self.cache.resident_bytes(),
            "overloaded": snap["overloaded"],
            "slo_attainment": snap["attainment"],
            # circuit breaker (serve_breaker_threshold): an open
            # breaker means the router is steering around this lane
            "breaker_open": bool(self.breaker_open),
            "breaker_trips": int(self.breaker_trips),
        }

    def stats(self) -> dict:
        with self._lock:
            counts = {"submitted": self.submitted,
                      "completed": self.completed,
                      "rejected": self.rejected,
                      "stolen_in": self.stolen_in}
        h = self.health()
        h.update(counts)
        h["cache"] = {k: self.cache.stats()[k]
                      for k in ("sessions", "hits", "misses",
                                "evictions", "resident_bytes",
                                "max_bytes")}
        return h


class PatternRouter:
    """Pattern-affinity routing + hot-pattern replication + cold-pattern
    work stealing over a set of :class:`ExecutorLane`\\ s.  Thread-safe;
    every decision is O(lanes)."""

    #: routing decision vocabulary (telemetry + stats)
    DECISIONS = ("affinity", "cold", "steal", "replicate", "overflow")

    #: LRU bound on the home map — a service facing a stream of
    #: distinct one-off patterns must not grow its routing table
    #: forever (the evicted pattern's session is long gone from the
    #: lane caches too; it simply re-routes cold on its next sight)
    MAX_PATTERNS = 65536

    def __init__(self, lanes: List[ExecutorLane],
                 replicate_frac: float = 0.75,
                 steal_frac: float = 0.5):
        import collections
        self.lanes = lanes
        #: home-lane queue fraction at which a hot pattern may be
        #: replicated onto an idle lane
        self.replicate_frac = float(replicate_frac)
        #: queue fraction under which a lane counts as idle (replica
        #: target), and over which a cold pattern's hash-home is
        #: skipped in favor of the least-loaded lane (the steal)
        self.steal_frac = float(steal_frac)
        self._lock = threading.Lock()
        #: pattern fingerprint -> lane indices holding (or assigned)
        #: that pattern's session; [0] is the home lane.  LRU-ordered
        #: (route() touches) and bounded by MAX_PATTERNS
        self._homes: "collections.OrderedDict[str, List[int]]" = \
            collections.OrderedDict()
        #: lane index -> resident home/replica count, maintained
        #: INCREMENTALLY — cold placement must not rescan the whole
        #: home map under the router lock on every novel pattern
        self._home_counts = {lane.index: 0 for lane in lanes}
        self.steals = 0
        self.replications = 0
        self.decisions = {k: 0 for k in self.DECISIONS}

    # ------------------------------------------------------------- policy
    def _least_loaded(self, exclude=()) -> Optional[int]:
        best, best_load = None, None
        for lane in self.lanes:
            if lane.index in exclude or not lane.accepting:
                continue
            load = lane.queue_fraction()
            if best_load is None or load < best_load:
                best, best_load = lane.index, load
        return best

    def _cold_target(self, hh: int, loads) -> int:
        """Placement of a never-seen pattern: the least-loaded lane,
        ties broken toward the lane holding the FEWEST homes (a fleet
        warming N patterns on an idle mesh must spread them, not pile
        them on one slot), then toward the pattern's hash-home (stable
        across restarts when everything else ties)."""
        counts = self._home_counts
        best = None
        for lane in self.lanes:
            i = lane.index
            if not lane.accepting:
                continue
            key = (loads[i] > self.steal_frac, counts.get(i, 0),
                   loads[i], 0 if i == hh else 1, i)
            if best is None or key < best[0]:
                best = (key, i)
        return hh if best is None else best[1]

    def _assign_home(self, pattern: str, lane_idx: int):
        """Record a new home (LRU-bounded) + its incremental count."""
        self._homes[pattern] = [lane_idx]
        self._homes.move_to_end(pattern)
        self._home_counts[lane_idx] = \
            self._home_counts.get(lane_idx, 0) + 1
        while len(self._homes) > self.MAX_PATTERNS:
            _, old = self._homes.popitem(last=False)
            for i in old:
                self._home_counts[i] = \
                    max(self._home_counts.get(i, 0) - 1, 0)

    def route(self, pattern: str, values_fp: str = "") -> Tuple[int, str]:
        """Pick the lane for one request: ``(lane_index, decision)``
        with decision in :data:`DECISIONS`.  The home map mutates here
        (first sight assigns a home; saturation may add a replica), so
        calls are serialized on the router lock; lane loads are read
        without lane locks — they are advisory."""
        loads = [lane.queue_fraction() for lane in self.lanes]
        with self._lock:
            holders = self._homes.get(pattern)
            if holders is None:
                # cold pattern: least-loaded placement — a STEAL when
                # the hash-home lane was busy and the work went
                # elsewhere.  The chosen lane BECOMES the home, so the
                # follow-up burst batches there instead of splitting
                # back to the hash slot
                hh = _stable_idx(pattern, len(self.lanes))
                tgt = self._cold_target(hh, loads)
                self._assign_home(pattern, tgt)
                if tgt != hh and loads[hh] > self.steal_frac:
                    self.steals += 1
                    self.decisions["steal"] += 1
                    self.lanes[tgt].stolen_in += 1
                    telemetry.counter_inc("amgx_serve_steals_total",
                                          lane=tgt)
                    return tgt, "steal"
                self.decisions["cold"] += 1
                return tgt, "cold"
            self._homes.move_to_end(pattern)
            # known pattern: candidates = home + replicas.  The pick is
            # VALUES-keyed and STICKY: one (key, values) group stays on
            # one lane for as long as the candidate set is stable —
            # re-picking by load would split a burst's micro-batch the
            # moment its lane crossed a threshold mid-burst, paying a
            # resetup on the second lane for nothing.  Only a topology
            # change (a new replica) reshuffles the picks.
            cands = [i for i in holders if self.lanes[i].accepting] \
                or list(holders)
            pick = cands[_stable_idx(values_fp, len(cands))] \
                if len(cands) > 1 else cands[0]
            if loads[pick] < self.replicate_frac:
                self.decisions["affinity"] += 1
                return pick, "affinity"
            # the picked holder is saturated: replicate onto an idle
            # non-holder lane
            idle = self._least_loaded(exclude=set(holders))
            if idle is not None and loads[idle] <= self.steal_frac:
                holders.append(idle)
                self._home_counts[idle] = \
                    self._home_counts.get(idle, 0) + 1
                self.replications += 1
                self.decisions["replicate"] += 1
                telemetry.counter_inc("amgx_serve_replications_total",
                                      lane=idle)
                return idle, "replicate"
            # no idle lane: overflow ON the sticky pick (admission
            # backpressure does the shedding there), falling back to
            # any accepting lane only when the pick is draining
            best = pick
            if not self.lanes[best].accepting:
                alt = self._least_loaded()
                if alt is not None:
                    best = alt
            self.decisions["overflow"] += 1
            return best, "overflow"

    # -------------------------------------------------------------- state
    def holders(self, pattern: str) -> List[int]:
        with self._lock:
            return list(self._homes.get(pattern, ()))

    def sessions_by_lane(self) -> dict:
        """lane index -> number of patterns homed/replicated there (the
        doctor's imbalance signal; incrementally maintained)."""
        out = {lane.index: 0 for lane in self.lanes}
        with self._lock:
            out.update(self._home_counts)
        return out

    def stats(self) -> dict:
        with self._lock:
            n_rep = sum(1 for h in self._homes.values() if len(h) > 1)
            out = {
                "patterns": len(self._homes),
                "replicated_patterns": n_rep,
                "steals": self.steals,
                "replications": self.replications,
                "decisions": dict(self.decisions),
                "thresholds": {"replicate_frac": self.replicate_frac,
                               "steal_frac": self.steal_frac},
            }
        out["sessions_by_lane"] = self.sessions_by_lane()
        return out


def build_lanes(service, n_lanes: int, cache_bytes_total: int
                ) -> List[ExecutorLane]:
    """The service's lane set: lane i executes on visible card
    ``i % ncards`` (lane 0 keeps ``device=None`` — the matrix's own
    device, which for a CUDA matrix is the current card and never the
    CPU).  ``serve_lanes=0`` resolves to one lane per visible card (one
    on a single-card host).  Without a card every lane keeps
    ``device=None``: it serves the CPU matrices callers submit.  The
    setup-cache budget is sliced evenly so N saturated lanes cannot
    evict each other."""
    import torch
    ncards = torch.cuda.device_count() if torch.cuda.is_available() \
        else 0
    devices = [torch.device("cuda", i) for i in range(ncards)] or [None]
    if n_lanes <= 0:
        n_lanes = len(devices)
    n_lanes = max(1, int(n_lanes))
    per_lane = max(1, int(cache_bytes_total) // n_lanes)
    lanes = []
    for i in range(n_lanes):
        dev = devices[i % len(devices)]
        lanes.append(ExecutorLane(
            service, i,
            device=None if i % len(devices) == 0 else dev,
            cache_bytes=per_lane))
    return lanes
