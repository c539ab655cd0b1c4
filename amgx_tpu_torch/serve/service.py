"""The concurrent solve service: admission → routing → lane execution
(port of ``amgx_tpu/serve/service.py``).

:class:`SolveService` accepts many ``(matrix, b)`` requests and executes
them efficiently across every visible device, the same playbook an
inference server uses:

* **admission**: per-lane bounded queues; a full lane sheds load
  immediately with :data:`RC.REJECTED` (the documented backpressure
  contract) — queueing unboundedly would trade a fast "no" for a slow
  timeout.  Optional per-request deadlines reject work whose answer
  nobody is waiting for anymore.
* **routing** (multi-device scale-out, :mod:`~amgx_tpu_torch.serve.router`):
  one :class:`~amgx_tpu_torch.serve.router.ExecutorLane` per visible device
  (own queue, dispatcher, worker pool, setup-cache slice, SLO window),
  fronted by a :class:`~amgx_tpu_torch.serve.router.PatternRouter` that
  (a) routes repeat traffic by pattern fingerprint to the lane holding
  that session's hierarchy, (b) replicates hot patterns onto idle lanes
  when the home lane saturates, and (c) work-steals cold patterns to
  the least-loaded lane.  ``serve_lanes=1`` (the default) is the
  single-device service.
* **batching**: each lane's dispatcher drains its queue, groups
  requests by (config, pattern, values) within
  ``serve_batch_window_ms``, and hands micro-batches to the lane's
  worker pool (:func:`~amgx_tpu_torch.serve.batch.split_batches`).
* **execution**: lane workers run each batch — session prepare (full
  setup / resetup / reuse via the lane's pattern-keyed
  :class:`~amgx_tpu_torch.serve.cache.SetupCache` slice) then the stacked
  multi-RHS solve, pinned to the lane's device.  One session's
  requests serialise on its lock; on the card, every session's setup
  and solves also hold the card's lock (``device.device_lock``: a CUDA
  graph replays into fixed buffers and its capture is invalidated by
  another thread's launch), so the workers overlap their host work,
  not their device work.  CPU sessions solve concurrently.
* **drain/shutdown**: :meth:`drain` stops admission and flushes every
  lane CONCURRENTLY, surfacing per-lane timeouts (one wedged card
  must not hide the others' clean drain); :meth:`drain_lane` drains a
  single card while the service keeps serving (the router re-routes
  its homed patterns); :meth:`shutdown` additionally joins the pools.

All knobs come from the config (``serve_*`` parameters,
config/registry.py) so C-shaped drivers configure the service exactly
like a solver.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from .. import telemetry
from ..config import AMGConfig
from ..core.matrix import Matrix
from ..errors import RC
from ..telemetry import slo as _slo
from .batch import PendingSolve, SolveRequest
from .router import PatternRouter, build_lanes
from .session import SessionKey, config_hash


class SolveService:
    def __init__(self, config, start: bool = True):
        cfg = config if isinstance(config, AMGConfig) \
            else AMGConfig(config)
        self.cfg = cfg
        g = lambda name: cfg.get(name)
        self.queue_depth = int(g("serve_queue_depth"))
        self.batch_window_s = float(g("serve_batch_window_ms")) / 1e3
        self.max_batch = int(g("serve_max_batch"))
        self.default_deadline_s = float(g("serve_deadline_ms")) / 1e3
        #: poison-pill quarantine (serve_quarantine_threshold): N
        #: consecutive error-outcome requests of one pattern reject it
        #: at ADMISSION — the pre-hardening service re-ran a failing
        #: setup for every retrying client, forever
        self.quarantine_threshold = int(g("serve_quarantine_threshold"))
        self._pattern_failures: dict = {}
        self._quarantined: dict = {}
        #: chaos harness (utils/faultinject.py): a non-empty
        #: fault_inject spec arms the process-global injection plan
        fi_spec = str(g("fault_inject"))
        if fi_spec:
            from ..utils import faultinject
            faultinject.configure_knob(fi_spec)
        #: the service's config never changes — hash it once, not per
        #: submit (the pattern fingerprint side is cached on the Matrix)
        self._cfg_hash = config_hash(cfg)
        #: per-device executor lanes + the affinity router in front of
        #: them; serve_lanes=1 (default) is the single-device service
        self.lanes = build_lanes(self, int(g("serve_lanes")),
                                 int(g("serve_cache_bytes")))
        self.router = PatternRouter(
            self.lanes,
            replicate_frac=float(g("serve_replicate_frac")),
            steal_frac=float(g("serve_steal_frac")))
        self._accepting = False
        self._lat_lock = threading.Lock()
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        #: the service-level SLO reservoir (every lane's terminal
        #: outcomes land here AND in the owning lane's window): shed
        #: load can never flatter the aggregate percentiles (slo_* knobs)
        self.slo = _slo.from_config(cfg)
        #: running per-phase sums (queue-wait vs solve split in
        #: stats()), keyed by the PHASE_OF_MARK vocabulary
        self._phase_totals: dict = {}
        #: sampled solve-path profiling: every Nth batch's fenced
        #: device seconds vs the cost model (0 = off)
        self.profile_every = int(g("serve_profile_every"))
        self._batch_seq = 0
        self._profile: dict = {}         # pattern -> capture summary
        #: per-lane report of the last drain()/drain_lane() —
        #: {"ok": bool, "lanes": [{lane, ok, queued, inflight, ...}]}
        self.last_drain: Optional[dict] = None
        #: observability endpoint (telemetry/httpd.py), started with
        #: the service when metrics_port > 0
        self.metrics_port = int(g("metrics_port"))
        self._endpoint = None
        #: serializes endpoint start/stop — two racing start_endpoint
        #: calls must not each bind a server (one would leak)
        self._endpoint_lock = threading.Lock()
        if start:
            self.start()

    # --------------------------------------------- single-lane compat views
    # The pre-scale-out service WAS its one lane; tests and embedders
    # that reached into the queue/cache internals keep working against
    # the primary lane (multi-lane callers use .lanes / stats()).
    @property
    def _cond(self):
        return self.lanes[0]._cond

    @property
    def _queue(self):
        return self.lanes[0]._queue

    @property
    def _inflight(self):
        return self.lanes[0]._inflight

    @_inflight.setter
    def _inflight(self, v):
        self.lanes[0]._inflight = v

    @property
    def cache(self):
        """The primary lane's setup cache (single-lane compatibility
        view; per-lane slices live on ``self.lanes[i].cache``)."""
        return self.lanes[0].cache

    # ------------------------------------------------------------ lifecycle
    def start(self):
        """Spawn every lane's dispatcher + worker pool and open
        admission.  Idempotent while running, and restartable after
        :meth:`shutdown` — ``lane.start()`` guards on its own running
        flag, so a stopped lane re-spawns while a live one is left
        alone (the pre-scale-out service was restartable; queued
        requests admitted between shutdown and restart must find a
        dispatcher, not wait forever)."""
        with self._lat_lock:
            self._accepting = True
        for lane in self.lanes:
            lane.start()
        if self.metrics_port > 0 and self._endpoint is None:
            try:
                self.start_endpoint(self.metrics_port)
            except Exception as e:   # noqa: BLE001 — port conflicts are
                # OSError but an out-of-range port raises OverflowError;
                # NO bind failure may kill the service — the
                # observability layer is strictly additive
                import warnings
                warnings.warn(f"amgx serve: observability endpoint "
                              f"failed to bind port "
                              f"{self.metrics_port}: {e}")
        return self

    def start_endpoint(self, port: Optional[int] = None) -> str:
        """Start the observability endpoint
        (:mod:`amgx_tpu_torch.telemetry.httpd`: /metrics /healthz /statusz
        /debug/trace /debug/profile) on 127.0.0.1; port 0 binds an
        ephemeral port.  Returns the base URL.  Idempotent."""
        from ..telemetry.httpd import serve_httpd
        with self._endpoint_lock:
            if self._endpoint is None:
                p = self.metrics_port if port is None else int(port)
                self._endpoint = serve_httpd(p, service=self)
            return self._endpoint.url

    @property
    def endpoint(self) -> Optional[str]:
        """Base URL of the running observability endpoint, or None."""
        return self._endpoint.url if self._endpoint is not None else None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admitting, then flush every lane CONCURRENTLY — queued
        requests and in-flight batches.  Returns True when every lane
        completed in time; the per-lane breakdown (which card timed
        out, with how much stuck work) lands in :attr:`last_drain` and
        a ``serve_drain`` telemetry event.  Draining lanes in sequence
        would serialize the whole service on the first slow card — a
        wedged batch on lane 2 must not delay lane 5's clean drain by
        its full timeout."""
        with self._lat_lock:
            self._accepting = False
        for lane in self.lanes:
            with lane._cond:
                lane._cond.notify_all()
        reports: List[Optional[dict]] = [None] * len(self.lanes)

        def _drain_one(i):
            reports[i] = self.lanes[i].drain(timeout)

        if len(self.lanes) == 1:
            _drain_one(0)
        else:
            threads = [threading.Thread(target=_drain_one, args=(i,),
                                        name=f"amgx-drain-lane{i}",
                                        daemon=True)
                       for i in range(len(self.lanes))]
            for t in threads:
                t.start()
            for t in threads:
                # lane.drain() bounds itself by `timeout`; the extra
                # join slack only covers scheduler lag, so a wedged
                # lane reports a timeout instead of hanging the caller
                t.join(timeout=None if timeout is None
                       else timeout + 5.0)
        ok = all(r is not None and r["ok"] for r in reports)
        self.last_drain = {
            "ok": ok,
            "lanes": [r or {"lane": i, "ok": False, "queued": None,
                            "inflight": None, "seconds": None}
                      for i, r in enumerate(reports)],
        }
        if telemetry.is_enabled():
            telemetry.event("serve_drain", ok=bool(ok),
                            lanes=self.last_drain["lanes"])
        if not ok:
            import warnings
            stuck = [f"lane {r['lane']} (queued={r['queued']}, "
                     f"inflight={r['inflight']})"
                     for r in self.last_drain["lanes"] if not r["ok"]]
            warnings.warn("amgx serve: drain timed out on "
                          + ", ".join(stuck))
        return ok

    def drain_lane(self, index: int,
                   timeout: Optional[float] = None) -> dict:
        """Drain ONE lane while the service keeps serving (the
        card-eviction path a load balancer's per-lane health view
        enables): the lane stops accepting, the router re-routes its
        homed patterns (a non-accepting lane reads as saturated, so
        repeat traffic replicates or steals elsewhere), and its queued
        work flushes.  Returns the lane's drain report.  Note:
        mesh-sharded (dist) operators always execute on lane 0, so
        draining lane 0 sheds dist traffic (reason ``draining``) until
        :meth:`resume_lane`."""
        lane = self.lanes[int(index)]
        lane.accepting = False
        with lane._cond:
            lane._cond.notify_all()
        report = lane.drain(timeout)
        self.last_drain = {"ok": report["ok"], "lanes": [report]}
        return report

    def resume_lane(self, index: int):
        """Reopen a drained lane for admission."""
        self.lanes[int(index)].accepting = True

    def shutdown(self, timeout: Optional[float] = None) -> bool:
        """Graceful stop: drain, stop every lane, join workers."""
        ok = self.drain(timeout)
        for lane in self.lanes:
            lane.stop()
        with self._endpoint_lock:
            if self._endpoint is not None:
                self._endpoint.stop()
                self._endpoint = None
        return ok

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # ------------------------------------------------------------ admission
    def submit(self, matrix: Matrix, b, x0=None,
               deadline_s: Optional[float] = None) -> PendingSolve:
        """Queue one solve.  Never blocks: with the routed lane over
        capacity (or after drain/shutdown) the returned handle is
        already completed with ``rc == RC.REJECTED`` — the backpressure
        signal callers must check before waiting."""
        ddl = deadline_s if deadline_s is not None \
            else (self.default_deadline_s or None)
        now = time.monotonic()
        values_fp = matrix.values_fingerprint()
        req = SolveRequest(
            matrix=matrix, b=b, x0=x0,
            key=SessionKey(config=self._cfg_hash,
                           pattern=matrix.pattern_fingerprint()),
            values_fp=values_fp,
            submitted_t=now,
            deadline_t=(now + ddl) if ddl else None,
            # terminal accounting (SLO window, phase fold, trace event)
            # runs inside complete(), BEFORE the waiter event: a client
            # that wakes from wait() and immediately snapshots the SLO
            # window must see this request counted
            on_terminal=self._finalize)
        reject_reason = None
        if not self._accepting:
            reject_reason = "draining"
        elif self.quarantine_threshold > 0 \
                and req.key.pattern in self._quarantined:
            # quarantined pattern: rejected AT ADMISSION — it never
            # reaches a lane, so its poisoned setup is never re-run
            reject_reason = "quarantined"
        else:
            if matrix.dist is not None and len(self.lanes) > 1:
                # a mesh-sharded operator owns EVERY device already —
                # lane placement is meaningless, so it always executes
                # on the primary lane (note: drain_lane(0) therefore
                # drains dist traffic too)
                lane_idx, decision = 0, "affinity"
            else:
                lane_idx, decision = self.router.route(req.key.pattern,
                                                       values_fp)
            req.lane, req.route = lane_idx, decision
            if not self.lanes[lane_idx].try_admit(req):
                # a non-accepting lane is DRAINING, not full — the two
                # shed reasons steer different operator responses
                # (add capacity vs finish the eviction)
                reject_reason = "queue_full" \
                    if self.lanes[lane_idx].accepting else "draining"
        # counters live under ONE lock (_lat_lock, shared with the
        # worker-side completion/deadline accounting) so concurrent
        # admission and deadline sheds never lose an increment
        if reject_reason is not None:
            with self._lat_lock:
                self.rejected += 1
            telemetry.counter_inc("amgx_serve_rejected_total",
                                  reason=reject_reason)
            telemetry.counter_inc("amgx_serve_requests_total",
                                  status="REJECTED")
            req.complete(None, rc=RC.REJECTED,
                         error=f"admission rejected: {reject_reason}")
            return PendingSolve(req)
        with self._lat_lock:
            self.submitted += 1
        return PendingSolve(req)

    def _refresh_queue_gauges(self):
        """Service-wide queue/inflight gauges = sums over lanes (the
        per-lane series carry the split).  Called from lane dispatch/
        completion transitions — NOT per submit: the submit hot path
        already pays one lane-lock sweep in the router's load read, and
        a second sweep per accepted request would contend with every
        dispatcher for the locks the per-lane design exists to keep
        apart."""
        if not telemetry.is_enabled():
            return
        depth, inflight = self._totals()
        telemetry.gauge_set("amgx_serve_queue_depth", depth)
        telemetry.gauge_set("amgx_serve_inflight", inflight)

    def _take_profile_slot(self) -> bool:
        """One shared sampling sequence across lanes: every Nth served
        batch, whichever lane runs it (serve_profile_every)."""
        with self._lat_lock:
            self._batch_seq += 1
            return self.profile_every > 0 and \
                self._batch_seq % self.profile_every == 0

    # ------------------------------------------------- request finalization
    def _finalize(self, req: SolveRequest):
        """Terminal accounting of ONE request, whatever its outcome:
        feed the service AND lane SLO windows, fold the phase split,
        and emit the schema-validated ``request_trace`` event +
        per-phase histograms.  Runs exactly once per request, inside
        ``SolveRequest.complete`` (the ``on_terminal`` hook) BEFORE the
        waiter event is set — a client that wakes from ``wait()`` and
        immediately snapshots the SLO window sees every finished
        request counted."""
        outcome = req.outcome()
        latency = req.latency_s()
        self._track_quarantine(req, outcome)
        deadline_met = req.deadline_t is None or (
            req.completed_mono is not None
            and req.completed_mono <= req.deadline_t)
        self.slo.record(latency, outcome, deadline_met=deadline_met)
        if req.lane is not None and req.lane < len(self.lanes):
            self.lanes[req.lane].slo.record(latency, outcome,
                                            deadline_met=deadline_met)
        # admission rejections never entered the lifecycle — their only
        # post-submit mark is "done", and folding that micro-gap into
        # the finalize phase would corrupt the split exactly when it
        # matters (under shedding); they count in the SLO window only
        admitted = any(nm == "admitted" for nm, _ in req.marks)
        durs = req.phase_durations() if admitted else {}
        with self._lat_lock:
            # a served answer counts before its waiter wakes (the
            # router's accounting of the batch runs after all of it)
            if req.rc == RC.OK:
                self.completed += 1
            for phase, d in durs.items():
                tot = self._phase_totals.setdefault(phase, [0, 0.0])
                tot[0] += 1
                tot[1] += d
        if telemetry.is_enabled():
            for phase, d in durs.items():
                telemetry.hist_observe("amgx_serve_phase_seconds", d,
                                       phase=phase)
            telemetry.event(
                "request_trace", trace_id=req.trace_id,
                outcome=outcome, rc=int(req.rc),
                latency_s=round(latency, 6),
                deadline_met=bool(deadline_met),
                pattern=req.key.pattern[:12],
                # the executor lane that served it + the router's
                # decision (affinity|cold|steal|replicate|overflow) —
                # the multi-lane trace dimension
                lane=req.lane, route=req.route,
                # "phases" speaks the DOCUMENTED phase vocabulary
                # (admit|queue_wait|...|finalize — what the histogram
                # labels and README teach); "marks" keeps the raw
                # monotone mark offsets for timeline reconstruction
                phases={k: round(v, 6) for k, v in durs.items()},
                marks={k: round(v, 6)
                       for k, v in req.phase_offsets().items()})

    # ----------------------------------------------------------- quarantine
    def _track_quarantine(self, req, outcome: str):
        """Per-pattern consecutive-failure tracking (the poison-pill
        guard): ``error`` outcomes count, any completed solve (ok or
        merely unconverged — the session WORKS) clears the streak;
        admission rejections and deadline sheds are neutral."""
        if self.quarantine_threshold <= 0:
            return
        pat = req.key.pattern
        newly = None
        with self._lat_lock:
            if outcome == "error":
                n = self._pattern_failures.get(pat, 0) + 1
                self._pattern_failures[pat] = n
                if n >= self.quarantine_threshold \
                        and pat not in self._quarantined:
                    self._quarantined[pat] = {
                        "failures": n, "t": time.time(),
                        "error": (req.error or "")[:200]}
                    newly = n
            elif outcome in ("ok", "failed"):
                self._pattern_failures.pop(pat, None)
        if newly is not None:
            telemetry.counter_inc("amgx_serve_quarantined_total")
            telemetry.gauge_set("amgx_serve_quarantined_patterns",
                                len(self._quarantined))
            telemetry.event("pattern_quarantined", pattern=pat[:12],
                            failures=int(newly),
                            error=(req.error or "")[:200])

    def quarantined_patterns(self) -> dict:
        """{pattern fingerprint: {"failures", "t", "error"}} of the
        currently quarantined patterns."""
        with self._lat_lock:
            return {k: dict(v) for k, v in self._quarantined.items()}

    def unquarantine(self, pattern: str) -> bool:
        """Lift one pattern's quarantine (operator action after fixing
        the root cause); returns True when it was quarantined.  Accepts
        a full fingerprint OR a unique prefix — ``/healthz`` reports
        patterns truncated to 12 chars, and the documented lift
        workflow must work from what the wire shows (an ambiguous
        prefix lifts nothing and returns False)."""
        with self._lat_lock:
            key = pattern if pattern in self._quarantined else None
            if key is None and pattern:
                matches = [p for p in self._quarantined
                           if p.startswith(pattern)]
                if len(matches) == 1:
                    key = matches[0]
            hit = key is not None \
                and self._quarantined.pop(key, None) is not None
            if hit:
                self._pattern_failures.pop(key, None)
        if hit:
            telemetry.gauge_set("amgx_serve_quarantined_patterns",
                                len(self._quarantined))
        return hit

    def solve(self, matrix: Matrix, b, x0=None,
              timeout: Optional[float] = None):
        """Convenience: submit + wait.  Raises on rejection."""
        from ..errors import AMGXError
        p = self.submit(matrix, b, x0=x0)
        if p.rc != RC.OK:
            raise AMGXError(p.error or "request rejected", p.rc)
        res = p.wait(timeout)
        if p.rc != RC.OK or res is None:
            raise AMGXError(p.error or "request failed",
                            p.rc if p.rc != RC.OK else RC.UNKNOWN)
        return res

    # -------------------------------------------------------------- warmup
    def warmup(self, patterns, max_batch: Optional[int] = None,
               all_lanes: bool = False) -> dict:
        """Prepare what a request wave would otherwise pay for, off the
        request path: each operator pattern is ROUTED (assigning its
        home lane — a warmup over the expected pattern set
        pre-distributes the fleet across lanes), its session prepared on
        that lane (full setup — hierarchy, packs, the setup engine's
        plans, the kernel builds) and one solve run, which captures the
        AMG's CUDA graphs.  The power-of-two batch-bucket ladder (1, 2,
        4, … ``serve_warmup_max_batch`` or ``serve_max_batch``) is
        covered by that one solve: the port's ``solve_multi`` runs a
        batch of any width as single solves, which replay the same
        graphs.  With ``compile_cache_dir`` / ``aot_store_dir``
        configured the setup both *loads* what a previous process
        persisted (built kernels, engine plans) and *persists* what it
        still had to build; a CUDA graph belongs to its process and is
        captured anew.

        ``patterns``: one :class:`~amgx_tpu_torch.core.matrix.Matrix` or
        an iterable of them (one per distinct sparsity pattern the
        service expects).  ``all_lanes=True`` additionally warms every
        pattern on EVERY lane (not just its routed home).  Returns a
        summary dict; also emitted as a ``serve_warmup`` telemetry
        event."""
        import numpy as np
        if isinstance(patterns, Matrix):
            patterns = [patterns]
        mb = int(max_batch) if max_batch else \
            (int(self.cfg.get("serve_warmup_max_batch"))
             or self.max_batch)
        # ladder reaches the next power of two ≥ max_batch: a full
        # batch of a non-power-of-two max_batch pads UP to that bucket
        ladder = [1]
        while ladder[-1] < max(1, mb):
            ladder.append(ladder[-1] * 2)
        t0 = time.monotonic()
        details = []
        for m in patterns:
            pattern = m.pattern_fingerprint()
            if m.dist is not None and len(self.lanes) > 1:
                lane_idx = 0
            else:
                # routing first assigns the HOME lane — a warmup over
                # the expected pattern set pre-distributes the fleet
                lane_idx, _ = self.router.route(
                    pattern, m.values_fingerprint())
            key = SessionKey(config=self._cfg_hash, pattern=pattern)
            lane_set = self.lanes if (all_lanes and m.dist is None) \
                else [self.lanes[lane_idx]]
            for lane in lane_set:
                sess, _created = lane.cache.get_or_create(self.cfg, m,
                                                          key=key)
                with sess.lock:
                    kind = sess.prepare(m)
                    n = int(m.shape[0])
                    # a zero right-hand side converges at iteration 0
                    # without applying the preconditioner; a ones vector
                    # runs it, and its first application captures the
                    # graphs every bucket width replays
                    sess.solve_batch(np.ones((1, n)))
                lane.cache.account(sess)
                details.append({"pattern": sess.key.pattern,
                                "lane": lane.index, "prepare": kind})
        wall = time.monotonic() - t0
        from . import aot
        summary = {"patterns": len(details), "buckets": ladder,
                   "seconds": round(wall, 4), "details": details,
                   "aot": aot.store_stats()}
        telemetry.event("serve_warmup", patterns=len(details),
                        buckets=len(ladder), seconds=wall)
        telemetry.hist_observe("amgx_serve_warmup_seconds", wall)
        return summary

    def _profile_batch(self, session, batch: List[SolveRequest]):
        """Sampled solve-path profiling (``serve_profile_every``): the
        batch's solve phase is already FENCED (solve_multi fetches
        every lane's stats to host before the ``solved`` mark), so the
        prepared→solved gap is measured device+dispatch seconds.  Fed
        into the cost model (telemetry/costmodel.py) as a per-pattern
        achieved-bandwidth floor: one fine-operator apply per iteration
        per lane — AMG cycles move strictly more, so the roofline
        fraction reported here is a lower bound."""
        try:
            ok = [r for r in batch
                  if r.rc == RC.OK and r.result is not None]
            if not ok:
                return
            t = dict(ok[0].marks)
            solve_s = t.get("solved", 0.0) - t.get("prepared", 0.0)
            if solve_s <= 0:
                return
            iters = sum(max(int(r.result.iterations), 1) for r in ok)
            from ..telemetry import costmodel
            cost = costmodel.spmv_cost(session.solver.Ad)
            bpa = float(cost.get("bytes_per_apply") or 0)
            gbs = costmodel.achieved_gbs(bpa * iters, solve_s)
            # the roofline is the card's measured copy rate (its first
            # measurement launches copies: under the card's lock); a
            # CPU session has none
            dev = session.device
            frac = None
            if dev is not None and dev.type == "cuda":
                from ..device import device_lock
                with device_lock(dev):
                    peak = costmodel.measured_peak_gbs(dev)
                frac = costmodel.roofline_fraction(gbs, peak)
            pattern = session.key.pattern
            with self._lat_lock:
                entry = self._profile.setdefault(pattern, {
                    "captures": 0, "pack": cost.get("pack")})
                entry["captures"] += 1
                entry.update(
                    batch=len(ok), iterations=iters,
                    solve_s=round(solve_s, 6),
                    bytes_per_apply=int(bpa),
                    achieved_gbs=round(gbs, 3),
                    roofline_fraction=None if frac is None
                    else round(frac, 4))
            telemetry.counter_inc("amgx_serve_profile_total")
            telemetry.gauge_set("amgx_serve_achieved_gbs", gbs,
                                pattern=pattern[:12])
            telemetry.event("serve_profile", pattern=pattern[:12],
                            batch=len(ok), iterations=iters,
                            solve_s=solve_s, achieved_gbs=gbs,
                            roofline_fraction=frac,
                            pack=cost.get("pack"))
        except Exception:   # noqa: BLE001 — profiling must never fail
            pass            # a served batch (cost-model gaps included)

    # ---------------------------------------------------------------- stats
    def latency_percentiles(self) -> dict:
        """p50/p95/p99 of request latency (seconds) over the SLO
        window's waited outcomes — unlike the pre-SLO accounting this
        INCLUDES failed and deadline-expired requests (their wait was
        real); admission rejections count against attainment instead
        of dragging the percentiles toward zero."""
        return self.slo.percentiles()

    def reset_latency_stats(self):
        """Drop the SLO windows (service + lanes) + phase split
        (benchmark warm-up: separate the compile-heavy first requests
        from steady-state numbers)."""
        self.slo.reset()
        for lane in self.lanes:
            lane.slo.reset()
        with self._lat_lock:
            self._phase_totals.clear()

    def phase_split(self) -> dict:
        """Mean seconds per lifecycle phase since the last reset — the
        queue-wait vs solve split: a p99 dominated by ``queue_wait``
        needs workers or shedding; one dominated by ``solve`` needs a
        faster solver."""
        with self._lat_lock:
            return {phase: {"count": int(n),
                            "mean_s": round(tot / n, 6) if n else None}
                    for phase, (n, tot)
                    in sorted(self._phase_totals.items())}

    def _totals(self):
        depth = inflight = 0
        for lane in self.lanes:
            with lane._cond:
                depth += len(lane._queue)
                inflight += lane._inflight
        return depth, inflight

    def health(self) -> dict:
        """The liveness surface ``/healthz`` serves, lane-aware: the
        aggregate queue/in-flight/SLO state plus EVERY lane's own
        health leg.  ``overloaded`` — the 503 trip wire — is true only
        when **all** lanes are saturated: with a healthy lane left, the
        router still has somewhere to steal/replicate to, so evicting
        the whole instance would throw away working capacity.  The
        per-lane entries name the saturated subset so a load balancer
        (or an operator via :meth:`drain_lane`) can drain one card.
        Calling this also refreshes the ``amgx_slo_*`` and per-lane
        gauges (the /metrics scrape path)."""
        lane_health = [lane.health() for lane in self.lanes]
        depth = sum(h["queue_depth"] for h in lane_health)
        inflight = sum(h["inflight"] for h in lane_health)
        # emit_event=False: health/scrape polls refresh the gauges but
        # must not append slo_window events to the bounded ring at the
        # poller's rate (stats() keeps emitting them)
        snap = self.slo.snapshot(queue_depth=depth + inflight,
                                 queue_capacity=self.queue_depth
                                 * len(self.lanes),
                                 emit_event=False,
                                 include_percentiles=False)
        saturated = [h["lane"] for h in lane_health if h["overloaded"]]
        with self._lat_lock:
            quarantined = list(self._quarantined)
        return {
            "ok": True,
            "accepting": self._accepting,
            # the poison-pill contract: patterns rejected at admission
            # (serve_quarantine_threshold consecutive error outcomes);
            # an LB/operator lifts one via SolveService.unquarantine
            "quarantined_patterns": [p[:12] for p in quarantined],
            "quarantined_total": len(quarantined),
            "queue_depth": depth,
            "queue_capacity": self.queue_depth * len(self.lanes),
            "inflight": inflight,
            "workers": sum(lane._tm._max_workers or 0
                           for lane in self.lanes),
            # every lane saturated = nowhere left to route = evict me
            "overloaded": bool(saturated)
            and len(saturated) == len(self.lanes),
            "lanes_total": len(self.lanes),
            "lanes_overloaded": len(saturated),
            "saturated_lanes": saturated,
            "lanes": lane_health,
            "slo_attainment": snap["attainment"],
            "slo_burn_rate": snap["burn_rate"],
        }

    def _cache_stats(self) -> dict:
        """Aggregate setup-cache picture: the single-lane shape with
        per-lane sums; ``by_session`` entries gain
        a ``lane`` field in multi-lane services."""
        if len(self.lanes) == 1:
            return self.lanes[0].cache.stats()
        per = [lane.cache.stats() for lane in self.lanes]
        by_session = []
        for lane, st in zip(self.lanes, per):
            for s in st["by_session"]:
                by_session.append(dict(s, lane=lane.index))
        return {
            "sessions": sum(st["sessions"] for st in per),
            "hits": sum(st["hits"] for st in per),
            "misses": sum(st["misses"] for st in per),
            "evictions": sum(st["evictions"] for st in per),
            "resident_bytes": sum(st["resident_bytes"] for st in per),
            "max_bytes": sum(st["max_bytes"] for st in per),
            "by_session": by_session,
        }

    def stats(self) -> dict:
        depth, inflight = self._totals()
        with self._lat_lock:
            submitted, completed, rejected = \
                self.submitted, self.completed, self.rejected
        # device setup engine (amg/device_setup/): sessions sharing a
        # sparsity pattern also share its Galerkin plans — surface the
        # plan-cache hit rate next to the session cache it multiplies
        from ..amg.device_setup import engine_stats
        from . import aot
        with self._lat_lock:
            profile = {k: dict(v) for k, v in self._profile.items()}
        # ONE snapshot serves both keys: the percentiles it already
        # computed ("latency_s") and the SLO picture — attainment, burn
        # rate, outcome counts, overload state over the sliding window
        # (slo_* knobs).  Taking it here also publishes the amgx_slo_*
        # gauges + slo_window event when telemetry is on; the capacity
        # leg counts outstanding = queued + in-flight
        snap = self.slo.snapshot(queue_depth=depth + inflight,
                                 queue_capacity=self.queue_depth
                                 * len(self.lanes))
        return {
            "submitted": submitted,
            "completed": completed,
            "rejected": rejected,
            "queue_depth": depth,
            "queue_capacity": self.queue_depth * len(self.lanes),
            "workers": sum(lane._tm._max_workers or 0
                           for lane in self.lanes),
            "worker_task_failures": sum(lane._tm.failed_tasks
                                        for lane in self.lanes),
            "latency_s": snap["latency_s"],
            "slo": snap,
            # queue-wait vs solve split of the request lifecycle
            "phase_split": self.phase_split(),
            # sampled solve-path profiling (serve_profile_every):
            # per-pattern fenced device seconds vs the cost model
            "profile": profile or None,
            "endpoint": self.endpoint,
            # serve hardening: quarantined patterns (full fingerprints
            # here — health() truncates for the wire) + retry traffic
            "quarantine": {
                "threshold": self.quarantine_threshold,
                "patterns": self.quarantined_patterns(),
            },
            "cache": self._cache_stats(),
            # multi-device scale-out: per-lane queue/SLO/cache state +
            # the router's affinity/replication/steal picture
            "lanes": [lane.stats() for lane in self.lanes],
            "router": self.router.stats(),
            "last_drain": self.last_drain,
            "device_setup": engine_stats(),
            # warm-start layer: the plan store's traffic (None when
            # unconfigured) — the cold-start twin of the session cache
            "aot": aot.store_stats(),
        }
