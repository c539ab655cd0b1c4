"""Open-loop load generator: the serving layer's SLO harness (port of
``amgx_tpu/serve/loadgen.py``).

Closed-loop benchmarks (fire N, wait N) hide overload: a slow server
slows the generator down with it, so the measured latency flatters.
This generator is **open-loop** — arrivals follow a Poisson process at
the offered rate regardless of completions (the standard SLO
methodology), so queueing delay, deadline sheds and admission
rejections show up exactly as a production client would see them.

Traffic shape: each arrival picks one of the given operator patterns —
uniformly by default, or Zipf-skewed by rank with ``skew`` > 0
(weight ∝ 1/(rank+1)^skew, first pattern hottest), the hot-key
distribution real fleets see and the shape that actually exercises the
multi-lane router's affinity/replication policy (uniform traffic never
saturates one lane while another idles) — and, with
``multi_rhs_frac`` probability, carries a burst of 2..``max_rhs``
same-operator right-hand sides submitted back-to-back — the shape the
micro-batcher (:func:`~amgx_tpu_torch.serve.batch.split_batches`) exists to
exploit.  The output JSON reports the per-pattern hit distribution
(offered requests per pattern) so a skewed run is verifiable, plus the
per-lane/router picture when the service runs more than one lane.

Reported numbers: offered/accepted/rejected/completed counts, the
rejection rate, p50/p95/p99 of request latency (submit → result,
measured by the service's SLO window — shed and failed requests
included), SLO attainment + error-budget burn rate against the
``slo_*`` objectives, achieved throughput, and the generator's own
schedule slip (a slipping generator means the
HARNESS saturated, not the server — the numbers are then a lower bound
on the offered load).  ``chip_smoke.py`` runs it on the card against a
warmed service.
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np

from ..errors import RC
from .service import SolveService


def run_load(service: SolveService, patterns: Sequence, *,
             rps: float = 20.0, duration_s: float = 2.0,
             multi_rhs_frac: float = 0.25, max_rhs: int = 4,
             skew: float = 0.0,
             seed: int = 0, wait_timeout_s: float = 300.0) -> dict:
    """Drive ``service`` with open-loop Poisson arrivals over
    ``patterns`` (prepared :class:`~amgx_tpu_torch.core.matrix.Matrix`
    handles) and return the SLO summary dict.

    The caller should warm the service first (``service.warmup``) when
    steady-state numbers are wanted — a cold run measures setups, kernel
    builds and graph captures, which is a different story."""
    rng = np.random.default_rng(seed)
    patterns = list(patterns)
    if not patterns:
        raise ValueError("run_load needs at least one pattern")
    sizes = [int(m.shape[0]) for m in patterns]
    # pre-generate the arrival schedule and payloads: the generator
    # loop must be all sleep+submit, or IT becomes the bottleneck
    arrivals: List[float] = []
    t = 0.0
    while t < duration_s:
        t += float(rng.exponential(1.0 / max(rps, 1e-9)))
        if t < duration_s:
            arrivals.append(t)
    # pattern popularity: uniform at skew=0, Zipf-by-rank otherwise
    # (weight of the i-th given pattern ∝ 1/(i+1)^skew) — hot-key
    # traffic is what drives one lane to saturation while another
    # idles, i.e. what the router's replication threshold is FOR
    w = np.power(np.arange(1, len(patterns) + 1, dtype=float),
                 -max(float(skew), 0.0))
    w /= w.sum()
    plan = []
    hits = np.zeros(len(patterns), dtype=int)
    for _ in arrivals:
        pi = int(rng.choice(len(patterns), p=w))
        hits[pi] += 1
        k = int(rng.integers(2, max_rhs + 1)) \
            if max_rhs >= 2 and rng.random() < multi_rhs_frac else 1
        plan.append((pi, rng.standard_normal((k, sizes[pi]))))

    service.reset_latency_stats()
    pend = []
    max_slip = 0.0
    t0 = time.monotonic()
    for t_arr, (pi, B) in zip(arrivals, plan):
        now = time.monotonic() - t0
        if now < t_arr:
            time.sleep(t_arr - now)
        else:
            max_slip = max(max_slip, now - t_arr)
        m = patterns[pi]
        for row in B:           # a burst: same operator, k RHS
            pend.append(service.submit(m, row))
    gen_wall = time.monotonic() - t0

    rejected = completed = failed = 0
    for p in pend:
        if p.rc == RC.REJECTED:
            rejected += 1
            continue
        res = p.wait(wait_timeout_s)
        if p.rc == RC.REJECTED:     # deadline shed after admission
            rejected += 1
        elif p.rc == RC.OK and res is not None:
            completed += 1
        else:
            failed += 1
    wall = time.monotonic() - t0
    offered = len(pend)
    # the SLO picture of exactly this run: reset_latency_stats() above
    # cleared the window, so attainment/burn rate cover the offered
    # wave only (the snapshot also publishes the amgx_slo_* gauges and
    # the slo_window trace event when telemetry is enabled); the
    # percentiles come from the SAME single window pass so they match
    # the by_outcome counts reported next to them
    slo = service.slo.snapshot()
    lat = slo["latency_s"]

    def ms(v):
        return round(v * 1e3, 2) if isinstance(v, (int, float)) else None

    total_hits = max(int(hits.sum()), 1)
    # the per-lane/router picture of a multi-lane service: aggregate
    # throughput in lane count, the steal/replication traffic, and
    # each lane's completed/stolen split — the scale-out proof numbers
    lanes_block = None
    if len(service.lanes) > 1:
        lane_stats = [lane.stats() for lane in service.lanes]
        rt = service.router.stats()
        routed = sum(rt["decisions"].values()) or 1
        lanes_block = {
            "lanes": len(service.lanes),
            "per_lane": [{k: s[k] for k in
                          ("lane", "completed", "rejected",
                           "stolen_in", "sessions", "overloaded")}
                         for s in lane_stats],
            "steals": rt["steals"],
            "replications": rt["replications"],
            "steal_frac_of_routed": round(rt["steals"] / routed, 4),
            "replicated_patterns": rt["replicated_patterns"],
            "sessions_by_lane": rt["sessions_by_lane"],
        }

    return {
        "offered": offered,
        "offered_rps": round(offered / duration_s, 1),
        "duration_s": round(duration_s, 3),
        "patterns": len(patterns),
        "multi_rhs_frac": multi_rhs_frac,
        "skew": float(skew),
        #: arrivals per given pattern (a multi-RHS burst counts once)
        #: — the verifiable popularity distribution
        "pattern_hits": [
            {"pattern": m.pattern_fingerprint()[:12],
             "requests": int(h),
             "frac": round(int(h) / total_hits, 4)}
            for m, h in zip(patterns, hits)],
        "lanes": lanes_block,
        "completed": completed,
        "rejected": rejected,
        "failed": failed,
        "rejection_rate": round(rejected / offered, 4) if offered else 0.0,
        "achieved_rps": round(completed / wall, 1) if wall else None,
        "p50_ms": ms(lat["p50"]),
        "p95_ms": ms(lat["p95"]),
        "p99_ms": ms(lat["p99"]),
        #: SLO attainment + error-budget burn rate over this run's
        #: window (telemetry/slo.py; objectives from the slo_* knobs)
        "attainment": (round(slo["attainment"], 4)
                       if slo["attainment"] is not None else None),
        "burn_rate": (round(slo["burn_rate"], 3)
                      if slo["burn_rate"] is not None else None),
        "slo": {"objective": slo["objective"],
                "window_s": slo["window_s"],
                "by_outcome": slo["by_outcome"],
                "overloaded": slo["overloaded"]},
        "gen_wall_s": round(gen_wall, 3),
        "wall_s": round(wall, 3),
        #: worst lag of the generator behind its schedule — nonzero
        #: means the harness couldn't offer the full rate
        "max_slip_s": round(max_slip, 4),
    }
