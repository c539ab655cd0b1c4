"""The serving layer's framework-free pieces, case by case against the
JAX package: the same inputs through both packages' batch splitting,
session keys, routing, SLO math, retry schedule, worker-pool accounting,
mesh flight recorder and overlap measurement, and the serving keys
(pattern and values fingerprints) of every host form and dtype."""
import json
import random
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu
import amgx_tpu_torch
from amgx_tpu import serve as jserve
from amgx_tpu.telemetry import meshtrace as jmesh
from amgx_tpu.telemetry import overlap as joverlap
from amgx_tpu.telemetry import slo as jslo
from amgx_tpu.utils import retry as jretry
from amgx_tpu.utils.thread_manager import ThreadManager as JThreadManager
from amgx_tpu_torch import serve as tserve
from amgx_tpu_torch.serve import router as trouter
from amgx_tpu_torch.telemetry import meshtrace as tmesh
from amgx_tpu_torch.telemetry import overlap as toverlap
from amgx_tpu_torch.telemetry import slo as tslo
from amgx_tpu_torch.utils import retry as tretry
from amgx_tpu_torch.utils.thread_manager import \
    ThreadManager as TThreadManager

CFG = ("config_version=2, solver(out)=PCG, out:max_iters=50, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=SIZE_2")


# ------------------------------------------------------------ fingerprints
def _bf16(pkg):
    if pkg == "jax":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return torch.bfloat16


def _host_forms():
    A = amgx_tpu.io.poisson7pt(5, 4, 3)
    B = sp.bsr_matrix(sp.random(12, 12, density=0.3, random_state=1)
                      + sp.eye(12), blocksize=(3, 3))
    offs, vals = amgx_tpu.io.poisson7pt_dia(4, 4, 3)
    return {
        "csr": (lambda pkg, M: M.Matrix(A) if pkg == "jax"
                else M.Matrix(A, device="cpu")),
        "block": (lambda pkg, M: M.Matrix(B, block_dim=3) if pkg == "jax"
                  else M.Matrix(B, block_dim=3, device="cpu")),
        "dia": (lambda pkg, M: M.Matrix.from_dia(offs, vals)
                if pkg == "jax" else
                M.Matrix.from_dia(offs, vals, device="cpu")),
    }


@pytest.mark.parametrize("form", ["csr", "block", "dia"])
@pytest.mark.parametrize("dtype", [None, "float32", "float64", "bfloat16"])
def test_fingerprints_equal_jax(form, dtype):
    """Equal hex digests for the same host matrix and pack dtype (the
    router hashes these strings), kept by ``replace_coefficients`` for
    the pattern, reset by ``set``."""
    make = _host_forms()[form]
    mj, mt = make("jax", amgx_tpu), make("torch", amgx_tpu_torch)
    if dtype == "bfloat16":
        mj.device_dtype, mt.device_dtype = _bf16("jax"), _bf16("torch")
    elif dtype is not None:
        mj.device_dtype = mt.device_dtype = np.dtype(dtype)
    assert mt.pattern_fingerprint() == mj.pattern_fingerprint()
    assert mt.values_fingerprint() == mj.values_fingerprint()
    if form == "dia":
        return
    p0, v0 = mt.pattern_fingerprint(), mt.values_fingerprint()
    for m in (mj, mt):
        m.replace_coefficients(np.asarray(m.host.data) * 2.0)
    assert mt.pattern_fingerprint() == p0 == mj.pattern_fingerprint()
    assert mt.values_fingerprint() != v0
    assert mt.values_fingerprint() == mj.values_fingerprint()
    other = amgx_tpu.io.poisson7pt(3, 3, 3)
    mj.set(other)
    mt.set(other)
    assert mt.pattern_fingerprint() != p0
    assert mt.pattern_fingerprint() == mj.pattern_fingerprint()
    assert mt.values_fingerprint() == mj.values_fingerprint()


# ------------------------------------------------- keys, batches, routing
@pytest.mark.parametrize("text", [
    CFG,
    "config_version=2, amg:selector=SIZE_2, amg:algorithm=AGGREGATION, "
    "out:max_iters=50, out:preconditioner(amg)=AMG, solver(out)=PCG",
    CFG + ", serve_workers=4",
])
def test_session_key_and_config_hash_equal_jax(text):
    A = amgx_tpu.io.poisson7pt(4, 4, 4)
    kj = jserve.session_key(amgx_tpu.AMGConfig(text), amgx_tpu.Matrix(A))
    kt = tserve.session_key(amgx_tpu_torch.AMGConfig(text),
                            amgx_tpu_torch.Matrix(A, device="cpu"))
    assert (kt.config, kt.pattern) == (kj.config, kj.pattern)
    assert kt.config == tserve.config_hash(amgx_tpu_torch.AMGConfig(CFG)) \
        or "serve_workers" in text


def _requests(pkg_serve, keys, values):
    return [pkg_serve.SolveRequest(
        matrix=None, b=np.zeros(1), x0=None,
        key=pkg_serve.SessionKey(config="c", pattern=k), values_fp=v,
        submitted_t=0.0, deadline_t=None) for k, v in zip(keys, values)]


@pytest.mark.parametrize("max_batch", [1, 2, 3, 8])
def test_split_batches_equal_jax(max_batch):
    rng = random.Random(7)
    keys = [rng.choice("pqr") for _ in range(20)]
    values = [rng.choice("ab") for _ in range(20)]

    def groups(pkg_serve):
        reqs = _requests(pkg_serve, keys, values)
        ix = {id(r): i for i, r in enumerate(reqs)}
        return [[ix[id(r)] for r in b]
                for b in pkg_serve.split_batches(reqs, max_batch)]

    assert groups(tserve) == groups(jserve)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_stable_idx_equal_jax(n):
    from amgx_tpu.serve.router import _stable_idx as jidx
    for k in range(64):
        token = f"{k:032x}"
        assert trouter._stable_idx(token, n) == jidx(token, n)


class _Lane:
    """What the router reads of a lane: index, admission flag, load."""

    def __init__(self, i):
        self.index = i
        self.accepting = True
        self.load = 0.0
        self.stolen_in = 0

    def queue_fraction(self):
        return self.load if self.accepting else float("inf")


def _route_trace(router_cls, steps):
    lanes = [_Lane(i) for i in range(3)]
    r = router_cls(lanes, replicate_frac=0.75, steal_frac=0.5)
    out = []
    for pattern, values, loads, closed in steps:
        for lane, ld in zip(lanes, loads):
            lane.load = ld
            lane.accepting = lane.index not in closed
        out.append(r.route(pattern, values))
    st = r.stats()
    return out, st, [lane.stolen_in for lane in lanes]


def test_router_decisions_equal_jax():
    """Cold placement, a steal off a busy hash-home, affinity, a
    replication onto an idle lane, overflow with no idle lane, and a
    drained lane, through both routers."""
    from amgx_tpu.serve.router import PatternRouter as JRouter
    pats = [f"{k:032x}" for k in range(6)]
    steps = [
        (pats[0], "a", (0.0, 0.0, 0.0), ()),
        (pats[1], "a", (0.0, 0.0, 0.0), ()),
        (pats[2], "a", (0.9, 0.9, 0.0), ()),
        (pats[0], "a", (0.1, 0.1, 0.1), ()),
        (pats[0], "b", (0.9, 0.9, 0.1), ()),
        (pats[0], "c", (0.9, 0.9, 0.9), ()),
        (pats[3], "a", (0.6, 0.6, 0.6), ()),
        (pats[4], "a", (0.0, 0.0, 0.0), (0,)),
        (pats[1], "a", (0.0, 0.0, 0.0), (1,)),
        (pats[5], "a", (0.2, 0.1, 0.3), ()),
    ]
    assert _route_trace(trouter.PatternRouter, steps) == \
        _route_trace(JRouter, steps)


# ------------------------------------------------------------------- SLO
@pytest.mark.parametrize("latency_ms,target", [(0.0, 0.99), (50.0, 0.9),
                                               (20.0, 1.0)])
def test_slo_window_math_equal_jax(latency_ms, target):
    rng = np.random.default_rng(3)
    outcomes = tslo.OUTCOMES
    assert tuple(outcomes) == tuple(jslo.OUTCOMES)
    wj = jslo.SLOWindow(window_s=10.0, latency_ms=latency_ms, target=target)
    wt = tslo.SLOWindow(window_s=10.0, latency_ms=latency_ms, target=target)
    for k in range(80):
        lat = float(rng.exponential(0.03))
        out = outcomes[int(rng.integers(len(outcomes)))]
        met = bool(rng.random() < 0.9)
        t = 100.0 + 0.2 * k
        wj.record(lat, out, deadline_met=met, now=t)
        wt.record(lat, out, deadline_met=met, now=t)
    for now in (112.0, 115.0, 200.0):
        sj = wj.snapshot(queue_depth=3, queue_capacity=8, now=now,
                         emit_event=False)
        st = wt.snapshot(queue_depth=3, queue_capacity=8, now=now,
                         emit_event=False)
        assert st == sj
        assert wt.percentiles(now=now) == wj.percentiles(now=now)


# ----------------------------------------------------------------- retry
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retry_schedule_equal_jax(seed):
    def schedule(mod):
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise OSError("transient")
            return len(calls)

        got = mod.retry_call(flaky, max_attempts=5, base_delay_s=0.1,
                             sleep=sleeps.append,
                             rng=random.Random(seed))
        pol = mod.RetryPolicy(base_delay_s=0.2, max_delay_s=1.0)
        ladder = [pol.delay_s(k, random.Random(seed)) for k in range(1, 8)]
        with pytest.raises(ValueError):
            mod.retry_call(lambda: (_ for _ in ()).throw(ValueError()),
                           sleep=sleeps.append)
        return got, sleeps, ladder

    assert schedule(tretry) == schedule(jretry)


# ---------------------------------------------------------- worker pool
@pytest.mark.parametrize("serialize", [False, True])
def test_thread_manager_accounting_equal_jax(serialize):
    def run(cls):
        tm = cls(max_workers=2, serialize=serialize)
        tm.spawn_threads()
        done = []
        lock = threading.Lock()

        def ok(k):
            def f():
                with lock:
                    done.append(k)
            return f

        def bad():
            raise RuntimeError("task failed")

        raised = []
        for k in range(6):
            try:
                tm.push_work(bad if k % 3 == 1 else ok(k))
            except RuntimeError as e:
                raised.append(str(e))
        try:
            tm.wait_threads()
        except RuntimeError as e:
            raised.append(str(e))
        tm.push_work(ok(99))
        tm.join_threads()
        return sorted(done), tm.failed_tasks, raised

    assert run(TThreadManager) == run(JThreadManager)


# ------------------------------------------------- mesh recorder, overlap
def _mesh_sessions(n_ranks=3, late_rank=2, late_s=0.05, hops=5):
    """JSONL lines of ``n_ranks`` sessions: one ``solve`` span, ``hops``
    ring-1 halo exchanges (the late rank begins each ``late_s`` late),
    one fused Krylov reduction; each rank on its own clock offset."""
    out = []
    for r in range(n_ranks):
        off = 10.0 * r
        late = late_s if r == late_rank else 0.0

        def t(w):
            return w - off

        meta = {"kind": "meta", "name": "amgx-telemetry", "schema": 1,
                "pid": 100 + r, "session": f"s{r}", "host": "h0",
                "t_perf": t(0.0), "t_unix": 0.0, "dropped": 0}
        recs = [{"kind": "span_begin", "name": "solve", "t": t(0.0),
                 "tid": 1, "sid": 1, "parent": None, "attrs": {}}]
        for k in range(hops):
            t0 = 0.2 + 0.25 * k + late
            recs.append({"kind": "span_begin", "name": "exchange_halo",
                         "t": t(t0), "tid": 1, "sid": 10 + k, "parent": 1,
                         "attrs": {"ring": 1}})
            recs.append({"kind": "span_end", "name": "exchange_halo",
                         "t": t(t0 + 0.1 - late), "tid": 1, "sid": 10 + k,
                         "dur": 0.1 - late})
        recs.append({"kind": "event", "name": "krylov_comm", "t": t(1.9),
                     "tid": 1, "attrs": {"solver": "out", "mode": "CA",
                                         "iterations": 10,
                                         "per_iter": {"all_reduce": 1},
                                         "collectives_per_iter": 1,
                                         "fused": True, "n_parts": 3}})
        recs.append({"kind": "span_end", "name": "solve", "t": t(2.0),
                     "tid": 1, "sid": 1, "dur": 2.0})
        for seq, x in enumerate(recs, 1):
            x["seq"] = seq
        out.append([json.dumps(meta)] + [json.dumps(x) for x in recs])
    return out


@pytest.mark.parametrize("n_ranks,late_rank", [(1, 0), (3, 2), (4, 0)])
def test_meshtrace_analyze_equal_jax(tmp_path, n_ranks, late_rank):
    meta_schema = amgx_tpu.telemetry.SCHEMA_VERSION
    paths = []
    for r, lines in enumerate(_mesh_sessions(n_ranks, late_rank)):
        m = json.loads(lines[0])
        m["schema"] = meta_schema
        p = tmp_path / f"rank{r}.jsonl"
        p.write_text("\n".join([json.dumps(m)] + lines[1:]) + "\n")
        paths.append(str(p))
    got = tmesh.analyze(paths)
    want = jmesh.analyze(paths)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    assert got["measured"] == (n_ranks >= 2)


@pytest.mark.parametrize("names", [
    ("ampere_sgemm", "dia_spmv_f32"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "dia_spmv_f32"),
    ("ncclDevKernel_SendRecv", "dia_spmv_f32"),
    ("all-reduce.1", "fusion.3"),
])
def test_overlap_measure_on_synthetic_traces(names):
    """Identical on the collective names both packages know; NCCL's
    send-receive kernel (the card's point-to-point communication) counts
    as communication in the port too."""
    comm, comp = names
    events = [{"ph": "X", "name": comm, "pid": 1, "tid": 7, "ts": 100.0,
               "dur": 50.0},
              {"ph": "X", "name": comp, "pid": 1, "tid": 8, "ts": 120.0,
               "dur": 60.0},
              {"ph": "X", "name": comp, "pid": 2, "tid": 8, "ts": 0.0,
               "dur": 10.0}]
    got = toverlap.measure({"traceEvents": events})
    want = joverlap.measure({"traceEvents": events})
    if comm == "ncclDevKernel_SendRecv":
        assert want is None and got is not None
        assert got["overlap_fraction"] == pytest.approx(0.6)
    else:
        assert got == want
    base = {"n_parts": 2, "overlap_fraction": 0.1, "measured": False}
    if want is not None:
        assert toverlap.measured_event(base, got) == \
            joverlap.measured_event(base, want)
