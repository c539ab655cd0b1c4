"""The port's telemetry modules against the JAX package's, case by case.

The modules the port copied (recorder, metrics, export, tracefile, the
cost model's pack-free helpers, forensics analysis, the doctor) take the
same inputs through both packages and must give the same outputs; the
port's own seams — the scope contract over its dispatch labels, the
kernel → range join through a CUDA graph's capture-time map (on a
synthetic ``torch.profiler`` trace), the memory ledger on the CPU, the
knobs — are held to their contracts.  Everything here is host work at
small size.
"""
import json
import os

import numpy as np
import pytest

import amgx_tpu_torch as amgx
from amgx_tpu_torch import telemetry as pt
from amgx_tpu_torch.io import poisson7pt_device
from amgx_tpu_torch.telemetry import (costmodel, deviceprof, doctor,
                                      forensics, memledger, proftrace,
                                      scopes, tracefile)

jt = pytest.importorskip("amgx_tpu.telemetry")
from amgx_tpu.telemetry import doctor as jdoctor  # noqa: E402

HEADLINE = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER")

#: record fields that carry a clock, a thread or an id (differ per run)
_VOLATILE = ("t", "tid", "seq", "sid", "parent", "dur")


@pytest.fixture(autouse=True)
def _clean():
    for mod in (pt, jt):
        mod.disable()
        mod.setup_profile.disable()
        mod.reset()
    yield
    for mod in (pt, jt):
        mod.disable()
        mod.setup_profile.disable()
        mod.reset()


def _stable(records):
    return [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in records]


# ------------------------------------------------ the copied modules
def _scenario_spans(t):
    with t.span("setup", solver="FGMRES"):
        with t.span("amg_setup"):
            t.event("hierarchy", levels=3, grid_complexity=1.14)
        t.counter_inc("amgx_spmv_dispatch_total", pack="dia/kernel")
        t.counter_inc("amgx_spmv_dispatch_total", 3.0, pack="dia/kernel")
    t.gauge_set("amgx_solve_iterations", 11)
    t.hist_observe("amgx_solve_seconds", 0.25)
    t.event("residual", iteration=0, norm=float("inf"))
    t.event("arrays", v=np.arange(3), f=np.float32(1.5), i=np.int64(7))


def _scenario_metrics(t):
    for i in range(4):
        t.counter_inc("amgx_solves_total", status="SUCCESS")
        t.gauge_set("amgx_level_rows", 512 >> i, level=i)
        t.hist_observe("amgx_setup_seconds", 0.01 * (i + 1))
    t.registry().gauge_clear("amgx_level_rows")
    t.gauge_set("amgx_level_rows", 64, level=0)


def _scenario_overflow(t):
    for i in range(40):
        t.event("residual", iteration=i, norm=1.0 / (i + 1))


@pytest.mark.parametrize("scenario", [_scenario_spans, _scenario_metrics,
                                      _scenario_overflow],
                         ids=["spans", "metrics", "overflow"])
def test_recorder_and_metrics_match_jax(scenario):
    """The same instrument calls give the same ring records, capture
    summaries, registry snapshots and Prometheus series."""
    got = {}
    for name, t in (("port", pt), ("jax", jt)):
        ring = 16 if scenario is _scenario_overflow else None
        with t.capture(ring_size=ring) as cap:
            scenario(t)
        got[name] = (_stable(cap.records), cap.summary()["counters"],
                     cap.summary()["gauges"], cap.truncated, cap.dropped,
                     t.registry().snapshot(),
                     [ln for ln in t.prometheus_text().splitlines()
                      if not ln.startswith("# HELP")])
    assert got["port"] == got["jax"]
    assert sorted(pt.METRICS) == sorted(jt.METRICS)
    assert pt.SCHEMA_VERSION == jt.SCHEMA_VERSION
    assert scopes.SCOPE_VERSION == jt.scopes.SCOPE_VERSION
    assert memledger.LEDGER_VERSION == jt.memledger.LEDGER_VERSION


_RECORDS = [
    {"kind": "span_begin", "name": "solve", "sid": 1, "parent": None,
     "t": 1.0, "tid": 1, "seq": 1, "attrs": {}},
    {"kind": "span_end", "name": "solve", "sid": 1, "parent": None,
     "t": 2.0, "tid": 1, "seq": 2, "dur": 1.0},
    {"kind": "event", "name": "residual", "sid": None, "t": 1.5,
     "tid": 1, "seq": 3, "attrs": {"iteration": 0, "norm": 1.0}},
    {"kind": "counter", "name": "amgx_solves_total", "t": 2.0, "tid": 1,
     "seq": 4, "labels": {"status": "SUCCESS"}, "value": 1.0},
    {"kind": "event", "name": "krylov_comm", "sid": None, "t": 2.0,
     "tid": 1, "seq": 5, "attrs": {"solver": "FGMRES", "mode": "CLASSIC",
                                   "iterations": 3,
                                   "per_iter": {"gram": 2, "norm": 1},
                                   "collectives_per_iter": 3,
                                   "fused": False, "n_parts": 1}},
    {"kind": "event", "name": "krylov_comm", "sid": None, "t": 2.0,
     "tid": 1, "seq": 6, "attrs": {"solver": "FGMRES", "mode": "BAD",
                                   "iterations": 3, "per_iter": {},
                                   "collectives_per_iter": 0,
                                   "fused": False, "n_parts": 1}},
    {"kind": "gauge", "name": "amgx_x", "t": 2.0, "tid": 1, "seq": 7,
     "labels": {}, "value": "oops"},
    {"kind": "nope", "name": "x"},
]


@pytest.mark.parametrize("i", range(len(_RECORDS)))
def test_validate_record_matches_jax(i):
    """One schema authority: each record passes or fails both
    validators alike."""
    verdict = []
    for t in (pt, jt):
        try:
            t.validate_record(dict(_RECORDS[i]))
            verdict.append("ok")
        except ValueError:
            verdict.append("bad")
    assert verdict[0] == verdict[1]


def test_exporters_match_jax(tmp_path):
    """The same ring dumped by both packages reads back the same:
    aggregated sessions, Chrome traces (event names and phases), and
    each package's validator takes the other's file."""
    paths = {}
    for name, t in (("port", pt), ("jax", jt)):
        with t.capture():
            _scenario_spans(t)
            paths[name] = str(tmp_path / f"{name}.jsonl")
            t.dump_jsonl(paths[name])
    for t in (pt, jt):
        for path in paths.values():
            with open(path) as f:
                assert t.validate_jsonl(f) > 0
    aggs = {}
    for name, t in (("port", pt), ("jax", jt)):
        a = t.aggregate_sessions([paths[name]])
        aggs[name] = (a["n_sessions"],
                      {k: v["count"] for k, v in a["spans"].items()},
                      a["counters"], a["gauges"])
    assert aggs["port"] == aggs["jax"]
    shapes = {}
    for name, t in (("port", pt), ("jax", jt)):
        tr = t.chrome_trace(paths[name])
        assert t.validate_chrome_trace(tr) > 0
        shapes[name] = sorted((e.get("ph"), e.get("name"))
                              for e in tr["traceEvents"]
                              if e.get("ph") != "M")
    assert shapes["port"] == shapes["jax"]


def test_costmodel_helpers_match_jax():
    """The cost model's pack-free arithmetic; the port states every rate
    explicitly (no TPU constant)."""
    levels = [{"bytes_per_apply": 1000, "flops_per_apply": 200,
               "nnz": 100, "padded_entries": 120},
              {"bytes_per_apply": 300, "flops_per_apply": 40, "nnz": 20,
               "padded_entries": 20, "halo_bytes_per_apply": 8}]
    assert costmodel.hierarchy_cost(levels) == \
        jt.costmodel.hierarchy_cost(levels)
    assert costmodel.achieved_gbs(3e9, 0.5) == \
        jt.costmodel.achieved_gbs(3e9, 0.5)
    assert costmodel.roofline_fraction(2000.0, 3350.0) == \
        jt.costmodel.roofline_fraction(2000.0, 3350.0)
    assert not hasattr(costmodel, "HBM_PEAK_GBS")
    assert not hasattr(costmodel, "ICI_PEAK_GBS")
    t, by = costmodel.bound(3.35e9, 1.0, 3.35e12, 67e12)
    assert t == pytest.approx(1e-3) and by == "bytes"


def _cycle_records(seed):
    rng = np.random.default_rng(seed)
    out = []
    for cyc in range(6):
        for lvl in range(3):
            e = float(rng.uniform(0.5, 2.0))
            out.append({"kind": "event", "name": "cycle_level",
                        "attrs": {"level": lvl, "flavor": "CG", "entry": e,
                                  "pre": e * 0.4, "coarse": e * 0.3,
                                  "post": e * float(rng.uniform(0.05, .2))
                                  }})
        out.append({"kind": "event", "name": "cycle_coarse",
                    "attrs": {"level": 3, "entry": 1.0, "exit": 1e-12}})
    out.append({"kind": "event", "name": "forensics_probe",
                "attrs": {"level": 0, "nullspace": 0.5, "rows": 512}})
    out.append({"kind": "event", "name": "solve_forensics",
                "attrs": {"asymptotic_rate": 0.2}})
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_forensics_analysis_matches_jax(seed):
    recs = _cycle_records(seed)
    assert forensics.cycle_anatomy(recs) == \
        jt.forensics.cycle_anatomy(recs)
    assert forensics.analyze(recs) == jt.forensics.analyze(recs)
    hist = list(np.geomspace(1.0, 1e-8, 12 + seed))
    assert forensics.asymptotic_rate(hist) == \
        jt.forensics.asymptotic_rate(hist)


def test_doctor_renders_like_jax(tmp_path):
    """The doctor's diagnosis and rendering of one trace match the JAX
    package's (a trace with forensics, residuals and a setup profile)."""
    path = str(tmp_path / "t.jsonl")
    with pt.capture():
        _scenario_spans(pt)
        for r in _cycle_records(3):
            pt.event(r["name"], **r["attrs"])
        for i, nrm in enumerate(np.geomspace(1.0, 1e-9, 10)):
            pt.event("residual", iteration=i, norm=float(nrm))
        pt.dump_jsonl(path)
    assert doctor.render(doctor.diagnose([path])) == \
        jdoctor.render(jdoctor.diagnose([path]))
    assert doctor.main([path]) == 0


# ------------------------------------------------ the port's own seams
@pytest.mark.parametrize("label", sorted(scopes.SPMV_PACKS))
def test_every_dispatch_label_is_a_valid_scope(label):
    from amgx_tpu_torch.ops import spmv
    name = scopes.scope_name("spmv", label)
    assert scopes.validate(name)
    assert scopes.canonicalize(name + "/trailing") == name
    assert label in spmv.DISPATCH or label == "dia3"


def test_dispatch_labels_are_all_scoped():
    from amgx_tpu_torch.ops import spmv
    assert set(spmv.DISPATCH) <= set(scopes.SPMV_PACKS)


def _synthetic_trace(n_kernels=3, kinds=("kernel", "gpu_memcpy", "kernel")):
    """A torch.profiler-shaped trace: an eager launch inside
    amgx/krylov/arnoldi ⊃ amgx/spmv/dia/kernel, and a graph launch inside
    amgx/krylov/precond ⊃ amgx_graph:7.0 whose activities start out of
    their listing order."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "amgx/krylov/arnoldi",
         "pid": 1, "tid": 9, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "amgx/spmv/dia/kernel",
         "pid": 1, "tid": 9, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "pid": 1, "tid": 9, "ts": 12.0, "dur": 2.0,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel",
         "name": "void (anonymous namespace)::dia_spmv_f32<4>(float)",
         "pid": 0, "tid": 7, "ts": 200.0, "dur": 30.0,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "user_annotation", "name": "amgx/krylov/precond",
         "pid": 1, "tid": 9, "ts": 110.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "amgx_graph:7.0",
         "pid": 1, "tid": 9, "ts": 111.0, "dur": 40.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 1, "tid": 9, "ts": 112.0, "dur": 5.0,
         "args": {"correlation": 6}},
        # an unscoped eager kernel
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 9, "ts": 170.0, "dur": 1.0,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "void other(int)", "pid": 0,
         "tid": 7, "ts": 600.0, "dur": 10.0, "args": {"correlation": 8}},
    ]
    t0 = 300.0
    for k in reversed(range(n_kernels)):
        ev.append({"ph": "X", "cat": kinds[k], "name": f"void k{k}(int)",
                   "pid": 0, "tid": 7, "ts": t0 + 50.0 * k, "dur": 40.0,
                   "args": {"correlation": 6}})
    return {"traceEvents": ev}


_MAP = [(0, "_Z2k0i", "amgx/cycle/level0/pre_smooth"),
        (1, None, "amgx/cycle/level0/restrict"),
        (0, "_Z2k2i", "amgx/cycle/coarse_solve")]


def test_graph_kernels_take_their_capture_scopes():
    """The ordinal join: a graph launch's activities, in start order,
    take the scope chains its capture recorded, behind the launch's own
    ranges; the identity attributed + unattributed ≡ total holds."""
    a = deviceprof.measure_anatomy(_synthetic_trace(),
                                   maps={(7, 0): _MAP}, peak_gbs=1000.0)
    assert a["graphs"]["graph_launches"] == 1
    assert a["graphs"]["graph_launches_mapped"] == 1
    assert a["graphs"]["names_checked"] == 2
    sc = a["scopes"]
    assert sc["amgx/cycle/level0/pre_smooth"] == pytest.approx(40e-6)
    assert sc["amgx/cycle/level0/restrict"] == pytest.approx(40e-6)
    assert sc["amgx/cycle/coarse_solve"] == pytest.approx(40e-6)
    assert sc["amgx/krylov/precond"] == pytest.approx(120e-6)
    assert sc["amgx/spmv/dia/kernel"] == pytest.approx(30e-6)
    assert a["total_device_s"] == pytest.approx(160e-6)
    assert a["attributed_s"] + a["unattributed_s"] == \
        pytest.approx(a["total_device_s"])
    assert a["unattributed_s"] == pytest.approx(10e-6)
    assert a["levels"]["0"]["total_s"] == pytest.approx(80e-6)


def test_kcycle_work_counts_to_its_level():
    """A kernel whose innermost cycle scope is ``kcycle<N>`` (level N's
    Krylov acceleration) counts to level N's total, beside the level's
    components, and to nothing deeper."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 1,
           "ts": 10.0 * i, "dur": 5.0, "args": {"amgx_scopes": chain}}
          for i, chain in enumerate([
              "amgx/cycle/kcycle1",
              "amgx/cycle/kcycle1/amgx/cycle/level1/pre_smooth",
              "amgx/cycle/kcycle1/amgx/cycle/kcycle2",
              "amgx/cycle/level0/restrict"])]
    a = deviceprof.measure_anatomy(ev, peak_gbs=1.0)
    assert a["levels"]["1"]["kcycle_s"] == pytest.approx(5e-6)
    assert a["levels"]["1"]["total_s"] == pytest.approx(10e-6)
    assert a["levels"]["2"]["total_s"] == pytest.approx(5e-6)
    assert a["levels"]["0"]["total_s"] == pytest.approx(5e-6)


def test_launch_caught_mid_way_maps_onto_its_last_nodes():
    """The profiler missed a launch's first activity: the rest map onto
    the nodes they match as a suffix (counted as partial)."""
    tr = _synthetic_trace()
    tr["traceEvents"] = [e for e in tr["traceEvents"]
                         if e.get("name") != "void k0(int)"]
    a = deviceprof.measure_anatomy(tr, maps={(7, 0): _MAP},
                                   peak_gbs=1000.0)
    assert a["graphs"]["graph_launches_mapped"] == 1
    assert a["graphs"]["graph_launches_partial"] == 1
    assert "amgx/cycle/level0/pre_smooth" not in a["scopes"]
    assert a["scopes"]["amgx/cycle/coarse_solve"] == pytest.approx(40e-6)


@pytest.mark.parametrize("trace,maps", [
    (_synthetic_trace(4, ("kernel", "gpu_memcpy", "kernel", "kernel")),
     {(7, 0): _MAP}),
    (_synthetic_trace(3, ("kernel", "kernel", "kernel")), {(7, 0): _MAP}),
    (_synthetic_trace(), {}),
], ids=["count", "kind", "no_map"])
def test_unmatched_graph_launch_keeps_its_launch_scopes(trace, maps):
    """A map that does not pair node for node is not used: the launch's
    activities keep the ranges open around the launch only."""
    a = deviceprof.measure_anatomy(trace, maps=maps, peak_gbs=1000.0)
    assert a["graphs"]["graph_launches_mapped"] == 0
    assert "amgx/cycle/level0/pre_smooth" not in a["scopes"]
    assert a["scopes"]["amgx/krylov/precond"] > 0


def test_capture_marks_give_each_node_its_ranges():
    """A mark at node count c opens or closes a range for the nodes from
    c on; the ranges open at a segment's start come first."""
    from amgx_tpu_torch.utils.cuda_graph import node_chains
    marks = [(0, "amgx/a"), (1, "amgx/b"), (3, None), (4, None)]
    assert node_chains(5, [], marks) == [
        "amgx/a", "amgx/a/amgx/b", "amgx/a/amgx/b", "amgx/a", ""]
    assert node_chains(2, ["amgx/o"], [(1, None)]) == ["amgx/o", ""]


def test_scope_is_free_when_off():
    assert not pt.is_enabled()
    assert scopes.scope("spmv", "dia/kernel") is scopes._NULL
    with pt.capture():
        s = scopes.scope("spmv", "dia/kernel")
        assert s is not scopes._NULL and s.name == "amgx/spmv/dia/kernel"


def test_memledger_balance_and_invariant_on_cpu():
    """Registrations balance across setup, resetup and teardown; a pack
    shared by the operator and level 0 counts once; the invariant holds
    with the registered bytes as the truth."""
    memledger.enable(sample_s=0)
    base = memledger.entry_count()
    m = poisson7pt_device(8, 8, 8, device_dtype=np.float64, device="cpu")
    slv = amgx.create_solver(HEADLINE + ", memledger=1")
    slv.setup(m)
    n_setup = memledger.entry_count()
    assert n_setup > base
    snap = memledger.snapshot()
    d = snap["devices"]["cpu"]
    assert not snap["measured"]
    assert d["accounted_bytes"] + d["unaccounted_bytes"] == \
        d["bytes_in_use"]
    fine = slv.Ad.vals.untyped_storage().nbytes()
    assert snap["owners"]["amgx/hierarchy/level0"] >= fine
    assert "amgx/matrix/FGMRES" not in snap["owners"]
    assert sum(snap["owners"].values()) == d["bytes_in_use"]
    m.replace_coefficients(m.host.data * 2.0)
    slv.resetup(m)
    assert memledger.entry_count() == n_setup
    slv.release_memledger()
    assert memledger.entry_count() == base


def test_memledger_postmortem_on_injected_oom():
    from amgx_tpu_torch.errors import AMGXError, RC
    memledger.enable(sample_s=0)
    with pt.capture() as cap:
        err = AMGXError("injected device out-of-memory", RC.NO_MEMORY)
        assert memledger.is_oom_error(err)
        pm = memledger.emit_postmortem(err, "setup")
        assert memledger.emit_postmortem(err, "setup") is None
    assert pm["injected"] and pm["suggestions"]
    for r in cap.records:
        jt.validate_record(r)


def test_telemetry_off_records_nothing():
    m = poisson7pt_device(8, 8, 8, device_dtype=np.float64, device="cpu")
    slv = amgx.create_solver(HEADLINE)
    slv.setup(m)
    slv.solve(np.ones(512))
    assert pt.records() == [] and not pt.is_enabled()
    assert pt.registry().snapshot() == {"counters": {}, "gauges": {},
                                        "histograms": {}}


def test_doctor_module_runs(tmp_path):
    """``python -m amgx_tpu_torch.telemetry.doctor`` on a solve's
    trace (the knob's ``telemetry_path``)."""
    import subprocess
    import sys
    path = str(tmp_path / "solve.jsonl")
    m = poisson7pt_device(8, 8, 8, device_dtype=np.float64, device="cpu")
    slv = amgx.create_solver(HEADLINE + f", telemetry=1, "
                             f"telemetry_path={path}")
    slv.setup(m)
    slv.solve(np.ones(512))
    with open(path) as f:
        assert pt.validate_jsonl(f) > 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m",
                          "amgx_tpu_torch.telemetry.doctor", path],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FGMRES" in out.stdout
    ctrace = str(tmp_path / "solve.chrome.json")
    assert tracefile.write_chrome_trace(ctrace, path) > 0
    with open(ctrace) as f:
        assert tracefile.validate_chrome_trace(json.load(f)) > 0
    assert proftrace.find_trace_file(str(tmp_path)) == ctrace
