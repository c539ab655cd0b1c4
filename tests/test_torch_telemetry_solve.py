"""A solve with telemetry on, through both packages: the headline stack
at 16³ in f64 with ``telemetry``, ``setup_profile`` and ``forensics``
on.  The port must take the JAX package's iterations, report its final
residual gauge to 1e-10, emit the same spans and events for setup and
solve and the same setup-profile phases per level, write a JSONL trace
each package's validator and the JAX doctor read, and record the same
cycle anatomy (reduction factors to 1e-8) and hierarchy probes.  With
each of the four knobs on or off the port's x and counts are the same
bits.  The JAX side runs once (a module fixture) on the CPU."""
import collections

import numpy as np
import pytest
import torch

import amgx_tpu_torch as amgx
from amgx_tpu_torch import telemetry as pt
from amgx_tpu_torch.io import poisson7pt, poisson7pt_device

jt = pytest.importorskip("amgx_tpu.telemetry")
jamgx = pytest.importorskip("amgx_tpu")
from amgx_tpu.telemetry import doctor as jdoctor  # noqa: E402

from test_torch_telemetry import HEADLINE  # noqa: E402

KNOBS = ", telemetry=1, setup_profile=1, forensics=1"
SIDE = 16
#: cycle events: the JAX package's host callbacks are unordered, so
#: these are compared as counts and factors, not by position
_CYCLE = ("cycle_level", "cycle_coarse")


def _reset():
    """Both packages' recorders off and empty, and both device setup
    engines forgotten: a setup reports its engine's stats when one
    exists, so an engine an earlier test left in one package only would
    add an event to that package's setup."""
    from amgx_tpu.amg.device_setup import reset_engine as jax_reset
    from amgx_tpu_torch.amg.device_setup import reset_engine
    for t in (pt, jt):
        t.disable()
        t.setup_profile.disable()
        t.reset()
    reset_engine()
    jax_reset()


def _run(pkg, tel, device_dtype, tmp):
    """Setup and solve under ``tel.capture``; the solver, result,
    records and the trace dumped to ``tmp``."""
    A = poisson7pt(SIDE, SIDE, SIDE)
    m = pkg.Matrix(A, device="cpu") if pkg is amgx else pkg.Matrix(A)
    m.device_dtype = device_dtype
    with tel.capture(ring_size=1 << 18) as cap:
        slv = pkg.create_solver(pkg.AMGConfig(HEADLINE + KNOBS))
        slv.setup(m)
        res = slv.solve(np.ones(A.shape[0]))
        path = str(tmp / f"{pkg.__name__}.jsonl")
        tel.dump_jsonl(path)
    return dict(slv=slv, res=res, recs=cap.records, path=path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry_solve")
    _reset()
    try:
        out = {"jax": _run(jamgx, jt, np.float64, tmp),
               "port": _run(amgx, pt, np.float64, tmp)}
    finally:
        _reset()
    return out


def _names(recs, part):
    """(kind, name) of the span openings and events of the setup or the
    solve (split at the solve span), cycle events left out."""
    i = next(k for k, r in enumerate(recs)
             if r["kind"] == "span_begin" and r["name"] == "solve")
    sel = recs[:i] if part == "setup" else recs[i:]
    return [(r["kind"], r["name"]) for r in sel
            if r["kind"] in ("span_begin", "event")
            and r["name"] not in _CYCLE]


def test_counts_and_residual_gauge(runs):
    j, p = runs["jax"], runs["port"]
    assert p["res"].iterations == j["res"].iterations
    gj = [r["value"] for r in j["recs"] if r["kind"] == "gauge"
          and r["name"] == "amgx_solve_final_relres"][-1]
    gp = [r["value"] for r in p["recs"] if r["kind"] == "gauge"
          and r["name"] == "amgx_solve_final_relres"][-1]
    assert gp == pytest.approx(gj, rel=1e-10)


@pytest.mark.parametrize("part", ["setup", "solve"])
def test_span_and_event_names(runs, part):
    """The same spans and events: the setup's as a multiset (the JAX
    package sets the smoothers up on worker threads, whose records
    interleave), the solve's in order."""
    j, p = (_names(runs[k]["recs"], part) for k in ("jax", "port"))
    if part == "setup":
        assert collections.Counter(p) == collections.Counter(j)
    else:
        assert p == j


def test_setup_profile_phases_per_level(runs):
    def phases(recs):
        return sorted({(r["attrs"]["component"], r["attrs"]["level"])
                       for r in recs if r["kind"] == "event"
                       and r["name"] == "setup_phase"},
                      key=str)
    assert phases(runs["port"]["recs"]) == phases(runs["jax"]["recs"])


def test_traces_cross_validate_and_the_jax_doctor_reads_the_port(runs):
    for t in (pt, jt):
        for k in ("jax", "port"):
            with open(runs[k]["path"]) as f:
                assert t.validate_jsonl(f) > 0
    text = jdoctor.render(jdoctor.diagnose([runs["port"]["path"]]))
    assert "FGMRES" in text


def test_cycle_anatomy_matches_jax(runs):
    j, p = runs["jax"]["recs"], runs["port"]["recs"]
    for name in _CYCLE:
        assert sum(r["name"] == name for r in p) == \
            sum(r["name"] == name for r in j) > 0
    aj = jt.forensics.cycle_anatomy(j)
    ap = pt.forensics.cycle_anatomy(p)
    assert set(ap["levels"]) == set(aj["levels"])
    for lvl, d in aj["levels"].items():
        for comp, f in d.items():
            if isinstance(f, float):
                assert ap["levels"][lvl][comp] == pytest.approx(
                    f, rel=1e-8), (lvl, comp)
            else:
                assert ap["levels"][lvl][comp] == f
    assert ap["coarse"]["cycles"] == aj["coarse"]["cycles"]
    assert ap["coarse"]["factor"] == pytest.approx(aj["coarse"]["factor"],
                                                   rel=1e-8)


def test_probe_gauges_match_jax(runs):
    def probes(recs):
        return {r["attrs"]["level"]: r["attrs"] for r in recs
                if r["kind"] == "event" and r["name"] == "forensics_probe"}
    pj, pp = probes(runs["jax"]["recs"]), probes(runs["port"]["recs"])
    assert set(pp) == set(pj) and pj
    for lvl, a in pj.items():
        for key in ("rows", "cf_ratio", "nullspace", "strong_frac",
                    "galerkin_err"):
            if isinstance(a.get(key), float):
                assert pp[lvl][key] == pytest.approx(a[key], rel=1e-10)
            else:
                assert pp[lvl].get(key) == a.get(key)


@pytest.mark.parametrize("knob", ["telemetry", "forensics", "setup_profile",
                                  "memledger"])
def test_knob_changes_no_number(knob):
    """x and the counts are the same bits with the knob on and off (an
    f32 pack with f64 refinement at 16³ on the CPU)."""
    out = {}
    for on in (0, 1):
        _reset()
        pt.memledger.disable()
        m = poisson7pt_device(SIDE, SIDE, SIDE, device_dtype=np.float32,
                              device="cpu")
        slv = amgx.create_solver(HEADLINE + f", {knob}={on}")
        slv.setup(m)
        out[on] = slv.solve(np.ones(SIDE ** 3))
    _reset()
    pt.memledger.disable()
    assert out[1].iterations == out[0].iterations
    assert torch.equal(out[1].x, out[0].x)
