"""The headline stack at 16³ on an f32 pack (f64 refinement) with
``telemetry`` and ``setup_profile`` on, through both packages: equal
iterations, the same spans and events for setup and solve, the same
setup-profile phases per level, and traces each package's validator
reads.  The JAX side runs once (a module fixture) on the CPU."""
import collections

import numpy as np
import pytest

import amgx_tpu_torch as amgx
from amgx_tpu_torch import telemetry as pt
from amgx_tpu_torch.io import poisson7pt

jt = pytest.importorskip("amgx_tpu.telemetry")
jamgx = pytest.importorskip("amgx_tpu")

import test_torch_telemetry_solve as base  # noqa: E402

KNOBS = ", telemetry=1, setup_profile=1"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry_f32")
    base._reset()
    out = {}
    try:
        for name, pkg, tel in (("jax", jamgx, jt), ("port", amgx, pt)):
            A = poisson7pt(base.SIDE, base.SIDE, base.SIDE)
            m = pkg.Matrix(A, device="cpu") if pkg is amgx \
                else pkg.Matrix(A)
            m.device_dtype = np.float32
            with tel.capture() as cap:
                slv = pkg.create_solver(pkg.AMGConfig(base.HEADLINE
                                                      + KNOBS))
                slv.setup(m)
                res = slv.solve(np.ones(A.shape[0]))
                path = str(tmp / f"{name}.jsonl")
                tel.dump_jsonl(path)
            out[name] = dict(res=res, recs=cap.records, path=path)
    finally:
        base._reset()
    return out


def test_f32_counts_and_names(runs):
    j, p = runs["jax"], runs["port"]
    assert p["res"].iterations == j["res"].iterations
    for part in ("setup", "solve"):
        nj, np_ = (base._names(r["recs"], part) for r in (j, p))
        if part == "setup":
            assert collections.Counter(np_) == collections.Counter(nj)
        else:
            assert np_ == nj


def test_f32_phases_and_traces(runs):
    def phases(recs):
        return sorted({(r["attrs"]["component"], r["attrs"]["level"])
                       for r in recs if r["kind"] == "event"
                       and r["name"] == "setup_phase"}, key=str)
    assert phases(runs["port"]["recs"]) == phases(runs["jax"]["recs"])
    for t in (pt, jt):
        for k in ("jax", "port"):
            with open(runs[k]["path"]) as f:
                assert t.validate_jsonl(f) > 0
