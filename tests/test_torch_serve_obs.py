"""The serving layer's observability on the CPU: the ``metrics_port``
endpoint's routes (the JAX package's route table), the SLO window event
and the open-loop load generator's report.  Every HTTP request carries a
timeout; the server binds 127.0.0.1 on an ephemeral port."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu
import amgx_tpu_torch
from amgx_tpu_torch import serve as tserve
from amgx_tpu_torch import telemetry as ttel
from amgx_tpu_torch.serve import loadgen

WAIT = 60.0

CFG = ("config_version=2, solver(s)=BLOCK_JACOBI, s:max_iters=60, "
       "s:monitor_residual=1, s:tolerance=1e-8, "
       "s:convergence=RELATIVE_INI, serve_workers=2, "
       "serve_batch_window_ms=5, serve_max_batch=4")


def _get(url, timeout=30.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def served():
    """A started service with its endpoint and a few served requests,
    telemetry on; shut down after the module."""
    ttel.enable()
    A = sp.csr_matrix(amgx_tpu.io.poisson5pt(10, 10))
    m = amgx_tpu_torch.Matrix(A, device="cpu")
    svc = tserve.SolveService(amgx_tpu_torch.AMGConfig(CFG))
    try:
        url = svc.start_endpoint(0)
        for k in range(3):
            svc.solve(m, np.ones(A.shape[0]) * (k + 1), timeout=WAIT)
        yield svc, url, m
    finally:
        svc.shutdown(WAIT)
        ttel.disable()
        ttel.reset()


@pytest.mark.parametrize("route,ctype", [
    ("/metrics", "text/plain"),
    ("/healthz", "application/json"),
    ("/statusz", "application/json"),
    ("/debug/trace", "application/x-ndjson"),
    ("/debug/memory", "application/json"),
    ("/debug/profile?seconds=0.05", "application/json"),
    ("/debug/mesh", "application/json"),
])
def test_endpoint_routes_answer(served, route, ctype):
    svc, url, _m = served
    code, body = _get(url + route)
    assert code == 200, body[:300]
    text = body.decode()
    if route == "/metrics":
        assert "amgx_serve_requests_total" in text
        assert "amgx_slo_window_requests" in text
    elif route == "/healthz":
        h = json.loads(text)
        assert h["accepting"] and not h["overloaded"]
        assert h["lanes_total"] == 1 and h["lanes"][0]["device"] == \
            "default"
    elif route == "/statusz":
        assert json.loads(text)["serving"] is not None
    elif route == "/debug/trace":
        lines = text.strip().splitlines()
        assert json.loads(lines[0])["kind"] == "meta"
        assert ttel.validate_jsonl(lines) > 0
    elif route == "/debug/memory":
        assert "snapshot" in json.loads(text)
    elif route.startswith("/debug/profile"):
        out = json.loads(text)
        assert out["trace"].endswith("trace.json")
        assert "device_anatomy" in out
    elif route == "/debug/mesh":
        mesh = json.loads(text)
        assert mesh["measured"] is False          # one process, one rank


def test_unknown_route_404_with_jax_route_table(served):
    """404 names the routes; the JAX package's endpoint names the same
    ones."""
    from amgx_tpu.telemetry import httpd as jhttpd
    _svc, url, _m = served
    code, body = _get(url + "/nope")
    assert code == 404
    routes = json.loads(body)["routes"]
    ep = jhttpd.serve_httpd(0)
    try:
        code_j, body_j = _get(ep.url + "/nope")
    finally:
        ep.stop()
    assert code_j == 404 and json.loads(body_j)["routes"] == routes


def test_drained_service_is_503(served):
    svc, url, _m = served
    svc._accepting = False
    try:
        code, _ = _get(url + "/healthz")
    finally:
        svc._accepting = True
    assert code == 503


def test_slo_event_and_loadgen_report(served):
    svc, _url, m = served
    with ttel.capture() as cap:
        rep = loadgen.run_load(svc, [m], rps=40.0, duration_s=0.3,
                               multi_rhs_frac=0.5, max_rhs=3, seed=1,
                               wait_timeout_s=WAIT)
        st = svc.stats()
    assert rep["offered"] > 0 and rep["failed"] == 0
    assert rep["completed"] + rep["rejected"] == rep["offered"]
    for k in ("p50_ms", "p99_ms", "attainment"):
        assert rep[k] is not None
    assert cap.events("slo_window")
    assert st["slo"]["requests"] == rep["offered"]
    assert set(st["phase_split"]) >= {"admit", "queue_wait", "prepare",
                                      "solve", "finalize"}
