"""The serving layer (``amgx_tpu_torch/serve/``) against the JAX
package's: one request sequence through both services (built with
``start=False``, submitted, then started, so the batching is the same),
the RCs of admission and execution failures, concurrency, warmup, and
the port's serving trace read by the JAX package's validator and doctor.

Every wait carries a timeout and every service is shut down in a
``finally``: a wedged service fails its test instead of hanging the run.
"""
import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu
import amgx_tpu_torch
from amgx_tpu import serve as jserve
from amgx_tpu import telemetry as jtel
from amgx_tpu.utils import faultinject as jfault
from amgx_tpu_torch import serve as tserve
from amgx_tpu_torch import telemetry as ttel
from amgx_tpu_torch.errors import RC
from amgx_tpu_torch.utils import faultinject as tfault

WAIT = 120.0

AMG_PCG_CFG = (
    "config_version=2, solver(out)=PCG, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-10, "
    "out:convergence=RELATIVE_INI, out:store_res_history=1, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=1, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")

JACOBI_CFG = (
    "config_version=2, solver(s)=BLOCK_JACOBI, s:max_iters=60, "
    "s:monitor_residual=1, s:tolerance=1e-8, "
    "s:convergence=RELATIVE_INI")

SERVE = ", serve_batch_window_ms=10, serve_max_batch=4"


class _Pkg:
    """One package's serving entry points, named alike."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.mod = amgx_tpu if self.jax else amgx_tpu_torch
        self.serve = jserve if self.jax else tserve
        self.tel = jtel if self.jax else ttel
        self.fault = jfault if self.jax else tfault

    def matrix(self, A):
        return self.mod.Matrix(A) if self.jax else \
            self.mod.Matrix(A, device="cpu")

    def service(self, cfg, start=True):
        return self.serve.SolveService(self.mod.AMGConfig(cfg),
                                       start=start)


PKGS = {n: _Pkg(n) for n in ("jax", "torch")}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for p in PKGS.values():
        p.fault.reset()
        p.tel.disable()
        p.tel.reset()


def _systems():
    rng = np.random.default_rng(11)
    A1 = amgx_tpu.io.poisson7pt(8, 8, 8)
    # drifted values, same pattern, still symmetric positive definite
    D = sp.diags(1.0 + 0.1 * rng.random(A1.shape[0]))
    A1d = sp.csr_matrix(D @ A1 @ D)
    A1d.sort_indices()
    A2 = sp.csr_matrix(amgx_tpu.io.poisson5pt(12, 12))
    n1, n2 = A1.shape[0], A2.shape[0]
    bs = [rng.standard_normal(n1) for _ in range(4)] + \
        [rng.standard_normal(n2)]
    return A1, A1d, A2, bs


def _serve_sequence(pkg):
    """Three right-hand sides of one matrix, one of its drifted values,
    one of a second pattern, queued before the dispatcher starts, on
    one worker (the batches then run in queue order)."""
    A1, A1d, A2, bs = _systems()
    m1, m1d, m2 = pkg.matrix(A1), pkg.matrix(A1d), pkg.matrix(A2)
    svc = pkg.service(AMG_PCG_CFG + SERVE + ", serve_workers=1",
                      start=False)
    try:
        with pkg.tel.capture() as cap:
            svc._accepting = True
            pend = [svc.submit(m1, bs[0]), svc.submit(m1, bs[1]),
                    svc.submit(m1, bs[2]), svc.submit(m1d, bs[3]),
                    svc.submit(m2, bs[4])]
            svc.start()
            res = [p.wait(WAIT) for p in pend]
            assert svc.drain(WAIT)
            st = svc.stats()
    finally:
        svc.shutdown(WAIT)
    sizes = [r["value"] for r in cap.metric_records(
        "amgx_serve_batch_size", kind="hist")]
    setups = {k: v for k, v in
              cap.counter_totals("amgx_serve_setup_total").items()}
    return {"rcs": [int(p.rc) for p in pend],
            "iters": [int(r.iterations) for r in res],
            "x": [np.asarray(r.x.numpy() if hasattr(r.x, "numpy")
                             else r.x) for r in res],
            "sizes": sizes, "setups": setups,
            "by_session": sorted(
                (s["pattern"], s["full_setups"], s["resetups"],
                 s["value_hits"]) for s in st["cache"]["by_session"]),
            "misses": st["cache"]["misses"], "records": cap.records}


@pytest.fixture(scope="module")
def runs():
    return {n: _serve_sequence(p) for n, p in PKGS.items()}


def test_sequence_counts_and_x_equal_jax(runs):
    j, t = runs["jax"], runs["torch"]
    assert t["rcs"] == j["rcs"] == [0] * 5
    assert t["iters"] == j["iters"]
    for xt, xj in zip(t["x"], j["x"]):
        np.testing.assert_allclose(xt, xj, rtol=1e-10,
                                   atol=1e-10 * np.abs(xj).max())


def test_sequence_cache_decisions_equal_jax(runs):
    """One full setup per pattern, one resetup for the drifted values,
    the same micro-batches (3, 1, 1) and setup kinds."""
    j, t = runs["jax"], runs["torch"]
    assert t["by_session"] == j["by_session"]
    assert [s[1:] for s in t["by_session"]] in ([(1, 1, 0), (1, 0, 0)],
                                                [(1, 0, 0), (1, 1, 0)])
    assert t["misses"] == j["misses"] == 2
    assert t["sizes"] == j["sizes"] == [3.0, 1.0, 1.0]
    assert t["setups"] == j["setups"]


def test_sequence_matches_direct_solves(runs):
    """A served answer is a direct ``Solver.solve`` of the same system:
    the same count and the same bits."""
    A1, A1d, A2, bs = _systems()
    t = runs["torch"]
    for k, A in ((0, A1), (1, A1), (3, A1d), (4, A2)):
        slv = amgx_tpu_torch.create_solver(AMG_PCG_CFG)
        slv.setup(amgx_tpu_torch.Matrix(A, device="cpu"))
        r = slv.solve(bs[k])
        assert int(r.iterations) == t["iters"][k]
        assert np.array_equal(r.x.numpy(), t["x"][k]), k


def test_port_trace_read_by_jax_tools(runs, tmp_path):
    """The port's serving trace validates under the JAX package's schema
    validator, and the JAX package's doctor renders its serving
    section (and the port's doctor the same numbers)."""
    from amgx_tpu.telemetry import doctor as jdoctor
    from amgx_tpu_torch.telemetry import doctor as tdoctor
    path = str(tmp_path / "serve.jsonl")
    ttel.dump_jsonl(path, runs["torch"]["records"])
    with open(path) as f:
        assert jtel.validate_jsonl(f) > 0
    with open(path) as f:
        assert ttel.validate_jsonl(f) > 0
    dj, dt = jdoctor.diagnose([path]), tdoctor.diagnose([path])
    assert dj["serving"] is not None
    assert dj["serving"]["cache"]["misses"] == 2
    assert dj["serving"] == dt["serving"]
    assert "serving" in jdoctor.render(dj)
    names = {r["name"] for r in runs["torch"]["records"]
             if r["kind"] == "event"}
    assert "request_trace" in names


# ------------------------------------------------------------------ RCs
def _scenario(pkg, which):
    """The RC (and error head) of one failure scenario."""
    A = sp.csr_matrix(amgx_tpu.io.poisson5pt(8, 8))
    n = A.shape[0]
    m = pkg.matrix(A)
    b = np.ones(n)
    extra = {"backpressure": ", serve_queue_depth=2",
             "quarantine": ", serve_quarantine_threshold=2",
             "worker_death": ", serve_retry_max=1"}.get(which, "")
    start = which in ("drain", "quarantine", "worker_death")
    svc = pkg.service(JACOBI_CFG + SERVE + ", serve_workers=1" + extra,
                      start=start)
    out = []
    try:
        svc._accepting = True
        if which == "backpressure":
            ps = [svc.submit(m, b) for _ in range(3)]
            svc.start()
            for p in ps:
                p.wait_done(WAIT)
            out = [(int(p.rc), p.result is not None) for p in ps]
        elif which == "deadline":
            p = svc.submit(m, b, deadline_s=0.001)
            time.sleep(0.05)
            svc.start()
            assert p.wait_done(WAIT)
            out = [(int(p.rc), "deadline" in (p.error or ""))]
        elif which == "mutated":
            p = svc.submit(m, b)
            m.replace_coefficients(np.asarray(m.host.data) * 2.0)
            svc.start()
            assert p.wait_done(WAIT)
            out = [(int(p.rc), "changed after submit" in (p.error or ""))]
        elif which == "drain":
            assert svc.drain(WAIT)
            p = svc.submit(m, b)
            out = [(int(p.rc), "draining" in (p.error or ""))]
        elif which == "quarantine":
            pkg.fault.configure("setup_error")
            for _ in range(2):
                p = svc.submit(m, b)
                assert p.wait_done(WAIT)
                out.append((int(p.rc), p.result is None))
            pkg.fault.reset()
            p = svc.submit(m, b)
            out.append((int(p.rc), "quarantined" in (p.error or "")))
            out.append(sorted(len(k) for k in svc.quarantined_patterns()))
        elif which == "worker_death":
            pkg.fault.configure("worker_death:count=1")
            p = svc.submit(m, b)
            res = p.wait(WAIT)
            out = [(int(p.rc), res is not None,
                    svc.stats()["worker_task_failures"])]
    finally:
        svc.shutdown(WAIT)
        pkg.fault.reset()
    return out


@pytest.mark.parametrize("which", ["backpressure", "deadline", "mutated",
                                   "drain", "quarantine", "worker_death"])
def test_failure_rcs_equal_jax(which):
    got = _scenario(PKGS["torch"], which)
    want = _scenario(PKGS["jax"], which)
    assert got == want
    rc = {"backpressure": [(0, True), (0, True), (int(RC.REJECTED),
                                                  False)],
          "deadline": [(int(RC.REJECTED), True)],
          "mutated": [(int(RC.BAD_PARAMETERS), True)],
          "drain": [(int(RC.REJECTED), True)],
          "worker_death": [(0, True, 1)]}.get(which)
    if rc is not None:
        assert got == rc


# ---------------------------------------------------------- concurrency
def _concurrent(workers):
    A1, _, A2, bs = _systems()
    ms = [amgx_tpu_torch.Matrix(A, device="cpu") for A in (A1, A2)]
    svc = tserve.SolveService(amgx_tpu_torch.AMGConfig(
        AMG_PCG_CFG + SERVE + f", serve_workers={workers}"))
    jobs = [(k % 2, bs[k % 4] if k % 2 == 0 else bs[4] * (1 + k))
            for k in range(12)]
    out = [None] * len(jobs)
    try:
        def client(c):
            for k in range(c, len(jobs), 4):
                mi, b = jobs[k]
                out[k] = svc.solve(ms[mi], b, timeout=WAIT)

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        st = svc.stats()
    finally:
        svc.shutdown(WAIT)
    return out, st


def test_two_workers_equal_one_worker():
    """Four client threads: the answers under ``serve_workers=2`` are
    bit-equal to those under ``serve_workers=1``; one full setup per
    pattern either way."""
    r1, s1 = _concurrent(1)
    r2, s2 = _concurrent(2)
    for a, b in zip(r1, r2):
        assert a.iterations == b.iterations
        assert np.array_equal(a.x.numpy(), b.x.numpy())
    for st in (s1, s2):
        assert st["completed"] == 12 and st["rejected"] == 0
        assert sorted(s["full_setups"] for s in
                      st["cache"]["by_session"]) == [1, 1]


def test_warmup_prepares_then_reuses():
    """Warmup sets each pattern up (its home lane routed, the bucket
    ladder reported) and runs one solve; the first request then reuses
    the session with no setup."""
    A1, _, _, bs = _systems()
    m = amgx_tpu_torch.Matrix(A1, device="cpu")
    svc = tserve.SolveService(amgx_tpu_torch.AMGConfig(
        AMG_PCG_CFG + SERVE + ", serve_workers=1, "
        "serve_warmup_max_batch=3"))
    try:
        with ttel.capture() as cap:
            w = svc.warmup(m)
            r = svc.solve(m, bs[0], timeout=WAIT)
            st = svc.stats()
    finally:
        svc.shutdown(WAIT)
    assert w["buckets"] == [1, 2, 4]
    assert [d["prepare"] for d in w["details"]] == ["full"]
    assert cap.counter_total("amgx_serve_setup_total", kind="reuse") == 1
    assert st["cache"]["by_session"][0]["full_setups"] == 1
    assert st["cache"]["by_session"][0]["value_hits"] == 1
    assert st["cache"]["resident_bytes"] > 0
    assert r.status == 0
    assert [e for e in cap.events("serve_warmup")]
