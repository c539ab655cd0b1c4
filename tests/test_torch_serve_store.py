"""The warm start on the CPU: the plan store (``serve/aot.py``) across two
fresh stores on one directory, its fallbacks (a version mismatch, an
injected and a real corrupt entry), the two knobs, and kernel builds
that are safe across threads and processes (``native.py``, with a
stand-in ``nvcc``)."""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu_torch
from amgx_tpu_torch import native
from amgx_tpu_torch import telemetry as ttel
from amgx_tpu_torch.amg.device_setup import engine_stats, reset_engine
from amgx_tpu_torch.serve import aot
from amgx_tpu_torch.utils import faultinject

ROOT = Path(__file__).resolve().parent.parent

CFG = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-10, "
       "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
       "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER, "
       "amg:device_setup_min_rows=0")


@pytest.fixture(autouse=True)
def _clean():
    yield
    aot.reset_store()
    reset_engine()
    faultinject.reset()
    ttel.disable()
    ttel.reset()
    ttel.runstate.reset()
    native.set_build_dir("")


@pytest.fixture(scope="module")
def dfg():
    return amgx_tpu_torch.io.dfg_cylinder_pressure(16)


def _setup_solve(A, store_dir, extra=""):
    """A fresh engine and store on ``store_dir`` (a fresh process's
    view), one setup and one solve."""
    aot.reset_store()
    reset_engine()
    slv = amgx_tpu_torch.create_solver(CFG + f", aot_store_dir={store_dir}"
                                       + extra)
    slv.setup(amgx_tpu_torch.Matrix(A, device="cpu"))
    res = slv.solve(np.ones(A.shape[0]))
    ops = [lvl.A.host for lvl in slv.preconditioner.hierarchy.levels[1:]]
    return res, engine_stats(), aot.store_stats(), ops


def test_store_roundtrip_builds_no_plan(dfg, tmp_path):
    with ttel.capture() as c1:
        r1, e1, s1, ops1 = _setup_solve(dfg, tmp_path)
    with ttel.capture() as c2:
        r2, e2, s2, ops2 = _setup_solve(dfg, tmp_path)
    assert e1["builds"] > 0 and s1["saves"] == e1["builds"]
    assert s1["entries"] == e1["builds"]
    # the second "process" loads every plan and builds none
    assert e2["builds"] == 0 and s2["loads"] == s1["saves"]
    assert s2["misses"] == 0 and s2["fallbacks"] == 0
    assert c2.counter_total("amgx_compile_cache_misses_total",
                            layer="aot") == 0
    assert c2.counter_total("amgx_compile_cache_hits_total",
                            layer="aot") == s2["loads"]
    assert c1.counter_total("amgx_compile_cache_misses_total",
                            layer="aot") == s1["misses"]
    assert r2.iterations == r1.iterations
    assert np.array_equal(r2.x.numpy(), r1.x.numpy())
    assert len(ops1) == len(ops2) > 0
    for a, b in zip(ops1, ops2):
        assert (a != b).nnz == 0


@pytest.mark.parametrize("fault", ["version", "injected", "truncated"])
def test_store_fallbacks_rebuild_and_solve(dfg, tmp_path, monkeypatch,
                                           fault):
    """A version mismatch, an ``aot_corrupt`` injection and a truncated
    entry each record a ``compile_cache_fallback`` and rebuild: the
    solve is the same."""
    r1, e1, s1, _ = _setup_solve(dfg, tmp_path)
    extra = ""
    if fault == "version":
        monkeypatch.setattr(aot, "runtime_versions",
                            lambda: {"torch": "0.0", "cuda": "none"})
    elif fault == "injected":
        extra = ", fault_inject=aot_corrupt:count:1"
    else:
        entry = sorted(tmp_path.glob("*.npz"))[0]
        entry.write_bytes(entry.read_bytes()[:40])
    with ttel.capture() as cap:
        r2, e2, s2, _ = _setup_solve(dfg, tmp_path, extra)
    ev = cap.events("compile_cache_fallback")
    reasons = {e["attrs"]["reason"] for e in ev}
    assert s2["fallbacks"] >= 1 and ev
    want = {"version": "version", "injected": "corrupt:injected"}.get(
        fault)
    if want is not None:
        assert reasons == {want}
    else:
        assert all(r.startswith("corrupt:") for r in reasons)
        # the bad entry was deleted, and the rebuilt plan stored anew
        assert s2["saves"] == 1 and s2["entries"] == s1["entries"]
    assert e2["builds"] == s2["fallbacks"]
    assert r2.iterations == r1.iterations
    assert np.array_equal(r2.x.numpy(), r1.x.numpy())


def test_plan_encoding_roundtrip():
    """Every field of a Galerkin plan survives the store's encoding."""
    from amgx_tpu_torch.ops import spgemm
    A = sp.csr_matrix(amgx_tpu_torch.io.poisson5pt(6, 6))
    P = sp.csr_matrix(np.kron(np.eye(18), np.ones((2, 1))))
    plan = spgemm.build_galerkin_plan(A, P)
    arrays, spec = aot.encode_plan(plan)
    back = aot.decode_plan(arrays, spec, "cpu")
    assert type(back) is type(plan) and back.nbytes == plan.nbytes
    vA = __import__("torch").from_numpy(A.data)
    vP = __import__("torch").from_numpy(P.data)
    assert np.array_equal(spgemm.galerkin_numeric(back, vA, vP).numpy(),
                          spgemm.galerkin_numeric(plan, vA, vP).numpy())


def test_knobs_configure_store_and_build_dir(tmp_path):
    cache, store = tmp_path / "cache", tmp_path / "store"
    slv = amgx_tpu_torch.create_solver(
        CFG + f", compile_cache_dir={cache}, aot_store_dir={store}")
    assert native.BUILD_DIR == cache.resolve()
    assert aot.get_store() is not None and \
        aot.get_store().root == str(store)
    assert ttel.runstate.state_path() == str(store /
                                             "amgx_runstate.json")
    assert slv is not None


def _stub_nvcc(tmp_path) -> Path:
    """A stand-in ``nvcc``: waits a little (a build in progress), writes
    its ``-o`` target and appends one line per run to a log."""
    log = tmp_path / "nvcc_runs.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'wb').write(b'stub')\n"
        f"open({str(log)!r}, 'a').write('run\\n')\n")
    stub.chmod(0o755)
    return stub


def test_concurrent_builds_run_nvcc_once(tmp_path, monkeypatch):
    stub = _stub_nvcc(tmp_path)
    monkeypatch.setattr(native, "find_nvcc", lambda: str(stub))
    native.set_build_dir(tmp_path / "build")
    before = native.build_stats()
    outs = []
    threads = [threading.Thread(
        target=lambda: outs.append(native.build_all(["dia_spmv"])),
        daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(outs) == 2 and outs[0] == outs[1]
    assert (tmp_path / "nvcc_runs.log").read_text().count("run") == 1
    after = native.build_stats()
    assert after["misses"] - before["misses"] == 1
    assert after["hits"] - before["hits"] == 1
    built = outs[0]["dia_spmv"]
    assert built.read_bytes() == b"stub"
    assert not list(built.parent.glob("*.tmp.so"))
    # a second process with the same directory finds the library and
    # builds nothing
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from amgx_tpu_torch import native\n"
            "native.find_nvcc = lambda: sys.argv[3]\n"
            "native.set_build_dir(sys.argv[2])\n"
            "native.build_all(['dia_spmv'])\n"
            "print(native.build_stats())\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT), str(tmp_path / "build"),
         str(stub)], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "{'hits': 1, 'misses': 0}"
    assert (tmp_path / "nvcc_runs.log").read_text().count("run") == 1
