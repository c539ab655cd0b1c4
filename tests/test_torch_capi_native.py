"""The port's native C API: ``libamgx_torch_c.so`` built by the port's
own build script (``amgx_tpu_torch/capi_native/build.py``, no cmake), the
JAX package's C driver ``native/test_capi.c`` run unchanged against it,
the headline C driver (``capi_headline.c``) in hDDI at 8³ held to the
in-process port, threads calling in at once, and a device mode without
a card failing with the device RC.  Skips only where this machine lacks
a C compiler or Python's headers / shared library."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from amgx_tpu_torch.capi_native import build

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "amgx_tpu_torch" / "capi_native"


@pytest.fixture(scope="module")
def toolchain():
    """Skips (with the reason) where this machine lacks a C/C++ compiler,
    Python.h or a shared libpython."""
    try:
        build.find_compiler("c")
        build.find_compiler("c++")
        build._python_flags(build.python_build_info())
    except build.ShimBuildError as e:
        pytest.skip(f"no C toolchain for the shim here: {e}")


def _env():
    # the embedded interpreter finds the port through the path the
    # library was built with; nothing here pins it
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def _run(exe, *args, timeout=300):
    return subprocess.run([str(exe), *map(str, args)], env=_env(),
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT))


@pytest.fixture(scope="module")
def drivers(toolchain):
    lib = build.build_shim()
    return {"lib": lib,
            "test_capi": build.build_driver(ROOT / "native" / "test_capi.c"),
            "headline": build.build_driver(HERE / "capi_headline.c"),
            "threads": build.build_driver(HERE / "capi_threads.c")}


def test_builds_without_cmake(drivers):
    lib = drivers["lib"]
    assert lib.name == "libamgx_torch_c.so" and lib.is_file()
    assert lib.parent.parent == build.build_dir().parent
    # a second call reuses the build (the digest names its folder)
    mtime = lib.stat().st_mtime_ns
    assert build.build_shim() == lib and lib.stat().st_mtime_ns == mtime
    out = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                         capture_output=True, text=True)
    if out.returncode == 0:
        header = (ROOT / "native" / "amgx_tpu_c.h").read_text()
        import re
        declared = set(re.findall(r"\b(AMGX_\w+)\s*\(", header))
        exported = set(re.findall(r"\b(AMGX_\w+)\b", out.stdout))
        assert declared <= exported, declared - exported


def test_failed_compile_raises_with_compiler_output(toolchain, tmp_path):
    src = tmp_path / "broken.c"
    src.write_text("int main(void) { return undefined_symbol_here; }\n")
    with pytest.raises(build.ShimBuildError, match="undefined_symbol_here"):
        build.build_driver(src)


def test_native_test_capi_unchanged(drivers):
    r = _run(drivers["test_capi"])
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "NATIVE CAPI TEST PASSED" in r.stdout


def _headline_in_process(side):
    """The same headline solve through the in-process port C API."""
    from amgx_tpu_torch import capi
    from amgx_tpu_torch.io import poisson7pt
    import scipy.sparse as sp
    A = sp.csr_matrix(poisson7pt(side, side, side))
    n = A.shape[0]
    cfg_s = (HERE / "capi_headline.c").read_text()
    cfg_s = "".join(line.strip().strip('"') for line in
                    cfg_s.split("HEADLINE_CFG =")[1].split(";")[0]
                    .splitlines())
    rc, cfg = capi.AMGX_config_create(cfg_s)
    assert rc == 0
    rc, rsrc = capi.AMGX_resources_create_simple(cfg)
    rc, M = capi.AMGX_matrix_create(rsrc, "hDDI")
    rc, b = capi.AMGX_vector_create(rsrc, "hDDI")
    rc, x = capi.AMGX_vector_create(rsrc, "hDDI")
    assert capi.AMGX_matrix_upload_all(M, n, A.nnz, 1, 1, A.indptr,
                                       A.indices, A.data) == 0
    z, y, xg = np.meshgrid(*(np.arange(side, dtype=float),) * 3,
                           indexing="ij")
    assert capi.AMGX_matrix_attach_geometry(M, xg.ravel(), y.ravel(),
                                            z.ravel()) == 0
    capi.AMGX_vector_upload(b, n, 1, np.ones(n))
    capi.AMGX_vector_set_zero(x, n, 1)
    rc, slv = capi.AMGX_solver_create(rsrc, "hDDI", cfg)
    assert capi.AMGX_solver_setup(slv, M) == 0
    assert capi.AMGX_solver_solve(slv, b, x) == 0
    return (capi.AMGX_solver_get_iterations_number(slv)[1],
            capi.AMGX_vector_download(x)[1])


def test_headline_driver_matches_in_process(drivers, tmp_path):
    dump = tmp_path / "x.bin"
    r = _run(drivers["headline"], "hDDI", 8, dump)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("CAPI_HEADLINE ")][-1]
    import json
    got = json.loads(line.split(" ", 1)[1])
    iters, x = _headline_in_process(8)
    assert got["n"] == 512 and got["nnz"] == 3200 and got["status"] == 0
    assert got["iterations"] == iters
    assert got["relres"] <= 1e-8
    x_c = np.fromfile(dump, dtype=np.float64)
    assert np.array_equal(x_c, x)
    assert int(got["x_fnv1a64"], 16) == build.fnv1a64(x)
    assert got["setup_s"] > 0 and got["solve_s"] > 0 and got["import_s"] > 0


def test_threads_call_in_concurrently(drivers):
    r = _run(drivers["threads"], "hDDI", 3)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "CAPI_THREADS PASSED" in r.stdout


def test_device_mode_without_card_fails(drivers):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of a machine without a card")
    r = _run(drivers["headline"], "dDDI", 4)
    assert r.returncode == 1
    assert "AMGX_matrix_upload_all" in r.stderr and "-> 5" in r.stderr
    assert "CAPI_HEADLINE" not in r.stdout


def test_fnv1a64_reference_values(toolchain):
    # the FNV-1a test vectors of its specification
    assert build.fnv1a64(np.frombuffer(b"", np.uint8)) == \
        0xcbf29ce484222325
    assert build.fnv1a64(np.frombuffer(b"a", np.uint8)) == \
        0xaf63dc4c8601ec8c
    assert build.fnv1a64(np.frombuffer(b"foobar", np.uint8)) == \
        0x85944171f73967e8
