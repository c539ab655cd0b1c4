"""Public names the JAX package exports and its counterpart modules in the
port must export too: each exists in the port with the JAX package's
parameters (the port may add a ``device`` parameter after them), and the
generators, ``Matrix.from_csr``, ``spmm`` and the determinism checksum
give the JAX package's outputs on the same inputs."""
import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu
import amgx_tpu.amg
import amgx_tpu.io
import amgx_tpu.ops
import amgx_tpu.utils
import amgx_tpu_torch
import amgx_tpu_torch.amg
import amgx_tpu_torch.io
import amgx_tpu_torch.ops
import amgx_tpu_torch.utils
from amgx_tpu import errors as jerrors
from amgx_tpu_torch import errors as terrors

#: (JAX object, port object) of every name on the list of missing public
#: names, by dotted name
NAMES = {
    "io.poisson9pt": (amgx_tpu.io.poisson9pt, amgx_tpu_torch.io.poisson9pt),
    "io.poisson27pt": (amgx_tpu.io.poisson27pt,
                       amgx_tpu_torch.io.poisson27pt),
    "utils.checksum": (amgx_tpu.utils.checksum,
                       amgx_tpu_torch.utils.checksum),
    "utils.DeterminismChecker": (amgx_tpu.utils.DeterminismChecker,
                                 amgx_tpu_torch.utils.DeterminismChecker),
    "utils.determinism_checker": (amgx_tpu.utils.determinism_checker,
                                  amgx_tpu_torch.utils.determinism_checker),
    "utils.TimerMap": (amgx_tpu.utils.TimerMap,
                       amgx_tpu_torch.utils.TimerMap),
    "utils.cpu_profiler": (amgx_tpu.utils.cpu_profiler,
                           amgx_tpu_torch.utils.cpu_profiler),
    "utils.profiler_tree": (amgx_tpu.utils.profiler_tree,
                            amgx_tpu_torch.utils.profiler_tree),
    "utils.memory_info": (amgx_tpu.utils.memory_info,
                          amgx_tpu_torch.utils.memory_info),
    "utils.retry_call": (amgx_tpu.utils.retry_call,
                         amgx_tpu_torch.utils.retry_call),
    "utils.register_print_callback": (
        amgx_tpu.utils.register_print_callback,
        amgx_tpu_torch.utils.register_print_callback),
    "Matrix.from_csr": (amgx_tpu.Matrix.from_csr,
                        amgx_tpu_torch.Matrix.from_csr),
    "Matrix.device": (amgx_tpu.Matrix.device, amgx_tpu_torch.Matrix.device),
    "Matrix.pattern_fingerprint": (amgx_tpu.Matrix.pattern_fingerprint,
                                   amgx_tpu_torch.Matrix.pattern_fingerprint),
    "Matrix.values_fingerprint": (amgx_tpu.Matrix.values_fingerprint,
                                  amgx_tpu_torch.Matrix.values_fingerprint),
    "initialize": (amgx_tpu.initialize, amgx_tpu_torch.initialize),
    "finalize": (amgx_tpu.finalize, amgx_tpu_torch.finalize),
    "get_api_version": (amgx_tpu.get_api_version,
                        amgx_tpu_torch.get_api_version),
    "spmm": (amgx_tpu.spmm, amgx_tpu_torch.spmm),
    "register_print_callback": (amgx_tpu.register_print_callback,
                                amgx_tpu_torch.register_print_callback),
    "amgx_output": (amgx_tpu.amgx_output, amgx_tpu_torch.amgx_output),
    "create_solver": (amgx_tpu.create_solver, amgx_tpu_torch.create_solver),
    "ops.spmv": (amgx_tpu.ops.spmv, amgx_tpu_torch.ops.spmv),
    "ops.spmm": (amgx_tpu.ops.spmm, amgx_tpu_torch.ops.spmm),
    "ops.residual": (amgx_tpu.ops.residual, amgx_tpu_torch.ops.residual),
    "amg.AMGHierarchy": (amgx_tpu.amg.AMGHierarchy,
                         amgx_tpu_torch.amg.AMGHierarchy),
    "amg.build_cycle": (amgx_tpu.amg.build_cycle,
                        amgx_tpu_torch.amg.build_cycle),
    "amg.AMGLevel": (amgx_tpu.amg.AMGLevel, amgx_tpu_torch.amg.AMGLevel),
    "amg.AggregationLevel": (amgx_tpu.amg.AggregationLevel,
                             amgx_tpu_torch.amg.AggregationLevel),
    "amg.ClassicalLevel": (amgx_tpu.amg.ClassicalLevel,
                           amgx_tpu_torch.amg.ClassicalLevel),
    "errors.classify_exception": (jerrors.classify_exception,
                                  terrors.classify_exception),
}


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


@pytest.mark.parametrize("name", sorted(NAMES))
def test_name_exists_with_jax_signature(name):
    """Every JAX parameter is in the port's signature, in the same
    order and with the same default; the port adds only ``device``
    (after them).  The checker and timer classes compare their public
    methods the same way; the AMG classes are the port's own (their
    internals follow torch), so their export is what is held."""
    jx, pt = NAMES[name]
    if name.startswith("amg."):
        assert inspect.isclass(pt) == inspect.isclass(jx)
        assert pt.__name__ == jx.__name__
        return
    pairs = [(jx, pt)]
    if inspect.isclass(jx):
        pairs = [(getattr(jx, m), getattr(pt, m, None))
                 for m in vars(jx) if not m.startswith("_")
                 and callable(getattr(jx, m))] or [(jx, pt)]
    for j, p in pairs:
        assert p is not None, (name, j)
        pj, pp = _params(j), _params(p)
        if pj is None:
            continue
        names_p = list(pp)
        extra = [k for k in names_p if k not in pj]
        assert extra in ([], ["device"]), (name, extra)
        assert names_p[:len(pj)] == list(pj), (name, list(pj), names_p)
        for k, v in pj.items():
            assert pp[k].default == v.default, (name, k)


def test_package_all_covers_jax_names():
    """The package namespaces export what the JAX package's do (the
    JAX-only mechanics and the C API's matrix analysis aside)."""
    jax_only = {"telemetry", "analyze_matrix", "estimate_spectral_bounds"}
    for jmod, tmod in ((amgx_tpu, amgx_tpu_torch),
                       (amgx_tpu.ops, amgx_tpu_torch.ops),
                       (amgx_tpu.amg, amgx_tpu_torch.amg),
                       (amgx_tpu.utils, amgx_tpu_torch.utils),
                       (amgx_tpu.io, amgx_tpu_torch.io)):
        missing = [n for n in jmod.__all__
                   if n not in jax_only and not hasattr(tmod, n)]
        assert missing == [], (jmod.__name__, missing)
    assert amgx_tpu_torch.get_api_version() == amgx_tpu.get_api_version()
    assert int(amgx_tpu_torch.initialize()) == int(amgx_tpu.initialize())
    assert int(amgx_tpu_torch.finalize()) == int(amgx_tpu.finalize())


@pytest.mark.parametrize("gen,args", [("poisson9pt", (5, 4)),
                                      ("poisson27pt", (4, 3, 3))])
def test_generators_match_jax(gen, args):
    a = getattr(amgx_tpu.io, gen)(*args)
    b = getattr(amgx_tpu_torch.io, gen)(*args)
    assert a.shape == b.shape and a.nnz == b.nnz
    assert abs(a - b).max() == 0


@pytest.mark.parametrize("block_dim", [1, 2])
def test_from_csr_matches_jax(block_dim, rng):
    base = sp.csr_matrix(amgx_tpu.io.poisson5pt(4, 4))
    b = block_dim
    data = rng.standard_normal((base.nnz, b, b)) if b > 1 \
        else rng.standard_normal(base.nnz)
    mj = amgx_tpu.Matrix.from_csr(base.indptr, base.indices, data,
                                  block_dim=b)
    mt = amgx_tpu_torch.Matrix.from_csr(base.indptr, base.indices, data,
                                        block_dim=b, device="cpu")
    assert mt.block_dim == mj.block_dim == b
    assert abs(mt.host - mj.host).max() == 0
    assert mt.pattern_fingerprint() == mj.pattern_fingerprint()
    assert mt.values_fingerprint() == mj.values_fingerprint()


def test_spmm_and_ell_width_match_jax(rng):
    A = sp.csr_matrix(sp.random(60, 60, density=0.4, random_state=3)
                      + sp.eye(60))
    X = rng.standard_normal((A.shape[0], 3))
    dj = amgx_tpu.Matrix(A).device(np.float64, ell_max_width=8)
    dt = amgx_tpu_torch.Matrix(A, device="cpu").device(np.float64,
                                                       ell_max_width=8)
    # too many diagonals for DIA, and some 24 entries a row exceed the
    # width budget of 8: both pack CSR
    assert dj.fmt == dt.fmt == "csr"
    yj = np.asarray(amgx_tpu.spmm(dj, X))
    yt = amgx_tpu_torch.spmm(dt, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(yt, A @ X, rtol=1e-14, atol=1e-13)


def test_determinism_checksum_matches_jax(rng):
    a = rng.standard_normal(17)
    assert amgx_tpu_torch.utils.checksum(a) == amgx_tpu.utils.checksum(a)
    assert amgx_tpu_torch.utils.checksum(torch.from_numpy(a)) == \
        amgx_tpu.utils.checksum(a)
    dj = amgx_tpu.utils.DeterminismChecker()
    dt = amgx_tpu_torch.utils.DeterminismChecker()
    for k in range(3):
        dj.checkpoint(f"b{k}", a * k)
        dt.checkpoint(f"b{k}", torch.from_numpy(a * k))
    assert dt.digest() == dj.digest()
    other = amgx_tpu_torch.utils.DeterminismChecker()
    other.checkpoint("b0", a)
    assert dt.compare(other) == ["b0", "<path length mismatch>"]


def test_timer_map_and_errors():
    tm = amgx_tpu_torch.utils.TimerMap()
    tm.tic("solve")
    dt = tm.toc("solve")
    assert dt >= 0 and tm.get("solve") == dt and "solve" in tm.report()
    for rc in (terrors.RC.NO_MEMORY, terrors.RC.UNKNOWN):
        for setup in (True, False):
            got = terrors.classify_exception(
                terrors.AMGXError("x", rc), during_setup=setup)
            want = jerrors.classify_exception(
                jerrors.AMGXError("x", jerrors.RC(int(rc))),
                during_setup=setup)
            assert got.value == want.value
    oom = torch.cuda.OutOfMemoryError("out of memory")
    assert terrors.exception_rc(oom) == terrors.RC.NO_MEMORY
    assert terrors.classify_exception(oom, during_setup=True) == \
        terrors.FailureKind.DEVICE_ERROR
    with pytest.raises(terrors.BadModeError):
        amgx_tpu_torch.create_solver("config_version=2, solver=PCG",
                                     mode="xyz")
