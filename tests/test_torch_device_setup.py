"""The port's device setup engine (``amg/device_setup/``, the plans of
``ops/spgemm.py``) on the CPU against scipy, the host generators and the
JAX package's engine (``amgx_tpu/amg/device_setup/``), f64:

* the Galerkin plan and the SpGEMM plan against scipy, relative 1e-12,
  the pattern equal; the same values as the JAX package's numeric pass,
  which adds each slot's terms in the same order;
* scalar and b ∈ {2, 3, 4} block aggregation Galerkin against the host
  generator and against the JAX engine;
* ``keep_pattern`` keeps the slots whose values cancel; a plan-cache hit
  skips the symbolic pass; LRU eviction under the byte budget; each
  decline reason counted;
* through the hierarchy: classical and aggregation levels at and above
  ``device_setup_min_rows`` take the engine's product, coarse operators
  within 1e-12 of the JAX package's; ``device_setup=0`` never consults
  the engine; a resetup of an unchanged pattern hits the plan cache; an
  error inside a numeric pass raises out of ``setup()`` with no scipy
  fallback."""
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu
from amgx_tpu.amg.device_setup import DeviceSetupEngine as JaxEngine
from amgx_tpu.ops import spgemm as jax_spgemm

import amgx_tpu_torch as amgx
from amgx_tpu_torch.amg.aggregation.galerkin import galerkin_coarse
from amgx_tpu_torch.amg.device_setup import (DeviceSetupEngine, engine,
                                             engine_stats, reset_engine)
from amgx_tpu_torch.ops import spgemm

#: f64 products of the same terms in another order
RTOL = 1e-12

CLA = ("config_version=2, solver(out)=PCG, out:max_iters=60, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
       "amg:algorithm=CLASSICAL, amg:selector=PMIS, amg:interpolator=D1, "
       "amg:max_iters=1, amg:max_levels=6, amg:smoother(sm)=JACOBI_L1, "
       "sm:max_iters=1, amg:min_coarse_rows=16, "
       "amg:coarse_solver=DENSE_LU_SOLVER, amg:strength_threshold=0.2401")
AGG = ("config_version=2, solver(out)=PCG, out:max_iters=60, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
       "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, amg:max_iters=1, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")


@pytest.fixture(autouse=True)
def fresh_engine():
    reset_engine()
    yield
    reset_engine()


def poisson2d(n):
    I = sp.identity(n)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return sp.csr_matrix(sp.kron(I, T) + sp.kron(T, I))


def convection2d(n, beta=3.0):
    """Nonsymmetric upwinded convection-diffusion stencil."""
    I = sp.identity(n)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    U = sp.diags([-beta, beta, 0.0], [-1, 0, 1], shape=(n, n))
    return sp.csr_matrix(sp.kron(I, T) + sp.kron(T, I) + sp.kron(I, U))


def interp_like(A, seed, nc_frac=0.3):
    """A bounded-row rectangular P with an identity block."""
    rng = np.random.default_rng(seed)
    n = A.shape[0]
    nc = max(int(n * nc_frac), 2)
    rows = np.repeat(np.arange(n), 2)
    P = sp.csr_matrix((rng.standard_normal(2 * n),
                       (rows, rng.integers(0, nc, size=2 * n))),
                      shape=(n, nc))
    P = sp.csr_matrix(P + sp.csr_matrix(
        (np.ones(nc), (np.arange(nc), np.arange(nc))), shape=(n, nc)))
    P.sort_indices()
    return P


def rel(X, Y):
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    return abs(X - Y).max() / max(abs(Y).max(), 1e-300)


def same_pattern(X, Y):
    X, Y = sp.csr_matrix(X), sp.csr_matrix(Y)
    X.sort_indices()
    Y.sort_indices()
    return np.array_equal(X.indptr, Y.indptr) and \
        np.array_equal(X.indices, Y.indices)


def block_case(b, n=40):
    S = sp.random(n, n, 0.15, random_state=np.random.RandomState(b),
                  format="csr") + sp.identity(n)
    return sp.kron(sp.csr_matrix(S), np.arange(1, b * b + 1).reshape(b, b)
                   / b).tobsr(blocksize=(b, b))


# ------------------------------------------------------------- plans
@pytest.mark.parametrize("make_A", [lambda: poisson2d(20),
                                    lambda: convection2d(20)],
                         ids=["poisson", "convection"])
def test_galerkin_plan_matches_scipy_and_jax(make_A):
    A = make_A()
    A.sort_indices()
    P = interp_like(A, 1)
    plan = spgemm.build_galerkin_plan(A, P)
    import torch
    vAc = spgemm.galerkin_numeric(plan, torch.from_numpy(A.data),
                                  torch.from_numpy(P.data)).numpy()
    Ac = sp.csr_matrix((vAc, plan.Ac_indices, plan.Ac_indptr),
                       shape=plan.Ac_shape)
    ref = sp.csr_matrix(P.T @ A @ P)
    assert rel(Ac, ref) <= RTOL
    assert same_pattern(Ac, spgemm.galerkin_pattern(A, P))
    jplan = jax_spgemm.build_galerkin_plan(A, P)
    jv = np.array(jax_spgemm.galerkin_numeric(jplan, A.data, P.data))
    np.testing.assert_array_equal(plan.Ac_indices, jplan.Ac_indices)
    np.testing.assert_array_equal(vAc, jv[:jplan.nnz_Ac])


def test_spgemm_plan_matches_scipy_and_jax():
    import torch
    A = sp.random(150, 120, 0.06, random_state=np.random.RandomState(3),
                  format="csr")
    B = sp.random(120, 90, 0.08, random_state=np.random.RandomState(4),
                  format="csr")
    A.sort_indices()
    B.sort_indices()
    plan = spgemm.build_spgemm_plan(A, B)
    vC = spgemm.spgemm_numeric(plan, torch.from_numpy(A.data),
                               torch.from_numpy(B.data)).numpy()
    C = sp.csr_matrix((vC, plan.C_indices, plan.C_indptr),
                      shape=plan.C_shape)
    ref = sp.csr_matrix(A @ B)
    assert rel(C, ref) <= RTOL
    assert same_pattern(C, ref)
    jplan = jax_spgemm.build_spgemm_plan(A, B)
    jv = np.array(jax_spgemm.spgemm_numeric(jplan, A.data, B.data))
    np.testing.assert_array_equal(vC, jv[:jplan.nnz_C])


def test_transpose_perm_matches_jax():
    P = interp_like(poisson2d(9), 2)
    perm, R = spgemm.transpose_perm(P)
    jperm, jR = jax_spgemm.transpose_perm(P)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(P.data[perm], sp.csr_matrix(P.T).data)


# --------------------------------------------------- aggregation RAP
@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_aggregation_galerkin_matches_host_and_jax(b):
    rng = np.random.default_rng(b)
    if b == 1:
        A = convection2d(16)
        agg = rng.integers(0, 30, size=A.shape[0])
    else:
        A = block_case(b)
        agg = rng.integers(0, 9, size=A.shape[0] // b)
    out = DeviceSetupEngine().galerkin_agg(A, agg, b, dtype=np.float64)
    ref = galerkin_coarse(A, agg, b)
    assert rel(out, ref) <= RTOL
    want = JaxEngine().galerkin_agg(A, agg, b, dtype=np.float64)
    assert type(out) is type(want)
    np.testing.assert_array_equal(out.indptr, want.indptr)
    np.testing.assert_array_equal(out.indices, want.indices)
    np.testing.assert_array_equal(out.data, want.data)


# --------------------------------------------------- symbolic pattern
def test_keep_pattern_retains_cancellation_slots():
    """Two contributions to Ac's one slot cancel exactly: with
    ``keep_pattern`` the slot stays as an explicit zero."""
    A = sp.csr_matrix(np.array([[1.0, 1.0], [-1.0, -1.0]]))
    P = sp.csr_matrix(np.array([[1.0], [1.0]]))
    patt = spgemm.galerkin_pattern(A, P)
    ref = sp.csr_matrix(P.T @ A @ P)
    assert patt.nnz > ref.nnz
    eng = DeviceSetupEngine()
    kept = eng.galerkin_csr(A, P, dtype=np.float64, keep_pattern=True)
    pruned = eng.galerkin_csr(A, P, dtype=np.float64)
    assert kept.nnz == patt.nnz and kept.data[0] == 0
    assert pruned.nnz == ref.nnz


# ------------------------------------------------------ plan cache
def test_plan_cache_hit_skips_the_symbolic_pass(monkeypatch):
    builds = []
    real = spgemm.build_galerkin_plan
    monkeypatch.setattr(spgemm, "build_galerkin_plan",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    A = poisson2d(16)
    P = interp_like(A, 3)
    eng = DeviceSetupEngine()
    eng.galerkin_csr(A, P, dtype=np.float64)
    A2 = A.copy()
    A2.data = A2.data * 1.7 + 0.01
    Ac2 = eng.galerkin_csr(A2, P, dtype=np.float64)
    assert len(builds) == 1
    st = eng.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["builds"] == 1
    assert st["numeric_runs"] == 2
    assert rel(Ac2, sp.csr_matrix(P.T @ A2 @ P)) <= RTOL
    # another dtype is another plan
    eng.galerkin_csr(A2.astype(np.float32), P.astype(np.float32),
                     dtype=np.float32)
    assert len(builds) == 2


def test_plan_cache_lru_budget():
    A = poisson2d(10)
    plan_bytes = spgemm.build_galerkin_plan(A, interp_like(A, 0)).nbytes
    eng = DeviceSetupEngine(budget_bytes=int(2.5 * plan_bytes))
    for k in range(4):
        assert eng.galerkin_csr(A, interp_like(A, k),
                                dtype=np.float64) is not None
    st = eng.stats()
    assert st["plans"] == 2 and st["evictions"] == 2
    assert st["plan_bytes"] <= eng.budget_bytes
    # the least recently used went: P0 misses again, P3 hits
    eng.galerkin_csr(A, interp_like(A, 3), dtype=np.float64)
    assert eng.stats()["hits"] == 1
    eng.galerkin_csr(A, interp_like(A, 0), dtype=np.float64)
    assert eng.stats()["misses"] == 5


def test_each_decline_reason_is_counted():
    A = poisson2d(8)
    P = interp_like(A, 0)
    eng = DeviceSetupEngine(budget_bytes=1)
    assert eng.galerkin_csr(A, P, dtype=np.float64,
                            min_rows=10 ** 9) is None
    assert eng.galerkin_csr(sp.csr_matrix(A.shape), P,
                            dtype=np.float64) is None
    # the A·P terms alone pass a 1-byte budget: declined unbuilt
    assert eng.galerkin_csr(A, P, dtype=np.float64) is None
    assert eng.galerkin_csr(A, P, dtype=np.float16) is None
    assert eng.galerkin_agg(A, np.zeros(A.shape[0], dtype=np.int64),
                            dtype=np.float64, min_rows=10 ** 9) is None
    st = eng.stats()
    assert st["declines"] == {"small": 2, "empty": 1, "budget": 1,
                              "dtype:float16": 1}
    assert st["builds"] == 0 and st["plans"] == 0
    assert st["fallbacks"] == 5


def test_over_budget_plan_is_built_once():
    """A plan whose A·P terms fit the budget but whose R·(AP) terms do
    not: its build stops before the second product, it is declined, and
    the verdict is kept (a resetup does not build it again)."""
    A = poisson2d(8)
    P = interp_like(A, 0)
    n_ap = int(np.diff(P.indptr)[A.indices].sum())
    eng = DeviceSetupEngine(budget_bytes=8 * n_ap + 1)
    assert spgemm.build_galerkin_plan(A, P).nbytes > eng.budget_bytes
    for _ in range(2):
        assert eng.galerkin_csr(A, P, dtype=np.float64) is None
    st = eng.stats()
    assert st["declines"] == {"budget": 2}
    assert st["builds"] == 1 and st["plans"] == 0


def test_budget_is_per_call():
    """A call's budget bounds that call alone: a large one does not
    raise the engine's default, and a pattern declined under a small
    budget builds under a large one."""
    A = poisson2d(8)
    P = interp_like(A, 0)
    eng = DeviceSetupEngine(budget_bytes=1)
    assert eng.galerkin_csr(A, P, dtype=np.float64) is None
    assert eng.galerkin_csr(A, P, dtype=np.float64,
                            budget_bytes=1 << 30) is not None
    assert eng.budget_bytes == 1
    assert eng.galerkin_csr(A, interp_like(A, 1),
                            dtype=np.float64) is None
    st = eng.stats()
    assert st["declines"] == {"budget": 2}
    assert st["builds"] == 1 and st["plans"] == 1


# ------------------------------------------------- through the hierarchy
def _classical_pair(A, extra):
    cfg = CLA + extra
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(amgx_tpu.Matrix(A))
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(A, device="cpu"))
    return ref, slv


@pytest.mark.parametrize("extra", [", device_setup_min_rows=0",
                                   ", amg:structure_reuse_levels=-1"],
                         ids=["all-levels", "reuse-pattern"])
def test_classical_levels_match_jax_engine(extra, monkeypatch):
    """A host-loop classical setup of 4,096 rows and more: every level's
    product through the engine, each coarse operator within 1e-12 of the
    JAX package's (its engine, the same schedules) and the count
    equal."""
    monkeypatch.setenv("AMGX_NO_DEVICE_PIPELINE", "1")
    A = poisson2d(72)
    ref, slv = _classical_pair(A, extra)
    hj = ref.preconditioner.hierarchy
    hp = slv.preconditioner.hierarchy
    assert len(hp.levels) == len(hj.levels)
    for lp, lj in zip(hp.levels[1:] + [None], hj.levels[1:] + [None]):
        mp = lp.A if lp is not None else hp.coarsest
        mj = lj.A if lj is not None else hj.coarsest
        assert same_pattern(mp.host, mj.host)
        assert rel(mp.host, mj.host) <= RTOL
    st = engine_stats()
    assert st["numeric_runs"] >= 1
    b = np.ones(A.shape[0])
    assert slv.solve(b).iterations == ref.solve(b).iterations


def test_disabled_knob_never_consults_the_engine(monkeypatch):
    def boom():
        raise AssertionError("engine consulted with device_setup=0")
    monkeypatch.setattr("amgx_tpu_torch.amg.device_setup.engine", boom)
    A = poisson2d(72)
    slv = amgx.create_solver(AGG + ", device_setup=0")
    slv.setup(amgx.Matrix(A, device="cpu"))
    assert engine_stats() is None
    assert slv.solve(np.ones(A.shape[0])).iterations > 0


def test_aggregation_resetup_hits_the_plan_cache():
    """An aggregation resetup of an unchanged pattern: numeric passes
    only, no second symbolic pass."""
    A = poisson2d(72)
    cfg = AGG + ", amg:structure_reuse_levels=-1"
    slv = amgx.create_solver(cfg)
    m = amgx.Matrix(A, device="cpu")
    slv.setup(m)
    st0 = engine_stats()
    assert st0["builds"] >= 1 and st0["declines"].get("small", 0) >= 1
    m.replace_coefficients(A.data * 3.0)
    slv.resetup(m)
    st1 = engine_stats()
    assert slv.preconditioner.hierarchy.last_resetup == "host_replay"
    assert st1["builds"] == st0["builds"]
    assert st1["hits"] == st0["hits"] + st0["builds"]
    b = np.ones(A.shape[0])
    x = slv.solve(b).x.numpy()
    assert np.linalg.norm(b - 3.0 * (A @ x)) <= 1e-7 * np.linalg.norm(b)


def test_classical_resetup_plans_reuse_the_engine_plan(monkeypatch):
    """The classical resetup plans take the engine's cached schedules:
    one symbolic pass per level, not two."""
    monkeypatch.setenv("AMGX_NO_DEVICE_PIPELINE", "1")
    builds = []
    real = spgemm.build_galerkin_plan
    monkeypatch.setattr(spgemm, "build_galerkin_plan",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    from amgx_tpu_torch.amg.classical import resetup_device
    monkeypatch.setattr(resetup_device, "build_galerkin_plan",
                        lambda *a, **k: builds.append(2) or real(*a, **k))
    A = poisson2d(72)
    slv = amgx.create_solver(CLA + ", amg:structure_reuse_levels=-1, "
                             "device_setup_min_rows=0")
    slv.setup(amgx.Matrix(A, device="cpu"))
    h = slv.preconditioner.hierarchy
    assert h._cla_plans is not None
    assert builds == [1] * len(h.levels)


@pytest.mark.parametrize("algo", ["classical", "aggregation"])
def test_numeric_error_raises_without_fallback(algo, monkeypatch):
    """An error inside a numeric pass raises out of ``setup()``: no code
    path swallows it into the scipy product."""
    def broken(*a, **k):
        raise RuntimeError("numeric pass failed")
    monkeypatch.setattr(spgemm, "run_schedule", broken)
    scipy_calls = []
    from amgx_tpu_torch.amg import hierarchy
    monkeypatch.setattr(hierarchy, "galerkin_coarse",
                        lambda *a: scipy_calls.append(a))
    monkeypatch.setattr(hierarchy, "pad_to_symbolic",
                        lambda *a: scipy_calls.append(a))
    if algo == "classical":
        monkeypatch.setenv("AMGX_NO_DEVICE_PIPELINE", "1")
        slv = amgx.create_solver(CLA + ", device_setup_min_rows=0, "
                                 "amg:structure_reuse_levels=-1")
    else:
        slv = amgx.create_solver(AGG + ", device_setup_min_rows=0")
    with pytest.raises(RuntimeError, match="numeric pass failed"):
        slv.setup(amgx.Matrix(poisson2d(24), device="cpu"))
    assert scipy_calls == []
    assert engine().stats()["fallbacks"] == 0
