"""Fault injection (``utils/faultinject.py``) and the recovery ladder
(``solvers/recovery.py``) on the port against the JAX package on the
CPU, mirroring ``test_faultinject.py:49-233`` and ``test_recovery.py
:82-193``: the spec grammar and triggers, the seam points' return codes,
the solve-loop points' failure kinds and first bad iterations, and each
rung of the ladder — every case run through both packages on the same
numpy inputs, with equal outcomes (status, kind, recovery audit,
iterations; x to ``X_RTOL``)."""
import numpy as np
import pytest
import scipy.sparse as sp

import amgx_tpu as jx
from amgx_tpu.io import poisson5pt
from amgx_tpu.solvers import SolverFactory as JaxFactory
from amgx_tpu.utils import faultinject as jfi

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import RC, AMGXError, FailureKind, SolveStatus
from amgx_tpu_torch.solvers import SolverFactory
from amgx_tpu_torch.utils import faultinject

#: f64 solutions of the same solve in another summation order
X_RTOL = 1e-8

PCG = ("config_version=2, solver(s)=PCG, s:preconditioner(p)=BLOCK_JACOBI, "
       "p:max_iters=3, s:max_iters=200, s:monitor_residual=1, "
       "s:tolerance=1e-8, s:convergence=RELATIVE_INI, "
       "s:store_res_history=1")
LADDER = PCG + ", s:recovery_policy=AUTO"


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.reset()
    jfi.reset()
    yield
    faultinject.reset()
    jfi.reset()


def _A():
    return sp.csr_matrix(poisson5pt(16, 16))


def _pair(cfg, name="PCG", toplevel=False, A=None):
    """(JAX solver, port solver) of ``cfg``'s scope ``s``, set up."""
    A = _A() if A is None else A
    sj = JaxFactory.create(name, jx.AMGConfig(cfg), "s")
    sp_ = SolverFactory.create(name, amgx.AMGConfig(cfg), "s")
    if toplevel:
        sj._toplevel = sp_._toplevel = True
    sj.setup(jx.Matrix(A))
    sp_.setup(amgx.Matrix(A, device="cpu"))
    return sj, sp_, A


def _solve_both(sj, sp_, spec, b):
    """Each package's solve under the same freshly armed ``spec``."""
    jfi.configure(spec)
    rj = sj.solve(b)
    jfi.reset()
    faultinject.configure(spec)
    rp = sp_.solve(b)
    faultinject.reset()
    return rj, rp


def _same_outcome(rj, rp, x_rtol=X_RTOL):
    assert int(rp.status) == int(rj.status), (rp.status, rj.status)
    assert rp.iterations == rj.iterations, (rp.iterations, rj.iterations)
    assert (rp.failure is None) == (rj.failure is None)
    if rp.failure is not None:
        assert rp.failure.kind.value == rj.failure.kind.value
        assert rp.failure.iteration == rj.failure.iteration
    assert rp.recovery == rj.recovery
    xj = np.asarray(rj.x, dtype=np.float64)
    if np.all(np.isfinite(xj)):
        np.testing.assert_allclose(rp.x.numpy(), xj, rtol=0,
                                   atol=x_rtol * np.abs(xj).max())


# ------------------------------------------------------- spec and triggers
def test_spec_parsing_and_triggers():
    faultinject.configure("values_nan:iter=3:count=2, setup_error")
    assert faultinject.armed("values_nan")
    assert faultinject.param("values_nan", "iter") == 3
    assert faultinject.trace_mode() == ("values_nan", 3)
    assert faultinject.should_fire("values_nan")
    assert faultinject.should_fire("values_nan")
    assert not faultinject.should_fire("values_nan")
    assert faultinject.trace_mode() is None
    assert faultinject.should_fire("setup_error")    # count-less: always
    assert faultinject.stats()["values_nan"]["fired"] == 2
    faultinject.configure("values_nan:iter:3:count:2 oom:count:1")
    assert faultinject.trace_mode() == ("values_nan", 3)
    assert faultinject.armed("oom")


def test_unknown_and_later_slice_points():
    """A misspelt point fails loudly (ValueError, as upstream); the
    serving points (``worker_death`` in the worker pool's task guard,
    ``aot_corrupt`` in the warm-start store) and ``halo_exchange`` arm,
    from a spec string and from a dict."""
    with pytest.raises(ValueError, match="unknown fault-injection"):
        faultinject.configure("definitely_not_a_point:count=1")
    with pytest.raises(ValueError, match="unknown fault-injection"):
        SolverFactory.create("CG", amgx.AMGConfig(
            "config_version=2, solver(s)=CG, s:fault_inject=bogus"), "s")
    for point in ("worker_death", "aot_corrupt"):
        assert point in faultinject.POINTS
        faultinject.configure(f"{point}:count=1")
        assert faultinject.armed(point)
        assert faultinject.should_fire(point)
        assert not faultinject.should_fire(point)
        faultinject.configure({point: {"count": 1}})
        assert faultinject.armed(point)
        faultinject.reset()
    assert not faultinject.active()
    # halo_exchange has its seam (distributed.matrix.shard_vector)
    faultinject.configure("halo_exchange:count=1")
    assert faultinject.active()
    faultinject.reset()


def test_knob_arms_once_per_spec():
    """Solvers built from one config arm the plan once: a consumed count
    stays consumed; a changed spec re-arms."""
    cfg = amgx.AMGConfig("config_version=2, solver(s)=CG, "
                         "s:fault_inject=setup_error:count:1")
    s = SolverFactory.create("CG", cfg, "s")
    A = sp.csr_matrix(poisson5pt(8, 8))
    with pytest.raises(AMGXError):
        s.setup(amgx.Matrix(A, device="cpu"))
    SolverFactory.create("CG", cfg, "s").setup(amgx.Matrix(A, device="cpu"))


@pytest.mark.parametrize("point,rc", [
    ("setup_error", RC.CORE), ("upload_error", RC.CUDA_FAILURE),
    ("oom", RC.NO_MEMORY)])
def test_seam_points_raise_with_the_jax_codes(point, rc):
    A = sp.csr_matrix(poisson5pt(8, 8))
    cfg = ("config_version=2, solver(s)=CG, s:max_iters=50, "
           "s:monitor_residual=1, s:tolerance=1e-8, "
           "s:convergence=RELATIVE_INI")
    codes = []
    for fi, fac, mat in ((jfi, JaxFactory, jx.Matrix),
                         (faultinject, SolverFactory,
                          lambda a: amgx.Matrix(a, device="cpu"))):
        s = fac.create("CG", (jx if fi is jfi else amgx).AMGConfig(cfg),
                       "s")
        fi.configure(f"{point}:count=1")
        with pytest.raises(Exception) as ei:
            s.setup(mat(A))
        codes.append(int(ei.value.rc))
        s.setup(mat(A))          # one-shot
        assert s.solve(np.ones(A.shape[0])).status == 0
    assert codes == [int(rc), int(rc)]


# ------------------------------------------------------- solve-loop points
@pytest.mark.parametrize("spec", ["values_nan:iter=2:count=1",
                                  "krylov_zero:iter=3:count=1"])
def test_solve_loop_points_match_jax(spec):
    """A NaN-poisoned PCG stops early as ``nan_poison``; a zeroed ρ
    reports ``krylov_breakdown`` (FAILED) — at the JAX package's
    iteration; the next solve is clean."""
    sj, sp_, A = _pair(PCG)
    b = np.ones(A.shape[0])
    rj, rp = _solve_both(sj, sp_, spec, b)
    _same_outcome(rj, rp)
    want = FailureKind.NAN_POISON if "nan" in spec else \
        FailureKind.KRYLOV_BREAKDOWN
    assert rp.failure.kind == want
    assert rp.iterations <= int(spec.split("=")[1].split(":")[0]) + 5
    again = sp_.solve(b)
    assert again.status == SolveStatus.SUCCESS


# ------------------------------------------------------- the ladder
@pytest.mark.parametrize("case", [
    "restart_nan", "restart_stagnation", "resetup", "promote",
    "exhausted", "policy_off"])
def test_ladder_rung_matches_jax(case):
    """Each rung of ``test_recovery.py``: restart after a one-shot NaN
    and from a budget-starved partial iterate; escalation past skipped
    rungs to ``resetup``; ``promote`` of an f32 pack under an f64 host;
    a fault on every solve stopping at the attempt budget; the policy
    off.  The audit dicts equal the JAX package's, and so do the
    outcomes."""
    spec, cfg, top = "", LADDER, False
    if case == "restart_nan":
        spec = "values_nan:iter=2:count=1"
    elif case == "restart_stagnation":
        cfg = LADDER.replace("s:max_iters=200", "s:max_iters=12")
    elif case == "resetup":
        spec = "values_nan:iter=2:count=2"
    elif case == "promote":
        spec = "values_nan:iter=2:count=2"
        cfg = LADDER.replace("s:tolerance=1e-8", "s:tolerance=1e-5") \
            + ", s:tpu_matrix_dtype=float32"
        top = True
    elif case == "exhausted":
        spec = "values_nan:iter=1:count=99"
    else:
        spec = "values_nan:iter=2:count=1"
        cfg = PCG
    sj, sp_, A = _pair(cfg, toplevel=top)
    b = np.ones(A.shape[0])
    if spec:
        rj, rp = _solve_both(sj, sp_, spec, b)
    else:
        rj, rp = sj.solve(b), sp_.solve(b)
    # the promoted solve's x carries f32 inner solves to 1e-5: the two
    # packages' f32 sums part at that level
    _same_outcome(rj, rp, x_rtol=1e-5 if case == "promote" else X_RTOL)
    want = {"restart_nan": ("restart", "recovered"),
            "restart_stagnation": ("restart", "recovered"),
            "resetup": ("resetup", "recovered"),
            "promote": ("promote", "recovered"),
            "exhausted": (None, "exhausted"), "policy_off": None}[case]
    if want is None:
        assert rp.recovery is None and rp.status != SolveStatus.SUCCESS
        return
    action, outcome = want
    assert rp.recovery["outcome"] == outcome
    if action is not None:
        assert rp.recovery["action"] == action
        assert rp.status == SolveStatus.SUCCESS
        tol = 1e-5 if case == "promote" else 1e-7
        assert np.linalg.norm(b - A @ rp.x.numpy()) \
            / np.linalg.norm(b) < tol
    else:
        assert rp.recovery["attempts"] <= sp_.recovery_max_attempts
    if case == "resetup":
        # promote and conservative audit as skipped, burning nothing
        by = {e["action"]: e["outcome"] for e in sp_.recovery_log}
        assert by == {"restart": "failed", "promote": "skipped",
                      "conservative": "skipped", "resetup": "recovered"}
        assert rp.recovery["attempts"] == 2


def test_conservative_rung_swaps_the_smoother():
    """An AMG stack smoothed by Chebyshev: restart keeps failing, the
    conservative rung sets up a Jacobi twin and recovers; the user's
    solver keeps its config — as in the JAX package."""
    cfg = ("config_version=2, solver(s)=PCG, s:max_iters=200, "
           "s:monitor_residual=1, s:tolerance=1e-8, "
           "s:convergence=RELATIVE_INI, s:recovery_policy=AUTO, "
           "s:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
           "amg:selector=SIZE_2, amg:max_iters=1, "
           "amg:smoother(sm)=CHEBYSHEV, sm:max_iters=1, "
           "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")
    sj, sp_, A = _pair(cfg)
    rj, rp = _solve_both(sj, sp_, "values_nan:iter=2:count=2",
                         np.ones(A.shape[0]))
    assert rp.recovery == rj.recovery
    assert rp.recovery["action"] == "conservative"
    assert rp.status == SolveStatus.SUCCESS and rp.iterations == \
        rj.iterations
    assert sp_.cfg.get("smoother", "amg") == "CHEBYSHEV"


def test_krylov_classic_rung_for_a_ca_breakdown():
    """A breakdown in the CA recurrence falls back to CLASSIC first
    (rung 0), sticky on success — the JAX package's outcome."""
    cfg = LADDER + ", s:krylov_comm=CA"
    sj, sp_, A = _pair(cfg)
    rj, rp = _solve_both(sj, sp_, "krylov_zero:iter=3:count=1",
                         np.ones(A.shape[0]))
    assert rp.recovery == rj.recovery
    if rp.recovery is not None and rp.recovery["outcome"] == "recovered":
        assert rp.status == SolveStatus.SUCCESS
