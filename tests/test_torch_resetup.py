"""Values-only resetup (``Matrix.replace_coefficients``, ``Solver.resetup``,
``structure_reuse_levels``) of the port on the CPU against the JAX
package on the same matrices, f64 unless stated:

* GEO aggregation re-derived on the device (``"dia_device"``), equal
  counts and x within 1e-10 over two value drifts;
* the classical device refresh (``"classical_device"``): every coarse
  CSR within 1e-12 of the JAX package's refresh and within 1e-10 of the
  host Galerkin product with the frozen P; a value lit up outside the
  recorded pattern takes the host replay in both packages;
* partial reuse, SIZE_2 aggregation replayed on the host (Poisson 16² and
  the DFG operator), ``structure_reuse_levels=0`` as a fresh setup, the
  preconditioner instance kept, ``setup()`` still a full rebuild, the
  copy semantics of ``replace_coefficients``, and the errors of a
  structure that no longer holds;
* the CUDA-graph binding walk (``solvers/_bind.py``) on its own and
  through an AMG solver with a stand-in graph (a capture needs the card:
  tests/test_torch_cuda.py);
* a classical hierarchy carried from the JAX package with its recorded
  structure, resetup in both packages.

The JAX package's device setup engine runs its Galerkin products on
levels of 4096 rows and more (``device_setup_min_rows``): the DFG case
sets ``amg:device_setup=0`` on both sides, so both run the host
products; every other case stays below that size."""
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu
from amgx_tpu.io import poisson5pt as jax_poisson5pt
from amgx_tpu.io import poisson7pt as jax_poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch import interop
from amgx_tpu_torch.amg.cycles import build_cycle
from amgx_tpu_torch.errors import BadConfigurationError, SolveStatus
from amgx_tpu_torch.io import dfg_cylinder_pressure
from amgx_tpu_torch.solvers import _bind

#: f64 solutions of the two packages (the same arithmetic in other
#: summation orders)
X_RTOL = 1e-10
#: a device-refreshed coarse operator against the JAX package's refresh
REFRESH_RTOL = 1e-12
#: against the host Galerkin product with the frozen P (the JAX test's
#: bound, tests/test_classical_device.py:190-211)
RAP_RTOL = 1e-10

GEO = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
       "amg:cycle=CG, amg:cycle_iters=2, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=16, "
       "amg:coarse_solver=DENSE_LU_SOLVER")
CLA = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
       "amg:algorithm=CLASSICAL, amg:selector=PMIS, amg:interpolator=D2, "
       "amg:max_iters=1, amg:interp_max_elements=4, amg:max_row_sum=0.9, "
       "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
       "amg:coarse_solver=DENSE_LU_SOLVER, amg:strength_threshold=0.2401")
#: tests/test_amg.py:172-195
SIZE2_AMG = (
    "config_version=2, solver(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=100, amg:monitor_residual=1, "
    "amg:tolerance=1e-8, amg:convergence=RELATIVE_INI, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, "
    "amg:min_coarse_rows=8, amg:structure_reuse_levels=100, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
#: examples/amgx_mpi_capi_agg.py's stack (V-cycle: the JAX package
#: compiles a K-cycle unrolled, too slow at the DFG's depth here)
DFG_AGG = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=1, amg:cycle=V, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps=1, "
    "amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER, amg:structure_reuse_levels=-1, "
    "amg:device_setup=0")


def _drift(A, k, seed=3):
    """A_k = D_k·A·D_k, D_k = diag(1 + 0.1·u·k) (the loop of
    examples/amgx_resetup_timestepping.py)."""
    u = np.random.default_rng(seed).uniform(size=A.shape[0])
    d = sp.diags(1.0 + 0.1 * u * k)
    out = sp.csr_matrix(d @ A @ d)
    out.sort_indices()
    return out


def _pair(cfg, A):
    """The JAX package's solver and the port's, set up on ``A``, with
    their matrix handles."""
    jm = amgx_tpu.Matrix(A)
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(jm)
    pm = amgx.Matrix(A, device="cpu")
    slv = amgx.create_solver(cfg)
    slv.setup(pm)
    return ref, jm, slv, pm


def _solve_both(ref, slv, n):
    b = np.ones(n)
    want, got = ref.solve(b), slv.solve(b)
    assert got.status == SolveStatus.SUCCESS
    assert got.iterations == want.iterations
    w = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), w, rtol=X_RTOL,
                               atol=X_RTOL * np.abs(w).max())
    return got


def _relres(A, x):
    b = np.ones(A.shape[0])
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.linalg.norm(b - A @ x) / np.linalg.norm(b)


def _rel(a, b):
    d = abs(sp.csr_matrix(a) - sp.csr_matrix(b)).max()
    return d / max(abs(sp.csr_matrix(b)).max(), 1e-300)


def _stand_in_graph(amg_solver):
    """A stand-in for a captured graph: the key it would have and the
    slots it would read (a capture itself needs the card)."""
    amg_solver.graphs[("stand-in",)] = object()
    amg_solver._bind_snapshot()


# ---------------------------------------------------------- the matrix
@pytest.mark.parametrize("b", [1, 2])
def test_replace_coefficients_copies(b):
    """The caller's scipy matrix is left as it was; the new values are
    the port's and the JAX package's alike; the device caches go."""
    A = sp.csr_matrix(jax_poisson5pt(6, 5))
    if b > 1:
        A = sp.bsr_matrix(sp.kron(A, np.ones((b, b))).tocsr(),
                          blocksize=(b, b))
    before = A.copy()
    m = amgx.Matrix(A, block_dim=b, device="cpu")
    m.device()
    m._dinv_dev = (torch.float64, torch.ones(1))
    new = np.arange(1, A.nnz + 1, dtype=np.float64)
    m.replace_coefficients(new)
    assert (abs(A - before)).max() == 0
    assert m._device is None and m._dinv_dev is None and m._dia is None
    jm = amgx_tpu.Matrix(A, block_dim=b)
    jm.replace_coefficients(new)
    np.testing.assert_array_equal(m.host.toarray(), jm.host.toarray())
    assert m.device().n_rows == A.shape[0] // b


# -------------------------------------------------------------- GEO
def test_geo_resetup_refreshes_on_device_like_jax(monkeypatch):
    """GEO + ``structure_reuse_levels=-1``: two drifts, each re-derived
    on the device in both packages (the JAX package's host structured
    and pairwise numeric steps are made to fail, as in
    tests/test_regressions.py:139-179), equal counts, x within 1e-10."""
    from amgx_tpu.amg import hierarchy as H
    A = jax_poisson7pt(10, 9, 8)
    cfg = GEO + ", amg:structure_reuse_levels=-1"
    ref, jm, slv, pm = _pair(cfg, A)
    _solve_both(ref, slv, A.shape[0])

    def boom(*a, **k):
        raise AssertionError("host numeric step ran during resetup")

    monkeypatch.setattr(H.AMGHierarchy, "_structured_numeric",
                        staticmethod(boom))
    monkeypatch.setattr(H.AMGHierarchy, "_pairwise_numeric",
                        staticmethod(boom))
    h = slv.preconditioner.hierarchy
    for k in (1, 2):
        Ak = _drift(A, k)
        jm.replace_coefficients(Ak.data)
        pm.replace_coefficients(Ak.data)
        ref.resetup(jm)
        slv.resetup(pm)
        assert h.last_resetup == "dia_device"
        assert slv.preconditioner.hierarchy is h
        got = _solve_both(ref, slv, A.shape[0])
        assert _relres(Ak, got.x) <= 1e-8


def test_resetup_refreshes_values():
    """tests/test_regressions.py:52: without structure reuse a resetup
    is a fresh setup of the new values (f32 pack, f64 refinement)."""
    A = jax_poisson7pt(12, 12, 12)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(GEO)
    slv.setup(m)
    assert _relres(A, slv.solve(np.ones(A.shape[0])).x) < 1e-7
    m.replace_coefficients(A.data * 2.0)
    slv.resetup(m)
    assert slv.preconditioner.hierarchy.last_resetup == "fresh"
    assert _relres(A * 2.0, slv.solve(np.ones(A.shape[0])).x) < 1e-7


# -------------------------------------------------------- classical
def _coarse_csrs(h):
    mats = [lv.A for lv in h.levels[1:]] + [h.coarsest]
    return [sp.csr_matrix(m.host) for m in mats]


def test_classical_device_refresh_matches_jax():
    """The classical hierarchy of a reuse-configured setup (the host
    loop) is refreshed on the device in both packages: every coarse CSR
    within 1e-12 of the JAX package's, within 1e-10 of the host
    Galerkin chain of the frozen P, equal counts, x within 1e-10."""
    from amgx_tpu.amg import hierarchy as H
    A = jax_poisson7pt(12, 11, 10)
    cfg = CLA + ", amg:structure_reuse_levels=-1"
    ref, jm, slv, pm = _pair(cfg, A)
    h, jh = slv.preconditioner.hierarchy, ref.preconditioner.hierarchy
    assert h._cla_plans is not None and jh._cla_plans is not None
    assert [s[0] for s in h._structure] == \
        ["classical"] * len(h.levels)
    _solve_both(ref, slv, A.shape[0])
    used = {}
    orig = H.AMGHierarchy._reuse_classical_device

    def spy(self, cur, old):
        used["jax"] = r = orig(self, cur, old)
        return r

    A2 = _drift(A, 4)
    H.AMGHierarchy._reuse_classical_device = spy
    try:
        ref.resetup(amgx_tpu.Matrix(A2))
    finally:
        H.AMGHierarchy._reuse_classical_device = orig
    slv.resetup(amgx.Matrix(A2, device="cpu"))
    assert used["jax"] is True and h.last_resetup == "classical_device"
    got, want = _coarse_csrs(h), _coarse_csrs(jh)
    assert len(got) == len(want)
    cur = A2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.nnz == w.nnz
        assert _rel(g, w) <= REFRESH_RTOL, i
        P = h._structure[i][1][0]
        cur = sp.csr_matrix(sp.csr_matrix(P.T) @ cur @ P)
        assert _rel(g, cur) <= RAP_RTOL, i
    got = _solve_both(ref, slv, A.shape[0])
    assert _relres(A2, got.x) <= 1e-8


def test_classical_refresh_adds_without_scatter(monkeypatch):
    """The refresh sums in a fixed order: no ``index_add_`` or
    ``scatter_add_`` runs (on a CUDA tensor their order changes from run
    to run)."""
    A = jax_poisson7pt(9, 9, 9)
    slv = amgx.create_solver(CLA + ", amg:structure_reuse_levels=-1")
    slv.setup(amgx.Matrix(A, device="cpu"))

    def boom(*a, **k):
        raise AssertionError("an atomic scatter ran during the refresh")

    for name in ("index_add_", "scatter_add_", "index_add",
                 "scatter_add"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    slv.resetup(amgx.Matrix(_drift(A, 1), device="cpu"))
    assert slv.preconditioner.hierarchy.last_resetup == "classical_device"


def test_classical_value_outside_pattern_takes_host_replay():
    """A value lit up where the recorded fine pattern had no entry (a
    slot of the DIA pack the CSR never mapped): the frozen schedules
    cannot carry it, and both packages replay on the host."""
    from amgx_tpu.amg import hierarchy as H
    A = sp.lil_matrix(jax_poisson7pt(10, 10, 9))
    A[40, 41] = A[41, 40] = 0.0
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    cfg = CLA + ", amg:structure_reuse_levels=-1"
    ref, jm, slv, pm = _pair(cfg, A)
    A3 = sp.csr_matrix(jax_poisson7pt(10, 10, 9))
    used = {}
    orig = H.AMGHierarchy._reuse_classical_device

    def spy(self, cur, old):
        used["jax"] = r = orig(self, cur, old)
        return r

    H.AMGHierarchy._reuse_classical_device = spy
    try:
        ref.resetup(amgx_tpu.Matrix(A3))
    finally:
        H.AMGHierarchy._reuse_classical_device = orig
    slv.resetup(amgx.Matrix(A3, device="cpu"))
    h, jh = slv.preconditioner.hierarchy, ref.preconditioner.hierarchy
    assert used["jax"] is False and h.last_resetup == "host_replay"
    for g, w in zip(_coarse_csrs(h), _coarse_csrs(jh)):
        assert g.nnz == w.nnz and _rel(g, w) <= REFRESH_RTOL
    _solve_both(ref, slv, A.shape[0])


def test_reuse_configured_classical_takes_the_host_loop():
    """Above the pipeline's tail (4096 rows) a reuse-configured
    classical setup leaves the device pipeline: its levels are host
    classical levels, whose plans a resetup refreshes."""
    A = jax_poisson7pt(18, 18, 18)
    slv = amgx.create_solver(CLA + ", amg:structure_reuse_levels=-1")
    slv.setup(amgx.Matrix(A, device="cpu"))
    h = slv.preconditioner.hierarchy
    assert [lv.Ad.fmt for lv in h.levels][:2] == ["dia", "ell"]
    assert {s[0] for s in h._structure} == {"classical"}
    assert h._cla_plans is not None


# ----------------------------------------------- partial and no reuse
@pytest.mark.parametrize("case", ["geo", "classical"])
def test_partial_reuse_matches_jax(case):
    """``structure_reuse_levels=1``: the first level keeps its
    structure, the rest is coarsened anew, in both packages."""
    if case == "geo":
        A, cfg, path = jax_poisson7pt(10, 9, 8), GEO, "dia_device"
    else:
        A, cfg, path = jax_poisson7pt(12, 11, 10), CLA, "host_replay"
    ref, jm, slv, pm = _pair(cfg + ", amg:structure_reuse_levels=1", A)
    A2 = _drift(A, 3)
    ref.resetup(amgx_tpu.Matrix(A2))
    slv.resetup(amgx.Matrix(A2, device="cpu"))
    h, jh = slv.preconditioner.hierarchy, ref.preconditioner.hierarchy
    assert h.last_resetup == path
    assert [lv.level_stats()[0] for lv in h.levels] == \
        [lv.A.n_block_rows for lv in jh.levels]
    got = _solve_both(ref, slv, A.shape[0])
    assert _relres(A2, got.x) <= 1e-8


def test_reuse_zero_is_a_fresh_setup():
    """``structure_reuse_levels=0``: a resetup coarsens afresh into the
    same hierarchy object, as a fresh solver does, bit for bit."""
    A = jax_poisson7pt(12, 11, 10)
    ref, jm, slv, pm = _pair(CLA, A)
    h = slv.preconditioner.hierarchy
    A2 = _drift(A, 2)
    ref.resetup(amgx_tpu.Matrix(A2))
    slv.resetup(amgx.Matrix(A2, device="cpu"))
    assert slv.preconditioner.hierarchy is h and h.last_resetup == "fresh"
    got = _solve_both(ref, slv, A.shape[0])
    fresh = amgx.create_solver(CLA)
    fresh.setup(amgx.Matrix(A2, device="cpu"))
    want = fresh.solve(np.ones(A.shape[0]))
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)


# ------------------------------------------------- aggregation replay
def test_size2_aggregation_reuse_matches_jax():
    """tests/test_amg.py:172-195: SIZE_2 aggregates kept, each level's
    Galerkin product replayed on the host, on Poisson 16²."""
    A = sp.csr_matrix(jax_poisson5pt(16, 16))
    ref, jm, slv, pm = _pair(SIZE2_AMG, A)
    shapes = [lv.Ad.n_rows for lv in slv.hierarchy.levels]
    ref.resetup(amgx_tpu.Matrix(A * 2.0))
    slv.resetup(amgx.Matrix(A * 2.0, device="cpu"))
    assert slv.hierarchy.last_resetup == "host_replay"
    assert [lv.Ad.n_rows for lv in slv.hierarchy.levels] == shapes
    got = _solve_both(ref, slv, A.shape[0])
    assert _relres(A * 2.0, got.x) <= 1e-6


@pytest.mark.usefixtures("one_thread")
def test_dfg_aggregation_reuse_matches_jax():
    """The DFG operator at ny = 32, SIZE_2, two drifts replayed on the
    host in both packages (``amg:device_setup=0`` on both sides)."""
    A = dfg_cylinder_pressure(32)
    ref, jm, slv, pm = _pair(DFG_AGG, A)
    h = slv.preconditioner.hierarchy
    aggs = [lv.aggregates.clone() for lv in h.levels]
    _solve_both(ref, slv, A.shape[0])
    for k in (1, 2):
        Ak = _drift(A, k)
        jm.replace_coefficients(Ak.data)
        pm.replace_coefficients(Ak.data)
        ref.resetup(jm)
        slv.resetup(pm)
        assert h.last_resetup == "host_replay"
        assert all(torch.equal(a, lv.aggregates)
                   for a, lv in zip(aggs, h.levels))
        got = _solve_both(ref, slv, A.shape[0])
        assert _relres(Ak, got.x) <= 1e-8


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- solver lifecycle
def test_resetup_keeps_the_preconditioner_instance():
    """tests/test_solvers.py:161-193: the preconditioner instance and its
    hierarchy survive a resetup, which solves the new operator."""
    A = sp.csr_matrix(jax_poisson7pt(12, 12, 12))
    cfg = GEO.replace("amg:presweeps=2", "amg:presweeps=1") + \
        ", amg:structure_reuse_levels=99"
    ref, jm, slv, pm = _pair(cfg, A)
    _solve_both(ref, slv, A.shape[0])
    pre, h = slv.preconditioner, slv.preconditioner.hierarchy
    A2 = sp.csr_matrix(A * 1.75)
    ref.resetup(amgx_tpu.Matrix(A2))
    slv.resetup(amgx.Matrix(A2, device="cpu"))
    assert slv.preconditioner is pre and pre.hierarchy is h
    got = _solve_both(ref, slv, A.shape[0])
    assert _relres(A2, got.x) <= 1e-8


def test_plain_setup_is_full_rebuild_after_solve():
    """tests/test_solvers.py:195-222: ``setup()`` on another size after
    a solve builds a new hierarchy."""
    cfg = GEO + ", amg:structure_reuse_levels=99"
    slv = amgx.create_solver(cfg)
    A1 = sp.csr_matrix(jax_poisson7pt(8, 8, 8))
    slv.setup(amgx.Matrix(A1, device="cpu"))
    assert slv.solve(np.ones(A1.shape[0])).status == SolveStatus.SUCCESS
    pre, h = slv.preconditioner, slv.preconditioner.hierarchy
    A2 = sp.csr_matrix(jax_poisson7pt(10, 10, 10))
    slv.setup(amgx.Matrix(A2, device="cpu"))
    assert slv.preconditioner is not pre
    assert slv.preconditioner.hierarchy is not h
    res = slv.solve(np.ones(A2.shape[0]))
    assert res.status == SolveStatus.SUCCESS and _relres(A2, res.x) <= 1e-8


def test_lit_up_zero_diagonal_raises():
    """tests/test_regressions.py:204-228: a stored all-zero diagonal that
    lights up no longer admits the recorded structured decode."""
    from amgx_tpu.amg.pairwise import dia_to_scipy
    A = jax_poisson7pt(8, 8, 8)
    n = A.shape[0]
    offs, vals = A._amgx_dia
    offs2 = list(offs[:4]) + [4] + list(offs[4:])
    vals2 = np.insert(vals, 4, np.zeros(n), axis=0)
    A._amgx_dia = (offs2, vals2)
    cfg = GEO + ", amg:structure_reuse_levels=-1"
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(amgx_tpu.Matrix(A))
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(A, device="cpu"))
    assert slv.preconditioner.hierarchy._structure[0][0] == "structured"
    vals3 = vals2.copy()
    vals3[4, 100:110] = -0.25
    A3 = dia_to_scipy(offs2, vals3, n)
    A3._amgx_dia = (offs2, vals3)
    with pytest.raises(amgx_tpu.AMGXError):
        ref.resetup(amgx_tpu.Matrix(A3))
    with pytest.raises(BadConfigurationError, match="structured stencil"):
        slv.resetup(amgx.Matrix(A3, device="cpu"))
    assert slv.preconditioner.hierarchy._structure is None


def test_block_matrix_to_dia_hierarchy_raises():
    """tests/test_regressions.py:114-128: a block matrix handed to the
    resetup of a DIA hierarchy raises."""
    A = jax_poisson7pt(10, 10, 10)
    cfg = GEO + ", amg:structure_reuse_levels=-1"
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(amgx_tpu.Matrix(A))
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(A, device="cpu"))
    B = sp.kron(jax_poisson7pt(5, 5, 5), sp.identity(2)).tocsr()
    with pytest.raises(Exception):
        ref.resetup(amgx_tpu.Matrix(B, block_dim=2))
    with pytest.raises(BadConfigurationError, match="no diagonal"):
        slv.resetup(amgx.Matrix(B, block_dim=2, device="cpu"))


# ------------------------------------------------ the binding walk
def _tree(vals, diag=None, lam=1.0, extra=None):
    d = {"vals": vals, "diag": vals[1] if diag is None else diag,
         "lam": lam, "same": [vals]}
    if extra is not None:
        d["extra"] = extra
    return types.SimpleNamespace(pack=d)


def test_bind_keeps_and_points_the_new_tree_at_the_old_storage():
    old_vals = torch.zeros(3, 4, dtype=torch.float64)
    old = _tree(old_vals)
    snap = _bind.collect(old)
    new_vals = torch.arange(12, dtype=torch.float64).reshape(3, 4)
    new = _tree(new_vals)
    res = _bind.rebind(snap, _bind.collect(new, {s.path: s for s in snap}))
    assert res.kept and res.copied == 2 and res.tensors == 2
    assert new.pack["vals"] is old_vals and new.pack["same"][0] is old_vals
    assert torch.equal(old_vals, torch.arange(12.0).reshape(3, 4).double())
    assert new.pack["diag"].data_ptr() == old_vals[1].data_ptr()


@pytest.mark.parametrize("change,reason", [
    (dict(vals=torch.ones(3, 5)), "became"),
    (dict(lam=2.0), "a value a graph may hold"),
    (dict(diag=torch.ones(4)), "shares storage"),
])
def test_bind_drops(change, reason):
    """A shape change, a value a graph may hold, or storage no longer
    shared alike: the graphs go and the reason names the slot."""
    snap = _bind.collect(_tree(torch.zeros(3, 4)))
    kw = dict(vals=torch.zeros(3, 4))
    kw.update(change)
    res = _bind.rebind(snap, _bind.collect(_tree(**kw)))
    assert not res.kept and reason in res.reason and "pack" in res.reason


def test_bind_drops_a_slot_without_counterpart():
    """A lazy cache the old tree made and the new lacks."""
    snap = _bind.collect(_tree(torch.zeros(3, 4), extra=torch.zeros(2)))
    res = _bind.rebind(snap, _bind.collect(_tree(torch.zeros(3, 4))))
    assert not res.kept
    assert res.reason == "pack['extra']: no counterpart in the new tree"


def test_amg_graphs_kept_on_values_dropped_on_shape():
    """Through the solver (a stand-in graph): kept across a value
    change, the kept tensors the same objects; dropped, with its reason,
    across a change of size under ``structure_reuse_levels=0``."""
    A = jax_poisson7pt(12, 12, 12)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(GEO + ", amg:structure_reuse_levels=-1")
    slv.setup(m)
    pre = slv.preconditioner
    _stand_in_graph(pre)
    fine_vals = m.device().vals
    coarse_vals = pre.hierarchy.levels[1].A.device().vals
    for k in (1, 2):
        # the graphs read the storage of the first tree at every step
        A2 = _drift(A, k)
        m.replace_coefficients(A2.data)
        slv.resetup(m)
        assert pre.rebind["graphs_kept"] == k and pre.graphs
        assert m.device().vals is fine_vals
        assert pre.hierarchy.levels[1].A.device().vals is coarse_vals
        assert torch.equal(fine_vals, torch.from_numpy(
            m.dia_cache()[1].astype(np.float32)))
        assert _relres(A2, slv.solve(np.ones(A.shape[0])).x) <= 1e-8
    slv2 = amgx.create_solver(GEO)
    slv2.setup(amgx.Matrix(A, device="cpu"))
    _stand_in_graph(slv2.preconditioner)
    slv2.resetup(amgx.Matrix(jax_poisson7pt(12, 12, 10), device="cpu"))
    rb = slv2.preconditioner.rebind
    assert rb["graphs_dropped"] == 1 and not slv2.preconditioner.graphs
    assert "became" in rb["drops"][0]


def test_old_handle_keeps_its_values_when_the_graphs_are_kept():
    """A resetup on another ``Matrix`` handle: the graphs keep the old
    handle's pack storage, which now holds the new values, so the old
    handle drops its device caches and packs its own values again."""
    A = jax_poisson7pt(10, 10, 10)
    # an f32 pack: a CPU pack in the host dtype may share the host
    # arrays' memory (a card pack never does)
    m0 = amgx.Matrix(A, device="cpu")
    m0.device_dtype = np.float32
    slv = amgx.create_solver(GEO + ", amg:structure_reuse_levels=-1")
    slv.setup(m0)
    _stand_in_graph(slv.preconditioner)
    kept = m0.device().vals
    m2 = amgx.Matrix(_drift(A, 1), device="cpu")
    m2.device_dtype = np.float32
    slv.resetup(m2)
    assert slv.preconditioner.rebind["graphs_kept"] == 1
    assert m2.device().vals is kept
    assert m0._device is None
    np.testing.assert_array_equal(
        m0.device().vals.numpy(),
        np.asarray(A._amgx_dia[1], dtype=np.float32))
    assert not torch.equal(m0.device().vals, kept)


def test_amg_graphs_dropped_for_a_value_taken_by_value():
    """A Chebyshev smoother's λ estimates move with the values; a graph
    holds the coefficients it took at capture, so the graphs go."""
    A = jax_poisson7pt(10, 10, 10)
    cfg = GEO.replace("amg:smoother(sm)=BLOCK_JACOBI",
                      "amg:smoother(sm)=CHEBYSHEV_POLY") + \
        ", amg:structure_reuse_levels=-1"
    slv = amgx.create_solver(cfg)
    m = amgx.Matrix(A, device="cpu")
    slv.setup(m)
    slv.solve(np.ones(A.shape[0]))
    _stand_in_graph(slv.preconditioner)
    m.replace_coefficients(_drift(A, 2).data)
    slv.resetup(m)
    rb = slv.preconditioner.rebind
    assert rb["graphs_dropped"] == 1 and "smoother" in rb["drops"][0]


# ------------------------------------------------- carried across
def test_carried_classical_hierarchy_resetup_matches_jax():
    """A classical hierarchy carried from the JAX package with its
    recorded structure (the frozen P of each level): both packages
    resetup, and the coarse operators agree within 1e-12."""
    from amgx_tpu_torch.core.matrix import ell_host_arrays
    A = jax_poisson7pt(10, 10, 10)
    cfg = CLA + ", amg:structure_reuse_levels=-1"
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    ref.setup(amgx_tpu.Matrix(A))
    jh = ref.preconditioner.hierarchy

    def spec(M):
        M = sp.csr_matrix(M)
        cols, vals, diag = ell_host_arrays(M, np.float64)
        return dict(fmt="ell", cols=cols, vals=vals, n_cols=M.shape[1],
                    diag=diag)

    levels = [dict(A=spec(lv.A.host), P=spec(P), R=spec(P.T))
              for lv, (_, (P,)) in zip(jh.levels, jh._structure)]
    pcfg = amgx.AMGConfig(cfg)
    ph = interop.classical_hierarchy_from_numpy(
        pcfg, "amg", levels, spec(jh.coarsest.host), device="cpu",
        structure=jh._structure)
    amg = amgx.SolverFactory.create("AMG", pcfg, "amg")
    amg.hierarchy = ph
    amg._cycle = build_cycle(ph)
    A2 = _drift(A, 3)
    ref.resetup(amgx_tpu.Matrix(A2))
    amg.resetup(amgx.Matrix(A2, device="cpu"))
    assert ph.last_resetup == "host_replay"
    got, want = _coarse_csrs(ph), _coarse_csrs(jh)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) <= REFRESH_RTOL
