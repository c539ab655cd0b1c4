"""End-to-end parity of the headline stack (FGMRES restart 6 +
GEO-aggregation AMG, K-cycle, block Jacobi 2+2, dense LU) between the
port on the CPU and the JAX package: iteration counts, residual
histories, true residuals, and one preconditioner application on a
hierarchy carried across with ``interop``."""
import numpy as np
import pytest
import torch

import amgx_tpu
from amgx_tpu.io import poisson7pt as jax_poisson7pt
from amgx_tpu.io import poisson7pt_device as jax_poisson7pt_device

import amgx_tpu_torch
from amgx_tpu_torch import interop
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
from amgx_tpu_torch.ops.spmv import DISPATCH

#: f64 residual histories: the same arithmetic in another summation
#: order (BLAS dots, Gram–Schmidt products) — rounding at 1e-16 grows
#: through the AMG cycles to far below this
HIST_RTOL = 1e-6
#: one AMG cycle in f64 on identical hierarchy arrays
APPLY_RTOL = 1e-10

CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
       "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
       "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
       "amg:cycle=CG, amg:cycle_iters=2, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
       "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
       "amg:coarse_solver=DENSE_LU_SOLVER, out:store_res_history=1")


def _true_relres(dims, x):
    A = jax_poisson7pt(*dims)
    b = np.ones(A.shape[0])
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    return np.linalg.norm(b - A @ x.astype(np.float64)) / np.linalg.norm(b)


@pytest.mark.parametrize("dims,dtype,iters", [
    ((16, 16, 16), np.float64, 11),
    ((32, 32, 32), np.float64, 12),
    ((16, 16, 16), np.float32, 14),      # f32 pack + f64 refinement
    ((32, 32, 32), np.float32, 16),
    ((12, 10, 9), np.float64, 9),
])
def test_headline_matches_jax(dims, dtype, iters):
    n = int(np.prod(dims))
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(CFG))
    ref.setup(jax_poisson7pt_device(*dims, device_dtype=dtype))
    r_ref = ref.solve(np.ones(n))
    slv = amgx_tpu_torch.create_solver(CFG)
    slv.setup(poisson7pt_device(*dims, device_dtype=dtype, device="cpu"))
    before = DISPATCH["dia/slices"]
    r = slv.solve(np.ones(n))
    assert DISPATCH["dia/slices"] > before and DISPATCH["dia/kernel"] == 0
    assert r_ref.iterations == iters
    assert r.iterations == r_ref.iterations
    assert r.status == SolveStatus.SUCCESS
    assert _true_relres(dims, r.x) <= 1e-8
    if dtype == np.float64:
        np.testing.assert_allclose(r.residual_history,
                                   np.asarray(r_ref.residual_history),
                                   rtol=HIST_RTOL)
        np.testing.assert_allclose(r.residual_norm,
                                   np.asarray(r_ref.residual_norm),
                                   rtol=HIST_RTOL)


@pytest.mark.parametrize("dtype,iters", [(np.float64, 11),
                                         (np.float32, 14)])
def test_host_matrix_path_matches(dtype, iters):
    """Matrix(poisson7pt(n)) takes the host-arrays route through the same
    plan and derive, in both packages."""
    jm = amgx_tpu.Matrix(jax_poisson7pt(16, 16, 16))
    jm.device_dtype = dtype
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(CFG))
    ref.setup(jm)
    r_ref = ref.solve(np.ones(16 ** 3))
    m = amgx_tpu_torch.Matrix(poisson7pt(16, 16, 16), device="cpu")
    m.device_dtype = dtype
    slv = amgx_tpu_torch.create_solver(CFG)
    slv.setup(m)
    r = slv.solve(np.ones(16 ** 3))
    assert r.iterations == r_ref.iterations == iters
    assert _true_relres((16, 16, 16), r.x) <= 1e-8
    if dtype == np.float64:
        np.testing.assert_allclose(r.residual_history,
                                   np.asarray(r_ref.residual_history),
                                   rtol=HIST_RTOL)


def _level_arrays(h):
    levels = []
    for lv in h.levels:
        Ad = lv.A.device()
        d = dict(kind=lv.kind, offsets=list(Ad.dia_offsets),
                 vals=np.asarray(Ad.vals), diag=np.asarray(Ad.diag),
                 dinv=np.asarray(lv.smoother.dinv))
        if lv.kind == "structured":
            d.update(dims=lv.dims, cdims=lv.cdims)
        else:
            d.update(n=lv.n_fine)
        levels.append(d)
    c = h.coarsest.device()
    return levels, dict(offsets=list(c.dia_offsets), vals=np.asarray(c.vals))


@pytest.mark.parametrize("cycle", ["CG", "V", "W", "F", "CGF"])
def test_preconditioner_apply_on_carried_hierarchy(cycle):
    """One AMG application of every cycle flavour on the JAX package's
    hierarchy arrays, carried across with ``interop``."""
    import jax.numpy as jnp
    dims = (16, 16, 16)
    text = CFG.replace("amg:cycle=CG", f"amg:cycle={cycle}")
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(text))
    ref.setup(jax_poisson7pt_device(*dims, device_dtype=np.float64))
    levels, coarsest = _level_arrays(ref.preconditioner.hierarchy)
    cfg = amgx_tpu_torch.AMGConfig(text)
    h = interop.hierarchy_from_numpy(cfg, "amg", levels, coarsest,
                                     device="cpu")
    amg = amgx_tpu_torch.SolverFactory.create("AMG", cfg, "amg")
    amg.hierarchy = h
    from amgx_tpu_torch.amg.cycles import build_cycle
    amg._cycle = build_cycle(h)
    b = np.random.default_rng(7).standard_normal(int(np.prod(dims)))
    want = np.asarray(ref.preconditioner.apply(jnp.asarray(b)))
    got = amg.apply(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=APPLY_RTOL,
                               atol=APPLY_RTOL * np.max(np.abs(want)))


def test_interop_matrix_solves():
    offs, vals = amgx_tpu_torch.io.poisson7pt_dia(12, 10, 9)
    m = interop.matrix_from_numpy(offs, vals, grid_dims=(9, 10, 12),
                                  device_dtype=np.float32, device="cpu")
    slv = amgx_tpu_torch.create_solver(CFG)
    slv.setup(m)
    r = slv.solve(np.ones(1080))
    assert r.status == SolveStatus.SUCCESS
    assert _true_relres((12, 10, 9), r.x) <= 1e-8


@pytest.mark.parametrize("cfg", [
    CFG + ", compile_cache_dir=cache",
    CFG + ", aot_store_dir=store",
    CFG + ", out:compile_cache_dir=cache",
    CFG + ", amg:aot_store_dir=store",
])
def test_later_slice_features_raise(cfg, tmp_path, monkeypatch):
    """The warm-start knobs of the serving slice work, on the top-level
    solver and in a nested scope: ``compile_cache_dir`` is where the
    kernels build and are found (``native.BUILD_DIR``),
    ``aot_store_dir`` the store of the setup engine's plans; the solve
    is the one without them.  (They raised, naming their slice, until
    it was ported.)"""
    from amgx_tpu_torch import native
    from amgx_tpu_torch.serve import aot
    monkeypatch.chdir(tmp_path)
    try:
        slv = amgx_tpu_torch.create_solver(cfg)
        slv.setup(poisson7pt_device(8, 8, 8, device_dtype=np.float64,
                                    device="cpu"))
        r = slv.solve(np.ones(512))
        if "compile_cache_dir" in cfg:
            assert native.BUILD_DIR == (tmp_path / "cache").resolve()
        else:
            assert aot.get_store().root == str(tmp_path / "store")
    finally:
        native.set_build_dir("")
        aot.reset_store()
        amgx_tpu_torch.telemetry.runstate.reset()
    ref = amgx_tpu_torch.create_solver(CFG)
    ref.setup(poisson7pt_device(8, 8, 8, device_dtype=np.float64,
                                device="cpu"))
    want = ref.solve(np.ones(512))
    assert r.status == SolveStatus.SUCCESS
    assert r.iterations == want.iterations
    assert torch.equal(r.x, want.x)


@pytest.mark.parametrize("knob", [
    ", out:matrix_reorder=RCM",
    ", out:scaling=DIAGONAL_SYMMETRIC",
    ", amg:amg_host_levels_rows=100",
])
def test_solve_boundary_knobs_match_jax(knob):
    """The knobs that raised before their slice, on the headline stack at
    8³ (f64) against the JAX package: equal iterations, histories to
    ``HIST_RTOL``, x to 1e-8 relative (RCM solves in permuted space and
    un-permutes x; the scaled solve monitors the scaled residual; the
    host levels compute on the CPU, which here is the device too)."""
    m_j = amgx_tpu.Matrix(jax_poisson7pt(8, 8, 8))
    ref = amgx_tpu.create_solver(amgx_tpu.AMGConfig(CFG + knob))
    ref.setup(m_j)
    r_ref = ref.solve(np.ones(512))
    m = amgx_tpu_torch.Matrix(poisson7pt(8, 8, 8), device="cpu")
    slv = amgx_tpu_torch.create_solver(CFG + knob)
    slv.setup(m)
    r = slv.solve(np.ones(512))
    assert r.status == SolveStatus.SUCCESS
    assert r.iterations == r_ref.iterations
    np.testing.assert_allclose(r.residual_history,
                               np.asarray(r_ref.residual_history),
                               rtol=HIST_RTOL)
    xr = np.asarray(r_ref.x, dtype=np.float64)
    np.testing.assert_allclose(r.x.numpy(), xr, rtol=0,
                               atol=1e-8 * np.abs(xr).max())


def _setup_lines(pkg, make, cfg, capsys):
    slv = pkg.create_solver(pkg.AMGConfig(cfg))
    capsys.readouterr()
    slv.setup(make())
    return capsys.readouterr().out.splitlines()


@pytest.fixture
def verbosity():
    """Both packages' output gates back at their default afterwards."""
    from amgx_tpu.utils import logging as jlog
    from amgx_tpu_torch.utils import logging as plog
    yield jlog, plog
    jlog.set_verbosity(3)
    plog.set_verbosity(3)


def _jax_matrix():
    return amgx_tpu.Matrix(jax_poisson7pt(8, 8, 8))


def _port_matrix():
    return amgx_tpu_torch.Matrix(poisson7pt(8, 8, 8), device="cpu")


def test_print_grid_stats_matches_jax(capsys, verbosity):
    """``print_grid_stats``: the grid table at verbosity 2, the JAX
    package's lines."""
    cfg = CFG + ", amg:print_grid_stats=1"
    want = _setup_lines(amgx_tpu, _jax_matrix, cfg, capsys)
    got = _setup_lines(amgx_tpu_torch, _port_matrix, cfg, capsys)
    assert any("Number of Levels" in ln for ln in got)
    assert got == want
    # below verbosity 2 the table is gated off in both packages
    cfg1 = cfg + ", verbosity_level=1"
    assert _setup_lines(amgx_tpu_torch, _port_matrix, cfg1, capsys) == \
        _setup_lines(amgx_tpu, _jax_matrix, cfg1, capsys) == []


def test_print_solve_stats_and_timings_match_jax(capsys, verbosity):
    """``print_solve_stats`` and ``obtain_timings`` print the JAX
    package's lines (residuals to the printed digits; the seconds
    masked), through the same gated output."""
    import re
    cfg = CFG + ", out:print_solve_stats=1, out:obtain_timings=1"

    def lines(pkg, make):
        slv = pkg.create_solver(pkg.AMGConfig(cfg))
        slv.setup(make())
        capsys.readouterr()
        slv.solve(np.ones(512))
        out = capsys.readouterr().out.splitlines()
        timed = ("Total Time", "setup:", "solve:", "solve(per")
        return [re.sub(r"\d+\.\d+", "<t>", ln)
                if ln.strip().startswith(timed) else ln for ln in out]

    want = lines(amgx_tpu, _jax_matrix)
    got = lines(amgx_tpu_torch, _port_matrix)
    assert any("Total Iterations" in ln for ln in got)
    assert any(ln.startswith("Total Time") for ln in got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gs, ws = g.split(), w.split()
        assert len(gs) == len(ws), (g, w)
        for a, b in zip(gs, ws):
            try:
                assert float(a) == pytest.approx(float(b), rel=1e-5), (g, w)
            except ValueError:
                assert a == b, (g, w)


def test_verbosity_level_gates_the_output(capsys, verbosity):
    """An explicit ``verbosity_level`` sets the gate as the JAX package
    does (0 silences even the level-1 solve statistics); the registry
    default leaves an application's setting alone."""
    jlog, plog = verbosity
    cfg = CFG + ", out:print_solve_stats=1, verbosity_level=0"
    for pkg, make in ((amgx_tpu, _jax_matrix),
                      (amgx_tpu_torch, _port_matrix)):
        slv = pkg.create_solver(pkg.AMGConfig(cfg))
        slv.setup(make())
        capsys.readouterr()
        slv.solve(np.ones(512))
        assert capsys.readouterr().out == ""
    assert plog.get_verbosity() == jlog.get_verbosity() == 0
    plog.set_verbosity(2)
    amgx_tpu_torch.create_solver(CFG)
    assert plog.get_verbosity() == 2


def test_operator_past_dia_budget_raises():
    """Past the DIA budget a matrix packs as ELL; past the ELL width
    budget too (a row of more than 2048 entries) the ELL pack is refused
    and it packs as CSR with binned planes (kernel B4 on the card)."""
    import scipy.sparse as sp
    from amgx_tpu_torch.core.matrix import pack_kind
    A = sp.random(2100, 2100, density=0.3, random_state=1, format="lil") \
        + sp.identity(2100, format="lil")
    A[0, :] = 1.0
    m = amgx_tpu_torch.Matrix(A, device="cpu")
    assert pack_kind(m.device()) == "csr/binned"
