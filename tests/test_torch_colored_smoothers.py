"""The color-parallel smoothers (MULTICOLOR_GS with its symmetric and L1
variants, GS, FIXCOLOR_GS, KACZMARZ), CF_JACOBI and NOSOLVER in the port
against the JAX package on the CPU in f64: one application to
``SWEEP_RTOL`` on scalar operators and b×b block systems (b = 2..5), the
classical levels' C/F split, and whole solves — each as an AMG smoother
and as a Krylov preconditioner — with equal counts and histories to
``HIST_RTOL``/``HIST_ATOL`` (``torch_solver_parity``)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from amgx_tpu.ops import pallas_csr

from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import poisson5pt, poisson7pt, spe10_block_system
from amgx_tpu_torch.io.gauntlet import cfd4, elasticity3, jump2, species5
from torch_solver_parity import (SWEEP_RTOL, apply_both, assert_same_solve,
                                 relres, solve_both)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    # the JAX package packs binned planes for the block systems only in
    # interpret mode on the CPU
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)


def _nonsym():
    A = sp.csr_matrix(poisson5pt(14, 14))
    rng = np.random.default_rng(5)
    m = A.shape[0]
    return (A + sp.random(m, m, density=0.01, random_state=5) * 0.2
            + sp.diags(rng.uniform(0.0, 0.5, m))).tocsr()


OPERATORS = {
    "poisson7": lambda: (sp.csr_matrix(poisson7pt(8, 8, 8)), 1),
    "nonsym": lambda: (_nonsym(), 1),
    "jump2": lambda: jump2(8),
    "elasticity3": lambda: elasticity3(6),
    "cfd4": lambda: cfd4(6),
    "species5": lambda: species5(6),
}
SMOOTHERS = {
    "MULTICOLOR_GS": "",
    "MULTICOLOR_GS-symmetric": ", s:symmetric_GS=1",
    "MULTICOLOR_GS-L1": ", s:GS_L1_variant=1",
    "MULTICOLOR_GS-symmetric-L1": ", s:symmetric_GS=1, s:GS_L1_variant=1",
    "GS": "",
    "FIXCOLOR_GS": "",
    "KACZMARZ": "",
    "CF_JACOBI": "",
    "CF_JACOBI-F-first": ", s:cf_smoothing_mode=1",
    "NOSOLVER": "",
}


@pytest.mark.parametrize("op", sorted(OPERATORS))
@pytest.mark.parametrize("smoother", sorted(SMOOTHERS))
def test_one_sweep_matches_jax(smoother, op):
    A, b = OPERATORS[op]()
    name = smoother.split("-")[0]
    cfg = (f"config_version=2, solver(s)={name}, s:max_iters=1, "
           "s:relaxation_factor=0.8" + SMOOTHERS[smoother])
    xj, xp, _, sp_ = apply_both(A, cfg, b)
    np.testing.assert_allclose(xp, xj, rtol=SWEEP_RTOL,
                               atol=SWEEP_RTOL * np.max(np.abs(xj)))
    if name == "NOSOLVER":
        return
    if name == "KACZMARZ" and b == 1:
        assert sp_.projections is not None      # the slab projections
    elif name in ("MULTICOLOR_GS", "GS", "FIXCOLOR_GS"):
        assert sp_.color_slabs is not None
        assert sp_.num_colors > 1


def test_two_sweeps_without_initial_guess_match_jax():
    A, b = OPERATORS["cfd4"]()
    cfg = ("config_version=2, solver(s)=MULTICOLOR_GS, s:max_iters=2, "
           "s:symmetric_GS=1")
    xj, xp, _, _ = apply_both(A, cfg, b, x0=False)
    np.testing.assert_allclose(xp, xj, rtol=SWEEP_RTOL,
                               atol=SWEEP_RTOL * np.max(np.abs(xj)))


def test_device_only_setup_takes_the_masked_sweep():
    """Set up from a device pack alone (no host matrix), the smoothers
    color every row alike and relax by masked full-width sweeps."""
    import amgx_tpu_torch as amgx
    A = sp.csr_matrix(poisson7pt(6, 6, 6))
    m = amgx.Matrix(A, device="cpu")
    rhs = torch.from_numpy(np.random.default_rng(1).standard_normal(216))
    for name in ("MULTICOLOR_GS", "KACZMARZ"):
        s = amgx.create_solver(f"config_version=2, solver(s)={name}, "
                               "s:max_iters=1")
        s.setup(m.device())
        assert s.color_slabs is None and s.num_colors == 1
        x = s.apply(rhs)
        assert torch.isfinite(x).all()
    # one masked color of GS is a damped Jacobi sweep
    jac = amgx.create_solver("config_version=2, solver(s)=BLOCK_JACOBI, "
                             "s:max_iters=1")
    jac.setup(m)
    gs = amgx.create_solver("config_version=2, solver(s)=MULTICOLOR_GS, "
                            "s:max_iters=1")
    gs.setup(m.device())
    x0 = torch.zeros_like(rhs)
    torch.testing.assert_close(gs.apply(rhs, x0), jac.apply(rhs, x0),
                               rtol=1e-15, atol=0)


CLASSICAL = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
             "out:monitor_residual=1, out:tolerance=1e-8, "
             "out:convergence=RELATIVE_INI, out:store_res_history=1, "
             "out:preconditioner(amg)=AMG, amg:algorithm=CLASSICAL, "
             "amg:selector=PMIS, amg:interpolator=D2, amg:max_iters=1, "
             "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
             "amg:strength_threshold=0.2401, "
             "amg:smoother(sm)={sm}, sm:max_iters=1, amg:presweeps=2, "
             "amg:postsweeps=2, amg:min_coarse_rows=32, "
             "amg:coarse_solver=DENSE_LU_SOLVER")


def test_classical_levels_expose_the_jax_cf_split():
    A = sp.csr_matrix(poisson7pt(12, 12, 12))
    rj, rp, slv = solve_both(A, CLASSICAL.format(sm="CF_JACOBI"))
    import amgx_tpu as jx
    sj = jx.create_solver(jx.AMGConfig(CLASSICAL.format(sm="CF_JACOBI")))
    sj.setup(jx.Matrix(A))
    jl = sj.preconditioner.hierarchy.levels
    pl = slv.preconditioner.hierarchy.levels
    assert len(jl) == len(pl) >= 2
    for lj, lp in zip(jl, pl):
        cj = getattr(lj.A, "cf_map", None)
        cp = getattr(lp.A, "cf_map", None)
        assert cp is not None and cj is not None
        np.testing.assert_array_equal(np.asarray(cp), np.asarray(cj))
        np.testing.assert_array_equal(
            lp.smoother.c_mask.numpy(), np.asarray(cj, dtype=bool))
    assert_same_solve(rj, rp)


@pytest.mark.parametrize("sm", ["MULTICOLOR_GS", "GS", "FIXCOLOR_GS",
                                "KACZMARZ", "CF_JACOBI", "NOSOLVER"])
def test_classical_amg_smoother_matches_jax(sm):
    side = 6 if sm == "KACZMARZ" else 12
    A = sp.csr_matrix(poisson7pt(side, side, side))
    rj, rp, _ = solve_both(A, CLASSICAL.format(sm=sm))
    assert_same_solve(rj, rp)
    if sm != "NOSOLVER":
        assert rp.status == SolveStatus.SUCCESS


AGGREGATION = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
               "out:monitor_residual=1, out:tolerance=1e-8, "
               "out:convergence=RELATIVE_INI, out:store_res_history=1, "
               "out:gmres_n_restart=10, out:preconditioner(amg)=AMG, "
               "amg:algorithm=AGGREGATION, amg:selector=SIZE_2, "
               "amg:max_iters=1, amg:smoother(sm)={sm}, sm:max_iters=1, "
               "sm:symmetric_GS=1, amg:min_coarse_rows=16, "
               "amg:coarse_solver=DENSE_LU_SOLVER")


@pytest.mark.parametrize("sm", ["MULTICOLOR_GS", "KACZMARZ"])
def test_aggregation_amg_smoother_matches_jax(sm):
    side = 6 if sm == "KACZMARZ" else 12
    A = sp.csr_matrix(poisson7pt(side, side, side))
    rj, rp, _ = solve_both(A, AGGREGATION.format(sm=sm))
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS


BLOCK = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
         "out:monitor_residual=1, out:tolerance=1e-8, "
         "out:convergence=RELATIVE_INI, out:store_res_history=1, "
         "out:preconditioner(pre)={pre}, pre:max_iters=1")


@pytest.mark.parametrize("pre", ["MULTICOLOR_GS", "KACZMARZ",
                                 "CF_JACOBI"])
def test_block_preconditioner_matches_jax(pre):
    """PBICGSTAB preconditioned by one sweep on config 4's block system
    at (8, 8, 8) ((6, 6, 6) for the slower Kaczmarz)."""
    A = spe10_block_system(*((6, 6, 6) if pre == "KACZMARZ"
                             else (8, 8, 8)))
    rj, rp, _ = solve_both(A, BLOCK.format(pre=pre), b=4)
    assert_same_solve(rj, rp)
    assert rp.status == SolveStatus.SUCCESS
    assert relres(A, rp.x, np.ones(A.shape[0])) <= 1.01e-8
