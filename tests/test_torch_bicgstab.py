"""BASELINE config 4 (PBICGSTAB + MULTICOLOR_DILU on 4×4 blocks) and
plain BiCGStab in the port against the JAX package on the CPU, with the
JAX package's binned kernels in interpret mode.

In f64 the two packages take the same iterations and their residual
histories agree to rounding.  With the f32 pack and the f64 refinement,
an iteration count of BiCGStab follows the rounding of its inner
products: the port sums an f32 pair in f64 (so the card and the CPU give
one value), the JAX package's CPU dot in f32.  Given the JAX package's
reductions the port takes the JAX package's iterations, its history
agreeing until f32 rounding parts the two trajectories; with its own it
converges to the same tolerance within two iterations of them."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
import jax.numpy as jnp
from amgx_tpu.ops import pallas_csr

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import DeviceError, FailureKind, SolveStatus
from amgx_tpu_torch.io import gauntlet_cases, spe10_block_system
from amgx_tpu_torch.solvers import krylov

#: BASELINE config 4 as bench.py:1586-1590 runs it
CFG4 = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, "
        "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")
HIST = ", out:store_res_history=1"


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)


@pytest.fixture(scope="module")
def masked20():
    return spe10_block_system(20, 20, 20)


def _solve_both(A, b, cfg, dtype=None):
    rhs = np.ones(A.shape[0])
    mj = jx.Matrix(A, block_dim=b)
    mp = amgx.Matrix(A, block_dim=b, device="cpu")
    if dtype is not None:
        mj.device_dtype = mp.device_dtype = dtype
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    sp_ = amgx.create_solver(cfg)
    sp_.setup(mp)
    return sj.solve(rhs), sp_.solve(rhs), rhs


def _relres(A, x, rhs):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs)


def test_config4_masked20_f64_matches_jax(masked20):
    rj, rp, rhs = _solve_both(masked20, 4, CFG4 + HIST)
    assert rp.iterations == rj.iterations == 16
    assert rp.status == SolveStatus.SUCCESS
    hj, hp = np.asarray(rj.residual_history), rp.residual_history
    assert hp.shape == hj.shape == (17, 4)      # per block component
    np.testing.assert_allclose(hp, hj, rtol=1e-9)
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12)


def test_config4_masked20_f32_refined(masked20, monkeypatch):
    """The f32 pack + f64 refinement: the JAX package takes 22
    iterations.  With the JAX package's inner products substituted the
    port takes the same 22 and its residual history agrees with the JAX
    package's to f32 rounding; with its own it reaches the tolerance
    within two iterations of them (true relres ≤ 1e-8)."""
    rj, rp, rhs = _solve_both(masked20, 4, CFG4 + HIST, np.float32)
    assert rj.iterations == 22
    assert rp.status == SolveStatus.SUCCESS
    assert abs(rp.iterations - rj.iterations) <= 2
    assert _relres(masked20, rp.x, rhs) <= 1e-8
    assert rp.x.dtype == torch.float64

    def jax_dot(x, y):
        return torch.tensor(float(jnp.dot(x.numpy(), y.numpy())),
                            dtype=x.dtype)

    monkeypatch.setattr(krylov, "_wdot", jax_dot)
    mp = amgx.Matrix(masked20, block_dim=4, device="cpu")
    mp.device_dtype = np.float32
    sp_ = amgx.create_solver(CFG4 + HIST)
    sp_.setup(mp)
    rq = sp_.solve(np.ones(masked20.shape[0]))
    assert rq.iterations == rj.iterations == 22
    # the f32 trajectories part at the rounding of the SpMV and DILU sums
    # (1e-7 a step), amplified by BiCGStab's recurrences: 2.4e-7 after one
    # iteration, 5.5e-5 after three, and no bound at the tail, where both
    # have passed the tolerance
    hq, hj = rq.residual_history, np.asarray(rj.residual_history)
    assert hq.shape == hj.shape == (23, 4)
    np.testing.assert_allclose(hq[:4], hj[:4], rtol=1e-4)
    assert (hq[-1] <= 1e-8 * hq[0]).all() and (hj[-1] <= 1e-8 * hj[0]).all()


@pytest.mark.parametrize("name", ["cfd4", "species5"])
def test_gauntlet_nonsym_counts_match_jax(name):
    case = next(c for c in gauntlet_cases(0.5) if c.name == name)
    A, b = case.build()
    rj, rp, rhs = _solve_both(A, b, case.cfg + HIST)
    assert rp.iterations == rj.iterations
    assert rp.status == SolveStatus.SUCCESS
    np.testing.assert_allclose(rp.residual_history,
                               np.asarray(rj.residual_history), rtol=1e-9)
    assert _relres(A, rp.x, rhs) <= 1e-8


def test_config4_expansion_pack_matches_native(masked20, monkeypatch):
    """``AMGX_BLOCK_NATIVE=0`` (the scalar-expansion binned pack, kernel
    B4 on the card) solves the same system: in f64 the same iterations
    and history as the block-native pack."""
    rhs = np.ones(masked20.shape[0])
    out = {}
    for native in (True, False):
        monkeypatch.setenv("AMGX_BLOCK_NATIVE", "1" if native else "0")
        mp = amgx.Matrix(masked20, block_dim=4, device="cpu")
        s = amgx.create_solver(CFG4 + HIST)
        s.setup(mp)
        out[native] = s.solve(rhs)
    assert out[True].iterations == out[False].iterations == 16
    np.testing.assert_allclose(out[False].residual_history,
                               out[True].residual_history, rtol=1e-9)


def _nonsym(n=400, seed=3):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    return (A + sp.diags(rng.uniform(4.0, 5.0, n))).tocsr()


@pytest.mark.parametrize("tol", [1e-8, 1e-12])
def test_unpreconditioned_bicgstab_matches_jax(tol):
    A = _nonsym()
    cfg = ("config_version=2, solver(out)=BICGSTAB, out:max_iters=100, "
           f"out:monitor_residual=1, out:tolerance={tol}, "
           "out:convergence=RELATIVE_INI, out:store_res_history=1, "
           "out:use_scalar_norm=1")
    rj, rp, rhs = _solve_both(A, 1, cfg)
    assert rp.iterations == rj.iterations
    np.testing.assert_allclose(rp.residual_history,
                               np.asarray(rj.residual_history), rtol=1e-8,
                               atol=1e-14)
    assert rp.residual_history.shape[1] == 1


def test_breakdown_code_reports_failed(monkeypatch):
    """ρ = r*·r collapsing to 0 while the residual lives is the serious
    breakdown: the solve stops at that iteration and reports FAILED with
    a Krylov breakdown (the inner product is forced to 0 at the second
    iteration; an exact collapse depends on rounding)."""
    calls = {"n": 0}
    orig = krylov._wdot

    def zero_second_rho(x, y):
        calls["n"] += 1
        out = orig(x, y)
        return torch.zeros_like(out) if calls["n"] == 5 else out

    monkeypatch.setattr(krylov, "_wdot", zero_second_rho)
    A = _nonsym()
    slv = amgx.create_solver(
        "config_version=2, solver(out)=BICGSTAB, out:max_iters=50, "
        "out:monitor_residual=1, out:tolerance=1e-10, "
        "out:convergence=RELATIVE_INI")
    slv.setup(amgx.Matrix(A, device="cpu"))
    res = slv.solve(np.ones(A.shape[0]))
    assert res.iterations == 2
    assert res.status == SolveStatus.FAILED
    assert res.failure.kind == FailureKind.KRYLOV_BREAKDOWN
    assert res.failure.iteration == 2


def test_entry_point_defaults_to_the_card(masked20):
    """Without ``device="cpu"`` the block upload asks for the card, which
    this machine does not have."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    with pytest.raises(DeviceError):
        amgx.Matrix(masked20, block_dim=4)
