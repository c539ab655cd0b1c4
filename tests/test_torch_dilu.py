"""Multicolor DILU in the port against the JAX package: the colors, the
inverted E blocks of the host and device factorisations, and one DILU
application (scalar and block) on the JAX package's own state carried in
through ``interop``."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
import jax
import jax.numpy as jnp
from amgx_tpu.coloring import color_matrix as jax_color_matrix
from amgx_tpu.ops import pallas_csr
from amgx_tpu.solvers import dilu as jax_dilu

import amgx_tpu_torch as amgx
from amgx_tpu_torch.coloring import color_matrix
from amgx_tpu_torch.interop import dilu_from_numpy, device_matrix_from_fields
from amgx_tpu_torch.io import poisson5pt, poisson7pt, spe10_block_system
from amgx_tpu_torch.io.gauntlet import cfd4, species5
from amgx_tpu_torch.solvers import dilu

#: f64 factor and apply against the JAX package: the same products
#: summed in another order (the port adds them left to right, the JAX
#: package contracts an einsum; Gauss–Jordan against a batched inverse)
TOL = 1e-12
CFG = "config_version=2, solver(s)=MULTICOLOR_DILU, s:max_iters=1"


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)


def _nonsym_scalar():
    A = sp.csr_matrix(poisson5pt(30, 30))
    rng = np.random.default_rng(2)
    return (A + sp.random(900, 900, density=0.002, random_state=2)
            * 0.1 + sp.diags(rng.uniform(0.0, 0.5, 900))).tocsr()


CASES = {
    "poisson7": lambda: (sp.csr_matrix(poisson7pt(10, 9, 8)), 1),
    "nonsym_scalar": lambda: (_nonsym_scalar(), 1),
    "cfd4": lambda: cfd4(10),
    "species5": lambda: species5(8),
    "masked12": lambda: (spe10_block_system(12, 12, 12), 4),
}


def _pair(A, b):
    mj = jx.Matrix(A, block_dim=b)
    mp = amgx.Matrix(A, block_dim=b, device="cpu")
    return mj, mp


@pytest.mark.parametrize("name", sorted(CASES))
def test_colors_equal(name):
    A, b = CASES[name]()
    mj, mp = _pair(A, b)
    cfg_j, cfg_p = jx.AMGConfig(CFG), amgx.AMGConfig(CFG)
    cj = jax_color_matrix(mj, cfg_j, "s")
    cp = color_matrix(mp, cfg_p, "s")
    assert cp.num_colors == cj.num_colors
    np.testing.assert_array_equal(cp.colors, cj.colors)


@pytest.mark.parametrize("name", ["cfd4", "species5", "masked12"])
def test_block_einv_host_and_device_equal_jax(name):
    A, b = CASES[name]()
    mj, _ = _pair(A, b)
    colors = jax_color_matrix(mj, jx.AMGConfig(CFG), "s").colors
    bsr = sp.bsr_matrix(A, blocksize=(b, b))
    Lj, Uj, Ej = jax_dilu._block_dilu_factor(bsr, colors, b)
    Lh, Uh, Eh = dilu._block_dilu_factor(bsr, colors, b)
    Ld, Ud, Ed = dilu._block_dilu_factor_device(bsr, colors, b, "cpu")
    assert Ed.dtype == torch.float64
    np.testing.assert_allclose(Eh, Ej, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(Ed.numpy(), Ej, rtol=TOL, atol=TOL)
    if name == "cfd4":
        _, _, Ejd = jax_dilu._block_dilu_factor_device(bsr, colors, b)
        np.testing.assert_allclose(Ed.numpy(), np.asarray(Ejd), rtol=TOL,
                                   atol=TOL)
    for got, want in ((Lh, Lj), (Uh, Uj), (Ld, Lj), (Ud, Uj)):
        assert (sp.csr_matrix(got) != sp.csr_matrix(want)).nnz == 0


def test_scalar_factor_equals_jax():
    A, _ = CASES["nonsym_scalar"]()
    mj, _ = _pair(A, 1)
    colors = jax_color_matrix(mj, jx.AMGConfig(CFG), "s").colors
    Lj, Uj, Ej = jax_dilu._scalar_dilu_factor(A, colors)
    Lp, Up, Ep = dilu._scalar_dilu_factor(A, colors)
    np.testing.assert_array_equal(Ep, Ej)
    assert (Lp != Lj).nnz == 0 and (Up != Uj).nnz == 0


def test_singular_block_guard_equals_jax():
    n, b = 6, 2
    blocks = np.tile(np.eye(b) * 2.0, (n, 1, 1))
    blocks[2] = 0.0
    blocks[4] = np.array([[1e-30, 2e-30], [2e-30, 4e-30]])   # singular
    bsr = sp.bsr_matrix((blocks, np.arange(n), np.arange(n + 1)),
                        shape=(n * b, n * b))
    colors = np.zeros(n, dtype=np.int32)
    _, _, Ej = jax_dilu._block_dilu_factor(bsr, colors, b)
    _, _, Eh = dilu._block_dilu_factor(bsr, colors, b)
    _, _, Ed = dilu._block_dilu_factor_device(bsr, colors, b, "cpu")
    np.testing.assert_array_equal(Eh, Ej)
    np.testing.assert_allclose(Ed.numpy(), Ej, rtol=TOL)
    np.testing.assert_array_equal(Eh[2], np.eye(b))
    np.testing.assert_array_equal(Eh[4], np.eye(b))


@pytest.mark.parametrize("b", [2, 3, 4, 5])
def test_device_inverse_matches_the_host_rule(b):
    """The device factorisation's elementwise Gauss–Jordan inverse
    against the host's guarded batched inverse: well-conditioned blocks
    to 1e-12, a zero block and a singular block (two equal columns) both
    I, a block that needs pivoting (zero leading entry) inverted."""
    rng = np.random.default_rng(b)
    E = rng.standard_normal((200, b, b)) + 4.0 * np.eye(b)
    E[0] = 0.0
    E[1, :, 0] = E[1, :, 1]
    E[2] = np.roll(np.eye(b), 1, axis=0) * 3.0       # E[2][0, 0] == 0
    got = dilu._guarded_inv(torch.from_numpy(E)).numpy()
    want = dilu._guarded_batch_inv(E, b)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[:2], np.tile(np.eye(b), (2, 1, 1)))
    np.testing.assert_allclose(got[2] @ E[2], np.eye(b), atol=TOL)


def test_setup_takes_the_device_factor_above_8192_rows(monkeypatch):
    """Masked 22³ (about 10k block rows) is past the 8192-row gate: the
    port's setup factors through the device sweep (CPU tensors here) and
    its E⁻¹ equals the JAX package's factorisation on the same colors."""
    A = spe10_block_system(22, 22, 22)
    assert A.shape[0] // 4 >= dilu._DILU_DEVICE_MIN_ROWS
    called = {}
    orig = dilu._block_dilu_factor_device

    def spy(*a, **k):
        called["yes"] = True
        return orig(*a, **k)

    monkeypatch.setattr(dilu, "_block_dilu_factor_device", spy)
    mp = amgx.Matrix(A, block_dim=4, device="cpu")
    sp_ = amgx.create_solver(CFG)
    sp_.setup(mp)
    assert called.get("yes")
    colors = jax_color_matrix(jx.Matrix(A, block_dim=4), jx.AMGConfig(CFG),
                              "s").colors
    np.testing.assert_array_equal(mp.coloring.colors, colors)
    _, _, Ej = jax_dilu._block_dilu_factor(sp.bsr_matrix(A), colors, 4)
    np.testing.assert_allclose(sp_.Einv.numpy(), Ej, rtol=TOL, atol=TOL)


def _carry(sj, Aj):
    Ap = device_matrix_from_fields(Aj, device="cpu")
    slabs = [[(np.asarray(s.rows), np.asarray(s.cols), np.asarray(s.vals))
              for s in sl] for sl in (sj.L_slabs, sj.U_slabs)]
    return Ap, dilu_from_numpy(amgx.AMGConfig(CFG), "s", Ap,
                               np.asarray(sj.Einv), *slabs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_application_on_jax_state(name):
    """One DILU application (residual, two color sweeps, ω-update) on the
    JAX package's own E⁻¹ and slabs, carried in through ``interop``."""
    A, b = CASES[name]()
    mj = jx.Matrix(A, block_dim=b)
    sj = jx.create_solver(jx.AMGConfig(CFG))
    sj.setup(mj)
    Ap, sp_ = _carry(sj, mj.device())
    assert sp_.block == (b > 1) and sp_.num_colors == sj.num_colors
    r = np.random.default_rng(7).standard_normal(A.shape[0])
    zj = np.asarray(jax.jit(sj._apply_dilu)(jnp.asarray(r)))
    zp = sp_._apply_dilu(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(zp, zj, rtol=TOL, atol=TOL * np.abs(zj).max())
    xj = np.asarray(jax.jit(sj.apply)(jnp.asarray(r)))
    xp = sp_.apply(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(xp, xj, rtol=TOL, atol=TOL * np.abs(xj).max())
    # the port's own setup builds the same state
    mp = amgx.Matrix(A, block_dim=b, device="cpu")
    own = amgx.create_solver(CFG)
    own.setup(mp)
    np.testing.assert_allclose(own._apply_dilu(torch.from_numpy(r)).numpy(),
                               zj, rtol=TOL, atol=TOL * np.abs(zj).max())
