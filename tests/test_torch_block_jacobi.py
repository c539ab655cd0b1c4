"""BLOCK_JACOBI on b×b block systems in the port against the JAX package
on the CPU (f64 packs), with the JAX package's binned kernels in
interpret mode.

The port inverts the diagonal blocks on the device by an elementwise
Gauss–Jordan elimination (``ops/ordered.py::guarded_block_inv``), the JAX
package on the host by LAPACK (``amgx_tpu/solvers/jacobi.py::
_invert_block_diag``): the two inverses differ in the last bits.  As the
main solver, block Jacobi is a stationary iteration and the residual
histories agree to 1e-8.  Under a Krylov method the last bits grow with
the recurrences (BiCGStab's, and CG's on jump2's 10³ coefficient jump, whose
last residuals part by 2.3e-5): the iteration counts are equal, the
first iterations agree to 1e-9 and the whole history to 1e-4."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.ops import pallas_csr
from amgx_tpu.solvers.jacobi import _invert_block_diag

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import SolveStatus
from amgx_tpu_torch.io import gauntlet_cases, spe10_block_system
from amgx_tpu_torch.ops.ordered import guarded_block_inv
from amgx_tpu_torch.solvers.jacobi import apply_dinv

KRYLOV = ("config_version=2, solver(out)={}, out:max_iters=300, "
          "out:monitor_residual=1, out:tolerance=1e-8, "
          "out:convergence=RELATIVE_INI, out:store_res_history=1, "
          "out:preconditioner(pre)=BLOCK_JACOBI, pre:max_iters=1")
MAIN = ("config_version=2, solver(out)=BLOCK_JACOBI, out:max_iters={}, "
        "out:monitor_residual=1, out:tolerance=1e-4, "
        "out:convergence=RELATIVE_INI, out:store_res_history=1, "
        "out:relaxation_factor=0.8")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)


def _system(name):
    if name == "spe10_6":
        return spe10_block_system(6, 6, 6), 4
    case = next(c for c in gauntlet_cases(0.5) if c.name == name)
    return case.build()


def _solve_both(A, b, cfg):
    rhs = np.ones(A.shape[0])
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jx.Matrix(A, block_dim=b))
    sp_ = amgx.create_solver(cfg)
    sp_.setup(amgx.Matrix(A, block_dim=b, device="cpu"))
    return sj.solve(rhs), sp_.solve(rhs), rhs


@pytest.mark.parametrize("name,krylov,iters", [
    ("spe10_6", "PBICGSTAB", 16), ("elast3", "PBICGSTAB", 9),
    ("cfd4", "PBICGSTAB", 31), ("species5", "PBICGSTAB", 30),
    ("jump2", "PCG", 79), ("aniso3", "PCG", 35)])
def test_block_jacobi_preconditioner_matches_jax(name, krylov, iters):
    """A Krylov solver preconditioned by one block-Jacobi sweep on b = 2,
    3, 4 and 5 systems (BiCGStab on the nonsymmetric and the SPE10 ones,
    CG on the SPD ones): the JAX package's count, histories to rounding
    (see the module docstring), true relres within the tolerance."""
    A, b = _system(name)
    rj, rp, rhs = _solve_both(A, b, KRYLOV.format(krylov))
    assert rp.iterations == rj.iterations == iters
    assert rp.status == SolveStatus.SUCCESS
    hj, hp = np.asarray(rj.residual_history), rp.residual_history
    assert hp.shape == hj.shape == (iters + 1, b)
    floor = 1e-14 * hj[0].max()
    np.testing.assert_allclose(hp[:4], hj[:4], rtol=1e-9, atol=floor)
    np.testing.assert_allclose(hp, hj, rtol=1e-4, atol=floor)
    x = rp.x.numpy()
    assert np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs) <= 1e-8


@pytest.mark.parametrize("name,max_iters,iters", [
    ("spe10_6", 400, None), ("elast3", 400, 110), ("cfd4", 400, 154),
    ("species5", 400, 154), ("aniso3", 500, 387), ("jump2", 120, 120)])
def test_block_jacobi_main_solver_matches_jax(name, max_iters, iters):
    """Damped block Jacobi (ω = 0.8) as the main solver: the JAX
    package's count and residual history to 1e-8.  jump2 (b = 2, a 10³
    coefficient jump) does not reach 1e-4 in 120 sweeps in either
    package: both stop at the limit, with equal histories."""
    A, b = _system(name)
    rj, rp, _ = _solve_both(A, b, MAIN.format(max_iters))
    assert rp.iterations == rj.iterations
    if iters is not None:
        assert rp.iterations == iters
    assert int(rp.status) == int(rj.status)
    assert (rp.status == SolveStatus.SUCCESS) == (rp.iterations < max_iters)
    np.testing.assert_allclose(rp.residual_history,
                               np.asarray(rj.residual_history), rtol=1e-8)


@pytest.mark.parametrize("b", [2, 3, 4, 5])
def test_setup_dinv_is_the_guarded_block_inverse(b):
    """The smoother's D⁻¹ on a block system is the JAX package's guarded
    inverse: a zero block and a singular block (two equal columns) take
    I, a block needing a pivot and well-conditioned blocks invert to
    1e-12; the sweep applies it block by block."""
    rng = np.random.default_rng(b)
    n = 40
    D = rng.standard_normal((n, b, b)) + 4.0 * np.eye(b)
    D[0] = 0.0
    D[1, :, 0] = D[1, :, 1]
    D[2] = np.roll(np.eye(b), 1, axis=0) * 3.0      # D[2][0, 0] == 0
    off = sp.kron(sp.diags([1.0, 1.0], [-1, 1], shape=(n, n)),
                  np.full((b, b), 0.1))
    A = sp.bsr_matrix(sp.block_diag(list(D)) + off, blocksize=(b, b))
    cfg = KRYLOV.format("PBICGSTAB")
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(A, block_dim=b, device="cpu"))
    dinv = slv.preconditioner.dinv
    assert dinv.shape == (n, b, b) and dinv.dtype == torch.float64
    want = np.asarray(_invert_block_diag(D))
    np.testing.assert_allclose(dinv.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(dinv[:2].numpy(),
                                  np.tile(np.eye(b), (2, 1, 1)))
    v = torch.from_numpy(rng.standard_normal(n * b))
    np.testing.assert_allclose(
        apply_dinv(dinv, v).numpy(),
        np.einsum("nab,nb->na", want, v.numpy().reshape(n, b)).ravel(),
        rtol=1e-12, atol=1e-12)


def test_f32_block_inverse_keeps_the_pack_dtype():
    """An f32 block pack's D⁻¹ is inverted and kept in f32, equal to the
    guarded inverse of the f32 diagonal; a scalar pack's stays the
    elementwise reciprocal."""
    A, b = _system("cfd4")
    m = amgx.Matrix(A, block_dim=b, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(KRYLOV.format("PBICGSTAB"))
    slv.setup(m)
    pre = slv.preconditioner
    assert pre.dinv.dtype == torch.float32
    assert torch.equal(pre.dinv, guarded_block_inv(pre.Ad.diag))
    from amgx_tpu_torch.io import poisson7pt
    ms = amgx.Matrix(poisson7pt(6, 6, 6), device="cpu")
    s2 = amgx.create_solver(KRYLOV.format("PCG"))
    s2.setup(ms)
    d = s2.preconditioner.Ad.diag
    assert s2.preconditioner.dinv.dim() == 1
    assert torch.equal(s2.preconditioner.dinv, 1.0 / d)
