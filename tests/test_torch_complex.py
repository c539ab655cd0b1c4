"""Complex systems on the port against the JAX package on the CPU: the
four solves of ``tests/test_complex.py`` at its sizes, the headline stack
(FGMRES(6) + GEO aggregation AMG, CG cycle, BLOCK_JACOBI 2+2, DENSE_LU)
on the shifted Helmholtz operator in c128 and c64, the decline of the
complex SpMV to the plain path, and the stacks ROADMAP item 7c brought
to complex operators (classical AMG stays refused, as the JAX package
refuses it)."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu

import amgx_tpu_torch as tam
from amgx_tpu_torch.errors import BadParametersError, NotImplementedError_
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.ops import ordered
from amgx_tpu_torch.ops import spmv as smod
from amgx_tpu_torch.ops.dia_spmv import dia_spmv

HEADLINE = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=400, "
    "out:monitor_residual=1, out:tolerance={tol}, out:store_res_history=1, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector={sel}, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle={cyc}, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
JACOBI = ("config_version=2, solver(out)={name}, out:max_iters={it}, "
          "out:monitor_residual=1, out:tolerance={tol}, "
          "out:store_res_history=1, out:convergence=RELATIVE_INI, "
          "out:gmres_n_restart=30, "
          "out:preconditioner(pre)=BLOCK_JACOBI, pre:max_iters=1")


def _hermitian_spd(n_side=10, seed=0):
    """L + i·K with K antisymmetric real (``tests/test_complex.py``)."""
    L = sp.csr_matrix(poisson7pt(n_side, n_side, n_side),
                      dtype=np.complex128)
    n = L.shape[0]
    rng = np.random.default_rng(seed)
    coo = sp.triu(L, k=1).tocoo()
    vals = 0.3 * rng.standard_normal(len(coo.data))
    K = sp.csr_matrix((vals, (coo.row, coo.col)), shape=(n, n))
    A = sp.csr_matrix(L + 1j * (K - K.T))
    A.sort_indices()
    return A


def _helmholtz(n_side=10, k2=0.4, eps=0.35):
    """L − k²I + iεI (``tests/test_complex.py:40-47``)."""
    L = sp.csr_matrix(poisson7pt(n_side, n_side, n_side),
                      dtype=np.complex128)
    return sp.csr_matrix(L + (-k2 + 1j * eps) * sp.identity(L.shape[0]))


def _crhs(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _both(cfg, A, b):
    port = tam.create_solver(tam.AMGConfig(cfg))
    port.setup(tam.Matrix(A, device="cpu"))
    rp = port.solve(b)
    jax_slv = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    jax_slv.setup(amgx_tpu.Matrix(A))
    rj = jax_slv.solve(b)
    return rp, rj


def _relres(A, x, b):
    return np.linalg.norm(b - A @ x) / np.linalg.norm(b)


def _hist_close(rp, rj, rtol):
    hp = np.asarray(rp.residual_history, dtype=np.float64).ravel()
    hj = np.asarray(rj.residual_history, dtype=np.float64).ravel()
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=rtol)


@pytest.mark.parametrize("case", ["pcg_hermitian", "fgmres_helmholtz",
                                  "bicgstab_helmholtz"])
def test_complex_solves_match_jax(case):
    if case == "pcg_hermitian":
        A, it, tol = _hermitian_spd(), 400, 1e-10
        cfg, b = JACOBI.format(name="PCG", it=it, tol=tol), _crhs(1000, 1)
    elif case == "fgmres_helmholtz":
        A, tol = _helmholtz(), 1e-9
        cfg, b = JACOBI.format(name="FGMRES", it=400, tol=tol), _crhs(1000, 2)
    else:
        A, tol = _helmholtz(8), 1e-9
        cfg = JACOBI.format(name="PBICGSTAB", it=600, tol=tol)
        b = np.ones(512, dtype=np.complex128)
    rp, rj = _both(cfg, A, b)
    x = rp.x.numpy()
    assert np.iscomplexobj(x) and x.dtype == np.complex128
    assert rp.status == 0 and rj.status == 0
    assert rp.iterations == rj.iterations
    _hist_close(rp, rj, 1e-8)
    assert _relres(A, x, b) < 10 * tol


def test_matrix_market_complex_roundtrip(tmp_path):
    A = _helmholtz(4)
    b = _crhs(A.shape[0], 3)
    path = tmp_path / "cplx.mtx"
    tam.io.write_matrix_market(str(path), A, rhs=b)
    data = tam.io.read_matrix_market(str(path))
    jdata = amgx_tpu.io.read_matrix_market(str(path))
    assert np.iscomplexobj(data.A.data)
    assert abs(data.A - A).max() < 1e-12
    assert abs(data.A - jdata.A).max() == 0
    np.testing.assert_array_equal(data.rhs, jdata.rhs)


#: the seed of ``chip_smoke.complex_rhs`` (phase 36's right-hand sides)
SMOKE_SEED = 20261016


@pytest.mark.parametrize("prec,side,seed", [
    pytest.param("c128", 12, 5, id="c128"),
    pytest.param("c64", 12, 5, id="c64"),
    pytest.param("c128", 24, SMOKE_SEED, id="c128-24-smoke-rhs")])
def test_headline_stack_on_helmholtz(prec, side, seed):
    """The headline stack at 12³, and at 24³ on the right-hand side of
    ``chip_smoke.py`` phase 36's card-against-CPU solves: equal counts;
    the c128 histories to 1e-8 relative (the c64 solve stops above the
    c64 floor, 1e-5)."""
    A = _helmholtz(side)
    b = _crhs(A.shape[0], seed)
    tol = "1e-8" if prec == "c128" else "1e-5"
    if prec == "c64":
        A, b = A.astype(np.complex64), b.astype(np.complex64)
    smod.reset_dispatch()
    rp, rj = _both(HEADLINE.format(tol=tol, sel="GEO", cyc="CG"), A, b)
    assert rp.iterations == rj.iterations and rp.status == 0
    assert rp.x.dtype == (torch.complex128 if prec == "c128"
                          else torch.complex64)
    if prec == "c128":
        _hist_close(rp, rj, 1e-8)
    # every SpMV took the plain slices; none is a decline on the CPU
    assert smod.DISPATCH["dia/slices"] > 0 and smod.DISPATCH["dia/kernel"] \
        == 0
    assert not any(smod.declines().values())


def test_size2_v_cycle_matches_jax():
    A = _helmholtz(8)
    b = _crhs(A.shape[0], 5)
    cfg = HEADLINE.format(tol="1e-8", sel="SIZE_2", cyc="V")
    rp, rj = _both(cfg, A, b)
    assert rp.iterations == rj.iterations
    _hist_close(rp, rj, 1e-8)


def test_complex_kernels_refuse_and_products_round_alike():
    A = tam.Matrix(_helmholtz(4), device="cpu").device()
    x = torch.ones(A.n_rows, dtype=torch.complex128)
    with pytest.raises(BadParametersError):
        dia_spmv(A.vals, x, A.dia_offsets)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_crhs(4096, 7).astype(np.complex64))
    c = torch.from_numpy(_crhs(4096, 8).astype(np.complex64))
    # the part-by-part product is the CPU's own complex product bit for
    # bit; the quotient and reciprocal hold to a few ulps
    assert torch.equal(ordered.mul(a, c), a * c)
    np.testing.assert_allclose(ordered.div(a, c).numpy(), (a / c).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(ordered.recip(c).numpy(), (1 / c).numpy(),
                               rtol=1e-6)
    r = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    assert torch.equal(ordered.mul(r, c), r * c)
    assert ordered.widen(a).dtype == torch.complex128
    assert ordered.wdot(a, c).dtype == torch.complex64


@pytest.mark.parametrize("cfg", [
    JACOBI.format(name="PCG_PIPE", it=10, tol=1e-6),
    JACOBI.format(name="GMRES", it=10, tol=1e-6) + ", out:krylov_comm=CA",
    JACOBI.format(name="IDR", it=10, tol=1e-6),
    JACOBI.format(name="FGMRES", it=10, tol=1e-6).replace(
        "BLOCK_JACOBI", "JACOBI_L1"),
    HEADLINE.format(tol="1e-6", sel="PMIS", cyc="V").replace(
        "AGGREGATION", "CLASSICAL"),
    HEADLINE.format(tol="1e-6", sel="GEO", cyc="W"),
])
def test_item_7c_raises(cfg):
    """The stacks ROADMAP item 7c brought to complex operators run with
    the JAX package's count and history (4³ Helmholtz, 10 iterations at
    most); classical AMG stays refused in both packages, the port's
    refusal at setup naming the JAX package's (which raises once a
    level coarsens: at 8³ here; the 4³ grid stays one level there)."""
    A = _helmholtz(8 if "CLASSICAL" in cfg else 4)
    b = _crhs(A.shape[0], 6)
    slv = tam.create_solver(tam.AMGConfig(cfg))
    if "CLASSICAL" in cfg:
        with pytest.raises(NotImplementedError_, match="does not run it"):
            slv.setup(tam.Matrix(A, device="cpu"))
        with pytest.raises(TypeError):
            jax_slv = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
            jax_slv.setup(amgx_tpu.Matrix(A))
            jax_slv.solve(b)
        return
    rp, rj = _both(cfg, A, b)
    assert rp.iterations == rj.iterations
    hp = np.asarray(rp.residual_history, dtype=np.float64).ravel()
    hj = np.asarray(rj.residual_history, dtype=np.float64).ravel()
    np.testing.assert_allclose(hp, hj, rtol=1e-8, atol=1e-12 * hj[0])
