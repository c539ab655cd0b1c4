"""NVAMGBinary IO (``amgx_tpu_torch.io.binary``) against
``amgx_tpu.io.binary`` byte for byte, and the fmt ``dense`` pack
(``AMGX_DENSE_PACK=1``) against the JAX package: its SpMV, and a solve
whose coarse levels are dense."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu
import jax.numpy as jnp
from amgx_tpu.io import binary as jbin
from amgx_tpu.ops.spmv import spmv as jspmv

import amgx_tpu_torch as tam
from amgx_tpu_torch.io import (poisson5pt, poisson7pt, read_binary,
                               read_system_auto, write_binary)
from amgx_tpu_torch.ops import spmv as smod


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["scalar", "block3", "rhs_soln"])
def test_binary_roundtrip_bytes(tmp_path, case):
    rng = np.random.default_rng(3)
    A = sp.csr_matrix(poisson5pt(6, 6))
    b, kw = 1, {}
    if case == "block3":
        b = 3
        A = sp.bsr_matrix(sp.kron(A, np.ones((3, 3)) + np.eye(3)),
                          blocksize=(3, 3))
    if case == "rhs_soln":
        kw = dict(rhs=rng.standard_normal(A.shape[0]),
                  solution=rng.standard_normal(A.shape[0]))
    mine, theirs = tmp_path / "p.bin", tmp_path / "j.bin"
    write_binary(str(mine), A, block_dim=b, **kw)
    jbin.write_binary(str(theirs), A, block_dim=b, **kw)
    assert _bytes(mine) == _bytes(theirs)
    got, want = read_binary(str(mine)), jbin.read_binary(str(theirs))
    assert (got.block_dimx, got.block_dimy) == (b, b)
    assert abs(got.A - A).max() == 0
    assert abs(got.A - want.A).max() == 0
    for key in ("rhs", "solution"):
        g, w = getattr(got, key), getattr(want, key)
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


def test_external_diagonal_flag(tmp_path):
    """A file whose diagonal is stored apart (flag 4 of the header) reads
    as A + D in both packages."""
    A = sp.csr_matrix(poisson5pt(4, 4))
    off = sp.csr_matrix(A - sp.diags(A.diagonal()))
    off.eliminate_zeros()
    off.sort_indices()
    path = tmp_path / "d.bin"
    with open(path, "wb") as f:
        f.write(b"%%NVAMGBinary\n")
        np.array([1, 0, 0, 0, 1, 1, 1, A.shape[0], off.nnz],
                 dtype=np.uint32).tofile(f)
        off.indptr.astype(np.int32).tofile(f)
        off.indices.astype(np.int32).tofile(f)
        off.data.astype(np.float64).tofile(f)
        A.diagonal().astype(np.float64).tofile(f)
    got, want = read_binary(str(path)), jbin.read_binary(str(path))
    assert abs(got.A - A).max() == 0 and abs(got.A - want.A).max() == 0


def test_read_system_auto_both_formats(tmp_path):
    A = sp.csr_matrix(poisson5pt(5, 5))
    rhs = np.arange(A.shape[0], dtype=np.float64)
    tam.io.write_matrix_market(str(tmp_path / "a.mtx"), A, rhs=rhs)
    write_binary(str(tmp_path / "a.bin"), A, rhs=rhs)
    for name in ("a.mtx", "a.bin"):
        got = read_system_auto(str(tmp_path / name))
        want = jbin.read_system_auto(str(tmp_path / name))
        assert abs(got.A - A).max() == 0 and abs(got.A - want.A).max() == 0
        np.testing.assert_array_equal(got.rhs, want.rhs)


def test_dense_pack_spmv(monkeypatch):
    monkeypatch.setenv("AMGX_DENSE_PACK", "1")
    rng = np.random.default_rng(0)
    A = sp.random(300, 300, density=0.05, format="csr",
                  random_state=np.random.RandomState(2)) + sp.identity(300)
    A = sp.csr_matrix(A)
    Ad = tam.Matrix(A, device="cpu").device()
    jd = amgx_tpu.Matrix(A).device()
    assert Ad.fmt == "dense" == jd.fmt and tam.pack_kind(Ad) == "dense"
    np.testing.assert_array_equal(Ad.vals.numpy(), A.toarray())
    x = rng.standard_normal(300)
    smod.reset_dispatch()
    y = smod.spmv(Ad, torch.from_numpy(x)).numpy()
    assert smod.DISPATCH["dense"] == 1
    np.testing.assert_allclose(y, np.array(jspmv(jd, jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(smod.abs_rowsum(Ad).numpy(),
                               np.asarray(abs(A).sum(axis=1)).ravel(),
                               rtol=1e-14)
    monkeypatch.delenv("AMGX_DENSE_PACK")
    assert tam.Matrix(A, device="cpu").device().fmt != "dense"


def test_dense_level_solve_matches_jax(monkeypatch):
    """The headline stack with SIZE_2 aggregation and a V cycle at 10³: its
    coarse levels pack dense under the switch, in both packages; the f32
    pack takes the JAX package's count."""
    monkeypatch.setenv("AMGX_DENSE_PACK", "1")
    cfg = (
        "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
        "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
        "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=20, "
        "amg:cycle=V, amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
        "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
        "amg:coarse_solver=DENSE_LU_SOLVER")
    A = poisson7pt(10, 10, 10)
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    m = tam.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = tam.create_solver(tam.AMGConfig(cfg))
    slv.setup(m)
    fmts = [lvl.Ad.fmt for lvl in slv.preconditioner.hierarchy.levels]
    smod.reset_dispatch()
    res = slv.solve(b)
    jm = amgx_tpu.Matrix(A)
    jm.device_dtype = np.float32
    js = amgx_tpu.create_solver(amgx_tpu.AMGConfig(cfg))
    js.setup(jm)
    jfmts = [lvl.A.device().fmt
             for lvl in js.preconditioner.hierarchy.levels]
    assert fmts == jfmts and "dense" in fmts
    assert smod.DISPATCH["dense"] > 0
    assert res.status == 0 and res.iterations == js.solve(b).iterations
