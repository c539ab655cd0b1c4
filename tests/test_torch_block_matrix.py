"""Block systems in the port against the JAX package: BSR ``Matrix``
views, the pack choice (``pack_kind``: block-DIA, block-native binned,
the scalar expansion, rectangular), the packs' arrays, MatrixMarket write
→ read with ``block_dim`` re-blocking, the block-DIA and block-CSR SpMVs
and the JAX package's declines.  The JAX package's binned kernels run in
interpret mode, as tests/test_pallas_csr.py runs them; the port attaches
its planes on every device, so its pack choice equals the JAX package's
under the interpreter."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
import jax.numpy as jnp
from amgx_tpu.core.matrix import pack_device as jax_pack_device
from amgx_tpu.core.matrix import pack_kind as jax_pack_kind
from amgx_tpu.io import read_matrix_market as jax_read_mtx
from amgx_tpu.io.gauntlet import cfd4 as jax_cfd4
from amgx_tpu.ops import pallas_csr
from amgx_tpu.ops.spmv import abs_rowsum as jax_abs_rowsum
from amgx_tpu.ops.spmv import spmv as jax_spmv

import amgx_tpu_torch as amgx
from amgx_tpu_torch.core.matrix import (dia_arrays_block, pack_device,
                                        pack_kind)
from amgx_tpu_torch.interop import device_matrix_from_fields
from amgx_tpu_torch.io import (gauntlet_cases, load_via_matrix_market,
                               read_matrix_market, spe10_block_system,
                               write_matrix_market)
from amgx_tpu_torch.io.gauntlet import cfd4, species5
from amgx_tpu_torch.ops.spmv import (DECLINES, DISPATCH, abs_rowsum,
                                     reset_dispatch, spmv)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)


def _masked20():
    return spe10_block_system(20, 20, 20)


def _rect_block():
    rng = np.random.default_rng(4)
    base = sp.random(90, 140, density=0.03, random_state=4, format="csr")
    data = rng.standard_normal((base.nnz, 3, 3))
    return sp.bsr_matrix((data, base.indices, base.indptr),
                         shape=(270, 420))


def _pair(A, b, dtype=np.float64, native=True, monkeypatch=None):
    """(JAX Matrix, port Matrix) of one upload."""
    if not native:
        monkeypatch.setenv("AMGX_BLOCK_NATIVE", "0")
    mj = jx.Matrix(A, block_dim=b)
    mj.device_dtype = dtype
    mp = amgx.Matrix(A, block_dim=b, device="cpu")
    mp.device_dtype = dtype
    return mj, mp


def test_bsr_matrix_views():
    A = _masked20()
    mj, mp = _pair(A, 4)
    assert mp.block_dim == mj.block_dim == 4
    assert mp.shape == mj.shape
    assert (mp.n_block_rows, mp.n_block_cols) == \
        (mj.n_block_rows, mj.n_block_cols) == (7600, 7600)
    assert mp.nnz == mj.nnz
    assert isinstance(mp.host, sp.bsr_matrix)
    np.testing.assert_array_equal(mp.host.indptr, mj.host.indptr)
    np.testing.assert_array_equal(mp.host.indices, mj.host.indices)
    np.testing.assert_array_equal(mp.host.data, mj.host.data)
    assert (mp.scalar_csr() != mj.scalar_csr()).nnz == 0
    with pytest.raises(amgx.errors.BadParametersError):
        amgx.Matrix(sp.identity(10, format="csr"), block_dim=4,
                    device="cpu")


@pytest.mark.parametrize("case,want", [
    ("cfd4", "dia/block"), ("masked20", "ell/binned-block"),
    ("masked20_expansion", "ell/binned"), ("rectangular", "ell/binned-block"),
    ("species5", "dia/block")])
def test_pack_kind_matches_jax(case, want, monkeypatch):
    A, b = {"cfd4": lambda: cfd4(12), "masked20": lambda: (_masked20(), 4),
            "masked20_expansion": lambda: (_masked20(), 4),
            "rectangular": lambda: (_rect_block(), 3),
            "species5": lambda: species5(10)}[case]()
    mj, mp = _pair(A, b, np.float32, native=case != "masked20_expansion",
                   monkeypatch=monkeypatch)
    assert jax_pack_kind(mj.device()) == want
    assert pack_kind(mp.device()) == want


def test_env_knob_equals_pack_device_argument(monkeypatch):
    """``AMGX_BLOCK_NATIVE=0`` on a ``Matrix`` upload gives the pack of
    ``pack_device(..., block_native=False)``."""
    A = _masked20()
    got = pack_device(A, 4, np.float64, block_native=False, device="cpu")
    monkeypatch.setenv("AMGX_BLOCK_NATIVE", "0")
    want = amgx.Matrix(A, block_dim=4, device="cpu").device()
    assert pack_kind(got) == pack_kind(want) == "ell/binned"
    for k in ("bn_codes", "bn_vals", "bn_meta", "bn_pos"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _assert_same_arrays(Ap, Aj, names):
    for k in names:
        a, b = getattr(Ap, k), getattr(Aj, k)
        assert (a is None) == (b is None), k
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_packs_equal_jax(dtype, monkeypatch):
    """Block-DIA planes, block ELL and the binned planes: bit-equal."""
    A, b = cfd4(12)
    mj, mp = _pair(A, b, dtype)
    Aj, Ap = mj.device(), mp.device()
    assert Ap.dia_offsets == Aj.dia_offsets and Ap.block_dim == 4
    _assert_same_arrays(Ap, Aj, ("vals", "diag"))
    B = _masked20()
    mj, mp = _pair(B, 4, dtype)
    Aj, Ap = mj.device(), mp.device()
    assert (Ap.fmt, Ap.ell_width, Ap.bn_dims) == \
        (Aj.fmt, Aj.ell_width, Aj.bn_dims)
    _assert_same_arrays(Ap, Aj, ("cols", "vals", "diag", "bn_codes",
                                 "bn_vals", "bn_meta", "bn_pos"))


def test_block_csr_pack_equal_jax():
    """Past the ELL width budget a block matrix packs as CSR with
    ``row_ids`` and its binned planes (``csr/binned-block``)."""
    A = _rect_block()
    Aj = jax_pack_device(A, 3, np.float64, ell_max_width=2)
    Ap = pack_device(A, 3, np.float64, ell_max_width=2, device="cpu")
    assert Ap.fmt == Aj.fmt == "csr"
    assert pack_kind(Ap) == jax_pack_kind(Aj) == "csr/binned-block"
    _assert_same_arrays(Ap, Aj, ("cols", "vals", "diag", "row_ids",
                                 "bn_codes", "bn_vals", "bn_meta",
                                 "bn_pos"))


def test_dia_arrays_block_matches_jax():
    from amgx_tpu.core.matrix import dia_arrays_block as jax_dab
    A, b = cfd4(10)
    bsr = sp.bsr_matrix(A, blocksize=(b, b))
    got, want = dia_arrays_block(bsr), jax_dab(bsr)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert dia_arrays_block(_masked20(), max_diags=48) is None


def test_matrix_market_roundtrip_equals_jax(tmp_path):
    for case in gauntlet_cases(0.5):
        sysd, path = load_via_matrix_market(case, str(tmp_path))
        want = jax_read_mtx(path, block_dim=case.block_dim)
        assert sysd.block_dim == want.block_dim == case.block_dim
        assert isinstance(sysd.A, type(want.A))
        assert (sp.csr_matrix(sysd.A) != sp.csr_matrix(want.A)).nnz == 0
    A = _rect_block()
    path = str(tmp_path / "rect.mtx")
    rhs = np.random.default_rng(1).standard_normal(A.shape[0])
    write_matrix_market(path, sp.csr_matrix(A), rhs=rhs)
    got = read_matrix_market(path, block_dim=3)
    want = jax_read_mtx(path, block_dim=3)
    assert (sp.csr_matrix(got.A) != sp.csr_matrix(want.A)).nnz == 0
    np.testing.assert_array_equal(got.rhs, want.rhs)
    with pytest.raises(amgx.errors.IOError_):
        read_matrix_market(path, block_dim=4)        # 270 % 4 != 0


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_block_dia_spmv_matches_jax(dtype, tol):
    """``dia/block-slices`` (the CPU form of ``dia/block-kernel``) against
    the JAX package's block-DIA apply, on cfd4 and the bench's 16³
    ``kron(poisson7pt, I₄)``."""
    from amgx_tpu_torch.io import poisson7pt
    cases = [cfd4(12), species5(10),
             (sp.kron(poisson7pt(16, 16, 16), sp.identity(4)).tocsr(), 4)]
    for A, b in cases:
        mj, mp = _pair(A, b, dtype)
        Aj, Ap = mj.device(), mp.device()
        assert pack_kind(Ap) == "dia/block"
        x = np.random.default_rng(2).standard_normal(A.shape[1]).astype(
            dtype)
        yj = np.asarray(jax_spmv(Aj, jnp.asarray(x)), np.float64)
        reset_dispatch()
        yp = spmv(Ap, torch.from_numpy(x))
        assert DISPATCH["dia/block-slices"] == 1 and yp.dtype == \
            torch.from_numpy(x).dtype
        scale = max(np.abs(yj).max(), 1.0)
        assert np.abs(yp.numpy() - yj).max() / scale < tol
        np.testing.assert_allclose(abs_rowsum(Ap).numpy(),
                                   np.asarray(jax_abs_rowsum(Aj)),
                                   rtol=1e-6)


def test_declines_match_jax():
    """A block ELL over the padding budget falls to the block gather
    (``ell/block-gather``), a block CSR to ``csr/block-segsum``, a scalar
    CSR to ``csr/segsum``: plain paths, counted under the JAX labels."""
    n = 20000
    base = sp.csr_matrix((np.ones(n), np.random.default_rng(3).integers(
        0, n, n), np.arange(n + 1)), shape=(n, n)) + sp.identity(n)
    data = np.random.default_rng(4).standard_normal((base.nnz, 2, 2))
    bsr = sp.bsr_matrix((data, base.indices, base.indptr),
                        shape=(2 * n, 2 * n))
    x = np.random.default_rng(5).standard_normal(2 * n)
    for ell_w, label in ((2048, "ell/block-gather"),
                         (1, "csr/block-segsum")):
        Aj = jax_pack_device(bsr, 2, np.float64, dia_max_diags=0,
                             ell_max_width=ell_w)
        Ap = pack_device(bsr, 2, np.float64, dia_max_diags=0,
                         ell_max_width=ell_w, device="cpu")
        assert Ap.bn_codes is None and Aj.bn_codes is None
        reset_dispatch()
        y = spmv(Ap, torch.from_numpy(x)).numpy()
        assert DISPATCH[label] == 1 and label in DECLINES
        np.testing.assert_allclose(y, np.asarray(jax_spmv(
            Aj, jnp.asarray(x))), rtol=1e-12, atol=1e-12)
    Aj = jax_pack_device(base, 1, np.float64, dia_max_diags=0,
                         ell_max_width=1)
    Ap = pack_device(base, 1, np.float64, dia_max_diags=0, ell_max_width=1,
                     device="cpu")
    reset_dispatch()
    y = spmv(Ap, torch.from_numpy(x[:n])).numpy()
    assert DISPATCH["csr/segsum"] == 1
    np.testing.assert_allclose(y, np.asarray(jax_spmv(
        Aj, jnp.asarray(x[:n]))), rtol=1e-12, atol=1e-12)


def test_jax_block_pack_through_interop():
    """A JAX block-DIA and a block-native binned pack carried into the
    port apply as the JAX package applies them."""
    for A, b in (jax_cfd4(12), (_masked20(), 4)):
        Aj = jx.Matrix(A, block_dim=b).device()
        Ap = device_matrix_from_fields(Aj, device="cpu")
        assert pack_kind(Ap) == jax_pack_kind(Aj)
        x = np.random.default_rng(6).standard_normal(A.shape[1])
        np.testing.assert_allclose(
            spmv(Ap, torch.from_numpy(x)).numpy(),
            np.asarray(jax_spmv(Aj, jnp.asarray(x))), rtol=1e-12,
            atol=1e-12)
