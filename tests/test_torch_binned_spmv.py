"""The port's binned sliced-ELL SpMV (kernels B4 and B5) against the JAX
package: the host pack gives bit-equal arrays and dims (scalar and
b = 2…5) and refuses the same matrices over the padding budget; the
plain versions of B4/B5 match the JAX package's ``binned_spmv`` with its
Pallas kernels run in interpret mode (as tests/test_pallas_csr.py runs
them), on the matrices of tests/test_pallas_csr.py and
tests/test_block_kernels.py; plus the dispatch labels, the wrapper's
checks and its refusal to fall back on a CUDA tensor."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from amgx_tpu.core.matrix import pack_device as jax_pack_device
from amgx_tpu.io.gauntlet import scattered_block_operator
from amgx_tpu.ops import pallas_csr

import amgx_tpu_torch.ops.binned_spmv as bmod
from amgx_tpu_torch import native
from amgx_tpu_torch.core.matrix import Matrix, pack_device, pack_kind
from amgx_tpu_torch.errors import BadParametersError, DeviceError
from amgx_tpu_torch.interop import device_matrix_from_fields
from amgx_tpu_torch.ops.spmv import DISPATCH, reset_dispatch, spmv

#: f64 plain version against the interpret-mode kernel, per row relative
#: to Σ_j |a_ij·x_j|: the one-hot pick and the gather sum the same
#: products; 1e-12 leaves room for the order of the b-component adds
F64_REL = 1e-12
#: f32 (and bf16 planes with an f32 x), per row
F32_REL = 1e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_csr, "_INTERPRET", True)
    # the binned pack is what these tests hold: the JAX package's shift
    # and window packs would claim banded scalar matrices first
    from amgx_tpu.ops import pallas_ell, pallas_shift
    monkeypatch.setattr(pallas_shift, "shift_pack", lambda *a, **k: None)
    monkeypatch.setattr(pallas_ell, "ell_window_pack",
                        lambda *a, **k: None)


def _scattered(n, m, density, seed):
    return sp.random(n, m, density=density, random_state=seed,
                     format="csr")


def _scattered_block(nb, b, density=0.02, seed=0):
    """tests/test_block_kernels.py's scattered block system."""
    rng = np.random.default_rng(seed)
    base = (sp.random(nb, nb, density=density, random_state=seed,
                      format="csr")
            + sp.diags(rng.uniform(3.0, 4.0, nb))).tocsr()
    data = rng.standard_normal((base.nnz, b, b))
    return sp.bsr_matrix((data, base.indices, base.indptr),
                         shape=(nb * b, nb * b))


def _wide_rows():
    """tests/test_pallas_csr.py's wide-row case, with the row past the
    ELL width budget (2048): the pack is CSR."""
    rng = np.random.default_rng(9)
    A = _scattered(3000, 3000, 0.01, 9).tolil()
    A[17] = rng.standard_normal(3000) * (rng.random(3000) < 0.8)
    return sp.csr_matrix(A)


def _mixed_degree():
    A = _scattered(4000, 4000, 0.004, 13).tolil()
    rng = np.random.default_rng(13)
    for r in rng.choice(4000, 40, replace=False):
        A[r] = rng.standard_normal(4000) * (rng.random(4000) < 0.05)
    return sp.csr_matrix(A)


SCALAR = {
    "scattered": lambda: _scattered(3000, 3000, 0.01, 1),
    "mtx_like": lambda: (_scattered(1500, 1500, 0.008, 5) + sp.diags(
        np.random.default_rng(5).uniform(3.0, 4.0, 1500))).tocsr(),
    "rectangular": lambda: _scattered(700, 2500, 0.02, 11),
    "mixed_degree": _mixed_degree,
    "wide_rows": _wide_rows,
}
BLOCK = {
    "kron4": lambda: (sp.bsr_matrix(sp.kron(
        _scattered(400, 400, 0.015, 7),
        np.arange(1, 17).reshape(4, 4) / 10.0), blocksize=(4, 4)), 4),
    "scattered_b2": lambda: (_scattered_block(150, 2, seed=2), 2),
    "scattered_b3": lambda: (_scattered_block(150, 3, seed=3), 3),
    "scattered_b4": lambda: (_scattered_block(150, 4, seed=4), 4),
    "scattered_b5": lambda: (_scattered_block(150, 5, seed=5), 5),
    "scattered_block_operator": lambda: (scattered_block_operator(
        1536, 4, density=0.004), 4),
}


def _assert_pack_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    (ga, gd), (wa, wd) = got, want
    assert gd == wd
    assert sorted(ga) == sorted(wa)
    for k in wa:
        assert ga[k].dtype == wa[k].dtype, k
        np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(SCALAR))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_scalar_pack_bit_equal(name, dtype):
    A = sp.csr_matrix(SCALAR[name]())
    A.sort_indices()
    args = (A.indptr, A.indices, A.data.astype(dtype), A.shape[1], dtype)
    _assert_pack_equal(bmod.csr_binned_pack(*args),
                       pallas_csr.csr_binned_pack(*args))
    assert bmod.binned_pad_factor(A.indptr, A.indices, A.shape[1]) == \
        pallas_csr.binned_pad_factor(A.indptr, A.indices, A.shape[1])


@pytest.mark.parametrize("name", sorted(BLOCK))
def test_block_pack_bit_equal(name):
    bsr, b = BLOCK[name]()
    bsr.sort_indices()
    for dtype in (np.float32, np.float64):
        args = (bsr.indptr, bsr.indices, bsr.data.astype(dtype),
                bsr.shape[1] // b, dtype)
        got = bmod.csr_binned_pack(*args, block_dim=b)
        _assert_pack_equal(got,
                           pallas_csr.csr_binned_pack(*args, block_dim=b))
        assert bmod.bn_block_dim(got[1]) == b


@pytest.mark.parametrize("native", [True, False])
def test_refinement_planes_are_the_wide_pack(native, monkeypatch):
    """The f64 operator of an f32 binned pack's refinement: planes packed
    from the host values in f64, bit-equal to the f64 pack's, on the same
    codes; the gather-form arrays are dropped; built once per setup."""
    import amgx_tpu_torch as amgx
    bsr, b = BLOCK["scattered_b3"]()
    monkeypatch.setenv("AMGX_BLOCK_NATIVE", "1" if native else "0")
    m = Matrix(bsr, block_dim=b, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(
        "config_version=2, solver(out)=BICGSTAB, out:max_iters=5, "
        "out:monitor_residual=1, out:tolerance=1e-10")
    slv.setup(m)
    Ad = m.device()
    assert pack_kind(Ad) == ("ell/binned-block" if native else
                             "ell/binned")
    wide = slv._wide_pack(np.dtype(np.float64))
    want = pack_device(bsr, b, np.float64, block_native=native,
                       device="cpu")
    assert wide.bn_dims == want.bn_dims == Ad.bn_dims
    assert wide.vals is None and wide.cols is None
    assert wide.bn_vals.dtype == torch.float64
    assert torch.equal(wide.bn_vals, want.bn_vals)
    assert torch.equal(wide.bn_codes, Ad.bn_codes)
    # the narrow planes round: the wide ones are the exact operator
    assert not torch.equal(Ad.bn_vals.double(), wide.bn_vals)
    x = np.random.default_rng(3).standard_normal(bsr.shape[1])
    np.testing.assert_allclose(
        spmv(wide, torch.from_numpy(x)).numpy(), bsr @ x, rtol=1e-12,
        atol=1e-12)
    assert slv._wide_pack(np.dtype(np.float64)) is wide
    slv.setup(m)
    assert slv._wide_pack(np.dtype(np.float64)) is not wide


def test_both_refuse_over_the_padding_cap():
    # one entry a row in a random one of 20 column segments: every
    # (tile, segment) group pads a 1024-lane chunk for ~6 entries
    n = 20000
    A = sp.csr_matrix((np.ones(n), np.random.default_rng(3).integers(
        0, n, n), np.arange(n + 1)), shape=(n, n))
    pf = pallas_csr.binned_pad_factor(A.indptr, A.indices, A.shape[1])
    assert pf > pallas_csr._PAD_CAP
    args = (A.indptr, A.indices, A.data.astype(np.float32), A.shape[1],
            np.float32)
    assert bmod.csr_binned_pack(*args) is None
    assert pallas_csr.csr_binned_pack(*args) is None
    bsr = sp.bsr_matrix((np.ones((A.nnz, 2, 2)), A.indices, A.indptr),
                        shape=(40000, 40000))
    bargs = (bsr.indptr, bsr.indices, bsr.data, 20000, np.float32)
    assert bmod.csr_binned_pack(*bargs, block_dim=2) is None
    assert pallas_csr.csr_binned_pack(*bargs, block_dim=2) is None


def _row_rel(y, ref, scale):
    d = np.abs(np.asarray(y, np.float64) - ref)
    return float(np.max(np.where(scale > 0, d / np.where(scale > 0, scale,
                                                         1.0), d)))


def _check_plain(A, b, dtype, seed=0, bf16=False):
    """JAX pack (interpret-mode kernel) vs the port's plain version on
    the same arrays carried through ``interop``."""
    Aj = jax_pack_device(A, b, dtype, dia_max_diags=0)
    assert Aj.bn_codes is not None
    Ap = device_matrix_from_fields(Aj, device="cpu")
    x = np.random.default_rng(seed).standard_normal(A.shape[1]).astype(
        np.float64 if dtype == np.float64 else np.float32)
    if bf16:
        Aj = Aj.astype(jnp.bfloat16)
        Ap = Ap.astype(torch.bfloat16)
    yj = np.asarray(pallas_csr.binned_spmv(Aj, jnp.asarray(x)),
                    np.float64)
    yp = bmod.binned_spmv(Ap, torch.from_numpy(x))
    assert yp.dtype == torch.from_numpy(x).dtype
    absA = abs(sp.csr_matrix(A)).astype(np.float64)
    scale = absA @ np.abs(x.astype(np.float64))
    tol = F64_REL if dtype == np.float64 else F32_REL
    assert _row_rel(yp.numpy(), yj, scale) < tol
    return Ap


@pytest.mark.parametrize("name", ["scattered", "rectangular",
                                  "mixed_degree", "wide_rows"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_b4_matches_jax_kernel(name, dtype):
    _check_plain(SCALAR[name](), 1, dtype)


@pytest.mark.parametrize("name", ["kron4", "scattered_b2", "scattered_b3",
                                  "scattered_b5",
                                  "scattered_block_operator"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_b5_matches_jax_kernel(name, dtype):
    bsr, b = BLOCK[name]()
    Ap = _check_plain(bsr, b, dtype)
    assert bmod.bn_block_dim(Ap.bn_dims) == b


def test_plain_b5_bf16_planes_match_jax_kernel():
    bsr, b = BLOCK["scattered_b4"]()
    _check_plain(bsr, b, np.float32, bf16=True)


def test_scalar_expansion_plain_b4_matches_jax_kernel():
    bsr, b = BLOCK["scattered_b3"]()
    Aj = jax_pack_device(bsr, b, np.float64, dia_max_diags=0,
                         block_native=False)
    Ap = device_matrix_from_fields(Aj, device="cpu")
    assert bmod.bn_block_dim(Ap.bn_dims) == 1 and Ap.block_dim == 3
    x = np.random.default_rng(1).standard_normal(bsr.shape[1])
    yj = np.asarray(pallas_csr.binned_spmv(Aj, jnp.asarray(x)))
    yp = spmv(Ap, torch.from_numpy(x)).numpy()
    scale = abs(sp.csr_matrix(bsr)) @ np.abs(x)
    assert _row_rel(yp, yj, scale) < F64_REL


def test_port_pack_dispatch_and_labels():
    """The port's own packs: labels under the JAX names, every apply on
    the plain binned version (CPU tensors), equal to scipy."""
    reset_dispatch()
    A = _wide_rows()
    Ad = Matrix(A, device="cpu").device()
    assert Ad.fmt == "csr" and pack_kind(Ad) == "csr/binned"
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    np.testing.assert_allclose(spmv(Ad, torch.from_numpy(x)).numpy(),
                               A @ x, rtol=1e-12, atol=1e-12)
    bsr, b = BLOCK["scattered_b4"]()
    Ad = pack_device(bsr, b, np.float64, dia_max_diags=0, device="cpu")
    assert pack_kind(Ad) == "ell/binned-block"
    x = np.random.default_rng(3).standard_normal(bsr.shape[1])
    np.testing.assert_allclose(spmv(Ad, torch.from_numpy(x)).numpy(),
                               bsr @ x, rtol=1e-12, atol=1e-12)
    assert DISPATCH["csr/binned"] == 1 and DISPATCH["ell/binned-block"] == 1
    assert bmod.launch_count() == 0             # no kernel on the CPU


def test_tile_ptr_and_row_of_pos():
    A = _mixed_degree()
    Ad = pack_device(A, 1, np.float64, ell_max_width=0, dia_max_diags=0,
                     device="cpu")
    assert pack_kind(Ad) == "csr/binned" and Ad.bn_pos is not None
    C, n_tiles = Ad.bn_dims[0], Ad.bn_dims[1]
    tp = Ad.bn_tile_ptr.numpy()
    c_tile = Ad.bn_meta[:C].numpy()
    assert tp[0] == 0 and tp[-1] == C and len(tp) == n_tiles + 1
    for t in range(n_tiles):
        assert (c_tile[tp[t]:tp[t + 1]] == t).all() and tp[t + 1] > tp[t]
    rop = Ad.bn_row_of_pos.numpy()
    pos = Ad.bn_pos.numpy()
    np.testing.assert_array_equal(rop[pos], np.arange(A.shape[0]))
    assert (rop >= 0).sum() == A.shape[0]


@pytest.mark.parametrize("vdt,xdt,b", [
    (torch.float32, torch.float64, 1), (torch.bfloat16, torch.float32, 1),
    (torch.float64, torch.float32, 4)])
def test_unsupported_type_pairs_raise(vdt, xdt, b):
    bsr = _scattered_block(60, b, seed=1) if b > 1 else \
        _scattered(300, 300, 0.02, 1)
    Ad = pack_device(bsr, b, np.float64, ell_max_width=0, dia_max_diags=0,
                     device="cpu")
    assert Ad.bn_codes is not None
    with pytest.raises(BadParametersError):
        bmod.binned_spmv(Ad.astype(vdt), torch.ones(bsr.shape[1],
                                                    dtype=xdt))


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    def no_nvcc():
        raise DeviceError("nvcc not found")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "find_nvcc", no_nvcc)
    monkeypatch.setattr(bmod, "_fn", None)
    with pytest.raises(DeviceError):
        bmod._kernel()


def test_entries_view_and_abs_rowsum_match_jax():
    """The views of a scalar pack's planes: the entry triplets and the
    absolute row sums equal the JAX package's on the same planes."""
    A = _mixed_degree()
    Aj = jax_pack_device(A, 1, np.float64, dia_max_diags=0,
                         ell_max_width=1)
    assert Aj.fmt == "csr" and Aj.bn_codes is not None
    Ap = device_matrix_from_fields(Aj, device="cpu")
    for got, want in zip(bmod.binned_entries_view(Ap),
                         pallas_csr.binned_entries_view(Aj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(bmod.binned_abs_rowsum(Ap).numpy(),
                               np.asarray(pallas_csr.binned_abs_rowsum(Aj)),
                               rtol=1e-12)
    np.testing.assert_allclose(bmod.binned_abs_rowsum(Ap).numpy(),
                               abs(A).sum(axis=1).A.ravel(), rtol=1e-12)
