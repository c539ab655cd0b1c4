"""The port's DIA SpMV plain version vs the JAX package: the Pallas TPU
kernel run in interpret mode (as tests/test_pallas_spmv.py runs it) and
the f64 shifted-slices path; plus the wrapper's argument checks and its
refusal to fall back on a CUDA tensor."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu.ops.pallas_spmv as pk
from amgx_tpu.core.matrix import Matrix as JMatrix
from amgx_tpu.ops.spmv import spmv as jax_spmv

import amgx_tpu_torch.ops.dia_spmv as dmod
from amgx_tpu_torch import native
from amgx_tpu_torch.core.matrix import Matrix
from amgx_tpu_torch.errors import BadParametersError, DeviceError
from amgx_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_reference
from amgx_tpu_torch.ops.spmv import DISPATCH, spmv

#: relative tolerance of f32 accumulation: both sum the diagonals in the
#: same order, so only FMA contraction and rounding of the sum may differ
F32_REL = 1e-6
#: f64 vs f64: the same terms in the same order
F64_REL = 1e-13


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pk, "_INTERPRET", True)


def _dia_csr(n, offsets, seed=0):
    rng = np.random.default_rng(seed)
    mats = [sp.diags(rng.standard_normal(n - abs(o)), o, shape=(n, n))
            for o in offsets]
    return sp.csr_matrix(sum(mats))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.mark.parametrize("vals_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offsets", [
    (-1, 0, 1),
    (-5184, -72, -1, 0, 1, 72, 5184),
    (-129, -128, -127, -1, 0, 1, 127, 128, 129),
])
def test_reference_matches_pallas_kernel(offsets, vals_dtype):
    import jax.numpy as jnp
    n = 16384
    m = JMatrix(_dia_csr(n, offsets))
    m.device_dtype = np.dtype(jnp.bfloat16) if vals_dtype == "bfloat16" \
        else np.float32
    Ad = m.device()
    assert pk.dia_spmv_supported(Ad.n_rows, Ad.dia_offsets, Ad.dtype)
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    want = np.asarray(pk.dia_spmv(Ad, jnp.asarray(x)))
    vals = torch.from_numpy(np.asarray(Ad.vals).astype(np.float32))
    if vals_dtype == "bfloat16":
        vals = vals.to(torch.bfloat16)      # exact: values were bf16
    got = dia_spmv(vals, torch.from_numpy(x), Ad.dia_offsets)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < F32_REL


@pytest.mark.parametrize("n,offsets", [
    (1001, (-31, -1, 0, 1, 31)),
    (333, (-100, -7, 0, 2, 250)),
    (65, (-16, -4, -1, 0, 1, 4, 16)),
])
def test_reference_matches_jax_spmv_f64(n, offsets):
    A = _dia_csr(n, offsets, seed=n)
    jA = JMatrix(A)
    x = np.random.default_rng(2).standard_normal(n)
    want = np.asarray(jax_spmv(jA.device(), x))
    pA = Matrix(A, device="cpu")
    before = DISPATCH["dia/slices"]
    got = spmv(pA.device(), torch.from_numpy(x))
    assert DISPATCH["dia/slices"] == before + 1
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) < F64_REL
    assert _rel(got.numpy(), A @ x) < F64_REL


def test_bf16_vals_f64_x_widens_exactly():
    """(bf16, f64): a bf16 level of ``hierarchy_dtype`` under an f64
    outer solver.  Each value widens exactly, so y is the plain version
    on the widened values bit for bit, and the f64 product of the
    rounded values."""
    n, offsets = 200, (-10, 0, 3)
    A = _dia_csr(n, offsets, seed=5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(n))
    vals16 = Matrix(A, device="cpu").device(np.float32).vals.to(
        torch.bfloat16)
    got = dia_spmv(vals16, x, offsets)
    assert got.dtype == torch.float64
    assert torch.equal(got, dia_spmv_reference(vals16.double(), x, offsets))
    A16 = A.astype(np.float32)
    A16.data = torch.from_numpy(A16.data).to(torch.bfloat16).double().numpy()
    assert _rel(got.numpy(), A16 @ x.numpy()) < F64_REL


def test_f32_vals_f64_x_promotes():
    n, offsets = 200, (-10, 0, 3)
    A = _dia_csr(n, offsets, seed=3)
    x = np.random.default_rng(4).standard_normal(n)
    vals32 = Matrix(A, device="cpu").device(np.float32).vals
    got = dia_spmv(vals32, torch.from_numpy(x), offsets)
    assert got.dtype == torch.float64
    want = (A.astype(np.float32).astype(np.float64)) @ x
    assert _rel(got.numpy(), want) < F64_REL


def test_rectangular_and_out_of_range_columns_read_zero():
    # n_cols < n: columns past len(x) read as zero even where vals != 0
    vals = torch.ones((2, 6), dtype=torch.float64)
    x = torch.arange(1.0, 5.0, dtype=torch.float64)     # n_cols = 4
    got = dia_spmv_reference(vals, x, (-1, 2))
    want = [0 + 3, 1 + 4, 2 + 0, 3 + 0, 4 + 0, 0 + 0]
    assert got.tolist() == want


@pytest.mark.parametrize("vdt,xdt", [
    (torch.float64, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.float16, torch.float32)])
def test_unsupported_type_pairs_raise(vdt, xdt):
    with pytest.raises(BadParametersError):
        dia_spmv(torch.ones((1, 4), dtype=vdt), torch.ones(4, dtype=xdt),
                 (0,))


def test_bad_shapes_raise():
    with pytest.raises(BadParametersError):
        dia_spmv(torch.ones((2, 4)), torch.ones(4), (0,))      # nd mismatch
    with pytest.raises(BadParametersError):
        dia_spmv(torch.ones((49, 4)), torch.ones(4), tuple(range(49)))
    with pytest.raises(BadParametersError):
        dia_spmv(torch.ones((2, 8))[:, ::2], torch.ones(4), (0, 1))


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """The CUDA path has no try/fallback: without a built library and
    without nvcc, fetching the kernel raises."""
    def no_nvcc():
        raise DeviceError("nvcc not found")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "find_nvcc", no_nvcc)
    monkeypatch.setattr(dmod, "_fn", None)
    with pytest.raises(DeviceError):
        dmod._kernel()


#: B1's geometry (csrc/dia_spmv.cu): 256 threads a CTA, each making four
#: rows for 2- and 4-byte values and two for f64 values or nd = 25
_THREADS = 256


def _rows_per_thread(vdt, nd):
    return 2 if vdt.itemsize == 8 or nd == 25 else 4


def _cta_split(n, n_cols, offsets, rows_per_thread):
    """The row ranges of B1's CTAs, each with the kernel's interior test:
    every row i of the CTA (a full one) has 0 ≤ i + off_k < n_cols."""
    rows = _THREADS * rows_per_thread
    lo, hi = min(offsets), max(offsets)
    return [(s, min(s + rows, n),
             s + rows <= n and s + lo >= 0 and s + rows - 1 + hi < n_cols)
            for s in range(0, n, rows)]


def _split_spmv(vals, x, offsets):
    """B1's two paths in plain PyTorch: an interior CTA's rows add every
    term with no column test, an edge CTA's rows skip the out-of-range
    terms; both from +0, diagonal by diagonal, in x's dtype."""
    n, n_cols = vals.shape[1], x.shape[0]
    y = torch.empty(n, dtype=x.dtype)
    for s, e, interior in _cta_split(n, n_cols, offsets,
                                     _rows_per_thread(vals.dtype,
                                                      len(offsets))):
        acc = torch.zeros(e - s, dtype=x.dtype)
        i = torch.arange(s, e)
        for k, o in enumerate(offsets):
            v = vals[k, s:e].to(x.dtype)
            if interior:
                acc = acc + v * x[s + o:e + o]
            else:
                j = i + o
                ok = (j >= 0) & (j < n_cols)
                term = v * x[j.clamp(0, n_cols - 1)]
                acc = torch.where(ok, acc + term, acc)
        y[s:e] = acc
    return y


@pytest.mark.parametrize("vdt,xdt", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float32, torch.float64), (torch.float64, torch.float64)])
@pytest.mark.parametrize("n,n_cols,nd", [
    (5000, 5000, 7), (4099, 4099, 25), (6001, 4500, 9), (3000, 7000, 25),
    (1024, 1024, 3), (777, 777, 48)])
def test_interior_edge_split_bit_equal_to_reference(vdt, xdt, n, n_cols,
                                                    nd):
    """The rows B1 takes on its branch-free interior path and on its
    per-term edge path, written out in plain PyTorch, are bit-equal to
    the plain version on random offsets: n_cols ≠ n both ways, n not
    divisible by 4, the nd = 7 and 25 the paths compile and others; some
    CTAs are interior and some edge wherever n allows both."""
    rng = np.random.default_rng(n + nd)
    span = min(n, n_cols) // 3
    offsets = sorted(rng.choice(np.arange(-span, span), nd,
                                replace=False).tolist())
    vals = torch.from_numpy(rng.standard_normal((nd, n))).to(vdt)
    x = torch.from_numpy(rng.standard_normal(n_cols)).to(xdt)
    rows = _rows_per_thread(vdt, nd)
    split = _cta_split(n, n_cols, offsets, rows)
    if n >= 4 * _THREADS * rows:
        assert any(c[2] for c in split) and not all(c[2] for c in split)
    got = _split_spmv(vals, x, offsets)
    want = dia_spmv_reference(vals, x, offsets)
    assert torch.equal(got, want)
    assert torch.equal(got, dia_spmv(vals, x, offsets))
