"""The port's ELL SpMV (kernel B3) plain version vs the JAX package: the
windowed Pallas TPU kernel run in interpret mode (as
tests/test_pallas_ell.py runs it) in f32, and ``amgx_tpu.spmv`` on ELL
packs in f64 — host packs (square, rectangular P and R) and device-born
packs with self-column padding; plus the wrapper's checks, the dispatch
counters and its refusal to fall back on a CUDA tensor."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from amgx_tpu.core.matrix import pack_device
from amgx_tpu.io import poisson5pt as jax_poisson5pt
from amgx_tpu.ops import pallas_ell
from amgx_tpu.ops.device_pack import device_ell_matrix as jax_device_ell
from amgx_tpu.ops.spmv import spmv as jax_spmv

import amgx_tpu_torch.ops.ell_spmv as emod
from amgx_tpu_torch import native
from amgx_tpu_torch.amg.classical.interpolators import D2Interpolator
from amgx_tpu_torch.amg.classical.selectors import _pmis
from amgx_tpu_torch.amg.classical.strength import AhatStrength
from amgx_tpu_torch.core.matrix import (Matrix, ell_device_matrix,
                                        ell_host_arrays)
from amgx_tpu_torch.errors import BadParametersError, DeviceError
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.ops.device_pack import device_ell_matrix as \
    port_device_ell
from amgx_tpu_torch.ops.ell_spmv import ell_spmv, ell_spmv_reference
from amgx_tpu_torch.ops.spmv import DISPATCH, spmv

#: f32 against the window kernel, relative to max(|y|, 1): the kernel's
#: one-hot MXU picks and the plain gather sum the same products in
#: another order (tests/test_pallas_ell.py holds the kernel to 5e-5
#: against an f64 product; the two f32 results agree far closer)
F32_REL = 1e-5
#: f64 vs f64: the same products summed in another order
F64_REL = 1e-13


class _Cfg:
    def __init__(self):
        self.d = {"strength_threshold": 0.2401, "max_row_sum": 0.9,
                  "interp_truncation_factor": 0.0,
                  "interp_max_elements": 4, "determinism_flag": 1}

    def get(self, k, scope=None):
        return self.d[k]


def _classical_pr(nx=10):
    """(A, P, R, Ac) of one host classical level on a 7-point Poisson."""
    A = sp.csr_matrix(poisson7pt(nx, nx, nx))
    S = AhatStrength(_Cfg(), "s").compute(A)
    cf = _pmis(S, 7)
    P = D2Interpolator(_Cfg(), "s").compute(A, S, cf)
    R = sp.csr_matrix(P.T)
    Ac = sp.csr_matrix(R @ A @ P)
    return A, P, R, Ac


def _cases():
    rng = np.random.default_rng(3)
    n = 1000
    banded = sp.diags(rng.standard_normal((9, n)),
                      [-40, -13, -7, -1, 0, 1, 7, 13, 40],
                      shape=(n, n)).tocsr()
    _, P, R, Ac = _classical_pr(8)
    return {
        "poisson7": sp.csr_matrix(poisson7pt(12, 12, 6)),
        "poisson5": sp.csr_matrix(jax_poisson5pt(40, 30)),
        "banded": banded,
        "rectangular": sp.random(300, 700, density=0.01, random_state=1,
                                 format="csr"),
        "classical_P": P, "classical_R": R, "classical_Ac": Ac,
    }


CASES = _cases()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)


def _port_pack(A, dtype):
    """The port's host ELL pack of ``A`` (whatever its diagonal count)."""
    cols, vals, diag = ell_host_arrays(A, dtype)
    return ell_device_matrix(torch.from_numpy(cols), torch.from_numpy(vals),
                             torch.from_numpy(diag), A.shape[1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_pallas_window_kernel(name, monkeypatch):
    import jax.numpy as jnp
    from amgx_tpu.ops import pallas_shift
    monkeypatch.setattr(pallas_ell, "_INTERPRET", True)
    # the tile-DIA shift pack would otherwise claim banded operators
    monkeypatch.setattr(pallas_shift, "shift_pack", lambda *a, **k: None)
    A = CASES[name]
    Ad = pack_device(sp.csr_matrix(A), 1, np.float32, dia_max_diags=0)
    assert Ad.fmt == "ell" and Ad.win_codes is not None
    x = np.random.default_rng(1).standard_normal(A.shape[1]) \
        .astype(np.float32)
    want = np.asarray(pallas_ell.ell_window_spmv(Ad, jnp.asarray(x)))
    pd = _port_pack(A, np.float32)
    assert pd.fmt == "ell"
    got = ell_spmv_reference(pd.cols, pd.vals, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (A.shape[0],)
    assert _rel(got.numpy(), want) < F32_REL


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax_spmv_f64(name):
    A = CASES[name]
    jd = pack_device(sp.csr_matrix(A), 1, np.float64, dia_max_diags=0)
    assert jd.fmt == "ell"
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    want = np.asarray(jax_spmv(jd, x))
    pd = _port_pack(A, np.float64)
    before = DISPATCH["ell/gather"]
    got = spmv(pd, torch.from_numpy(x))
    assert DISPATCH["ell/gather"] == before + 1
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) < F64_REL
    assert _rel(got.numpy(), A @ x) < F64_REL


@pytest.mark.parametrize("square", [True, False])
def test_self_padded_device_pack_matches_jax(square):
    """A device-born pack: dead entries are −1 or self-columns with value
    0, pad rows carry a unit diagonal; both packages sanitize the same
    arrays and must give the same product."""
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    n, K = 512, 12
    n_cols = n if square else 200
    cols = rng.integers(-1, n_cols, size=(n, K)).astype(np.int32)
    vals = rng.standard_normal((n, K))
    dead = rng.random((n, K)) < 0.3
    rows = np.broadcast_to(np.arange(n)[:, None] % n_cols, (n, K))
    cols = np.where(dead, rows, cols).astype(np.int32)
    vals = np.where(dead | (cols < 0), 0.0, vals)
    vals[-16:] = 0.0
    vals[-16:, 0] = 1.0                      # unit-diagonal pad rows
    cols[-16:, 0] = np.arange(n - 16, n) % n_cols
    jd = jax_device_ell(jnp.asarray(cols), jnp.asarray(vals), n, n_cols,
                        want_window=False, square_diag=square)
    x = rng.standard_normal(n_cols)
    want = np.asarray(jax_spmv(jd, jnp.asarray(x)))
    pd = port_device_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                         n, n_cols, square_diag=square)
    got = spmv(pd, torch.from_numpy(x))
    assert _rel(got.numpy(), want) < F64_REL
    np.testing.assert_array_equal(pd.diag.numpy(), np.asarray(jd.diag))


def test_out_of_range_columns_read_zero():
    cols = torch.tensor([[0, 3, -1], [1, 7, 2]], dtype=torch.int32)
    vals = torch.ones((2, 3), dtype=torch.float64)
    x = torch.arange(1.0, 5.0, dtype=torch.float64)      # n_cols = 4
    assert ell_spmv(cols, vals, x).tolist() == [1 + 4, 2 + 3]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 7, 40, 1498])
def test_dense_rows_match_an_arange_column_table(dt, n):
    """``cols=None`` (dense rows, :func:`dense_matvec`) gives the same
    bits as the ELL pack of the same matrix with column table k ↦ k, and
    in f64 the dense product to 1e-13."""
    from amgx_tpu_torch.ops.ordered import dense_matvec
    rng = np.random.default_rng(n)
    M = torch.from_numpy(rng.standard_normal((n, n))).to(dt)
    x = torch.from_numpy(rng.standard_normal(n)).to(dt)
    cols = torch.arange(n, dtype=torch.int32).expand(n, n).contiguous()
    got = dense_matvec(M, x)
    assert got.dtype == dt and got.shape == (n,)
    assert torch.equal(got, ell_spmv_reference(cols, M, x))
    if dt == torch.float64:
        assert _rel(got.numpy(), M.numpy() @ x.numpy()) < F64_REL


def test_dense_rows_need_a_square_width():
    with pytest.raises(BadParametersError):
        ell_spmv(None, torch.ones((4, 3)), torch.ones(4))
    with pytest.raises(BadParametersError):
        ell_spmv(None, torch.ones(4), torch.ones(4))


def test_width_budget_raises():
    """Past the ELL width budget (a row of more than 2048 entries) the
    scalar ELL pack of kernel B3 is refused and the matrix packs as CSR.
    One full row among 1-entry rows pads its tile's binned planes far
    past the 10× budget, so this one takes the JAX package's decline,
    the segment sum."""
    from amgx_tpu_torch.core.matrix import pack_kind
    n = 2100
    A = sp.lil_matrix((n, n))
    A.setdiag(1.0)
    A[0, :] = 1.0                                        # a 2100-wide row
    Ad = Matrix(sp.csr_matrix(A), device="cpu").device()
    assert pack_kind(Ad) == "csr/segsum"
    x = torch.arange(n, dtype=torch.float64)
    np.testing.assert_allclose(spmv(Ad, x).numpy(),
                               sp.csr_matrix(A) @ x.numpy())


@pytest.mark.parametrize("vdt,xdt", [
    (torch.float32, torch.bfloat16), (torch.float64, torch.float32),
    (torch.float16, torch.float32), (torch.float16, torch.float16)])
def test_unsupported_type_pairs_raise(vdt, xdt):
    """(bf16, f32), (f32, f64) and (bf16, f64) are supported pairs (a
    level of a narrowed hierarchy); a vector narrower than the values,
    or f16 values, are not."""
    with pytest.raises(BadParametersError):
        ell_spmv(torch.zeros((4, 2), dtype=torch.int32),
                 torch.ones((4, 2), dtype=vdt), torch.ones(4, dtype=xdt))


@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
def test_narrow_values_f64_x_widen_exactly(vdt):
    """(f32, f64) and (bf16, f64): a level narrowed by ``hierarchy_dtype``
    under an f64 outer solver.  Each value widens exactly, so y is the
    plain version on the widened values bit for bit, and the f64 product
    of the rounded values; ``ops.spmv`` takes the kernel's path."""
    A = sp.csr_matrix(poisson7pt(6, 5, 4)) \
        - 0.3 * sp.identity(120, format="csr")
    pd = _port_pack(A, np.float32)
    vals = pd.vals.to(vdt)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(120))
    got = ell_spmv(pd.cols, vals, x, emod.ell_row_len(vals))
    assert got.dtype == torch.float64
    assert torch.equal(got, ell_spmv_reference(pd.cols, vals.double(), x))
    An = A.astype(np.float32)
    An.data = torch.from_numpy(An.data).to(vdt).double().numpy()
    assert _rel(got.numpy(), An @ x.numpy()) < F64_REL
    narrow = pd.astype(vdt)
    before = dict(DISPATCH)
    assert torch.equal(spmv(narrow, x), got)
    assert DISPATCH["ell/gather"] == before["ell/gather"] + 1


def test_bad_arguments_raise():
    c = torch.zeros((4, 2), dtype=torch.int32)
    v = torch.ones((4, 2))
    with pytest.raises(BadParametersError):
        ell_spmv(c.long(), v, torch.ones(4))             # int64 columns
    with pytest.raises(BadParametersError):
        ell_spmv(c, torch.ones((4, 3)), torch.ones(4))   # shape mismatch
    with pytest.raises(BadParametersError):
        ell_spmv(torch.zeros((4, 4), dtype=torch.int32)[:, ::2], v,
                 torch.ones(4))                          # not contiguous


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    def no_nvcc():
        raise DeviceError("nvcc not found")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "find_nvcc", no_nvcc)
    monkeypatch.setattr(emod, "_fn", None)
    with pytest.raises(DeviceError):
        emod._kernel()
