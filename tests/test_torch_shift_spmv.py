"""The port's tile-DIA shift SpMV (kernel B2) against the JAX package:
the host pack gives bit-equal planes, meta and dims and refuses the same
matrices (every case of tests/test_pallas_shift.py and the DFG cylinder
operator at ny = 320); the plain version of B2 matches the JAX
package's ``_shift_call`` run in interpret mode (as
tests/test_pallas_shift.py runs it) and scipy; the lean views, the pack
rule, the dispatch label, the wrapper's checks, and the refinement's
wide shift planes."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from amgx_tpu.core.matrix import assemble_device_matrix as jax_assemble
from amgx_tpu.core.matrix import pack_device as jax_pack_device
from amgx_tpu.core.matrix import pack_host_arrays as jax_pack_host_arrays
from amgx_tpu.io import poisson5pt, poisson7pt
from amgx_tpu.ops import pallas_ell, pallas_shift

import amgx_tpu_torch as amgx
import amgx_tpu_torch.ops.shift_spmv as smod
from amgx_tpu_torch import native
from amgx_tpu_torch.core.matrix import Matrix, pack_device, pack_kind
from amgx_tpu_torch.errors import BadParametersError, DeviceError
from amgx_tpu_torch.interop import device_matrix_from_fields
from amgx_tpu_torch.io import dfg_cylinder_pressure
from amgx_tpu_torch.ops.spmv import DISPATCH, abs_rowsum, spmv

#: f32 plain version against the interpret-mode kernel, per row relative
#: to Σ_j |a_ij·x_j|: both add the same products in slot order, but XLA
#: may contract a product and its add into one rounding
F32_REL = 1e-6
#: f64 plain version against scipy's CSR product, per row
F64_REL = 1e-12


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_shift, "_INTERPRET", True)
    # the pack gate in the JAX package's core.matrix reads pallas_ell's
    # flag
    monkeypatch.setattr(pallas_ell, "_INTERPRET", True)


def _randomized(A, seed):
    A = sp.csr_matrix(A)
    A.data = np.random.default_rng(seed).standard_normal(A.nnz)
    return A


def _periodic(n=4000):
    A = sp.diags([2.0] * n).tolil()
    for i in range(n):
        A[i, (i + 1) % n] = -1.0
        A[i, (i - 1) % n] = -1.0
    return sp.csr_matrix(A)


def _scattered():
    n = 2048
    return sp.csr_matrix(sp.random(n, n, density=8 / n, random_state=7,
                                   format="csr") + sp.identity(n))


def _rectangular():
    n, mcols = 128, 1024
    rows = np.repeat(np.arange(n), 2)
    cols = np.concatenate([np.arange(n)[:, None],
                           (np.arange(n) + 800)[:, None]], axis=1)
    return sp.csr_matrix((np.ones(2 * n), (rows, cols.reshape(-1))),
                         shape=(n, mcols))


#: every case of tests/test_pallas_shift.py (name, matrix, packs shift)
CASES = {
    "poisson7_single_tile": (lambda: _randomized(poisson7pt(12, 12, 6), 1),
                             True),
    "poisson7_multi_tile": (lambda: _randomized(poisson7pt(24, 24, 24), 2),
                            True),
    "poisson5_90x70": (lambda: _randomized(poisson5pt(90, 70), 3), True),
    "periodic_4000": (_periodic, True),
    "ragged_tail_37x11": (lambda: _randomized(poisson5pt(37, 11), 5), True),
    "poisson7_10^3": (lambda: _randomized(poisson7pt(10, 10, 10), 8), True),
    "scattered_bails": (_scattered, False),
    "rectangular_bails": (_rectangular, False),
}


def _ell(A):
    """The (cols, vals) ELL arrays of a CSR, as both packages build
    them (padded with column 0, value 0)."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    n = A.shape[0]
    deg = np.diff(A.indptr)
    K = max(int(deg.max()), 1)
    cols = np.zeros((n, K), np.int64)
    vals = np.zeros((n, K), np.float32)
    rows = np.repeat(np.arange(n), deg)
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
    cols[rows, pos] = A.indices
    vals[rows, pos] = A.data
    return cols, vals


def _same_pack(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a["sh_vals"].dtype == b["sh_vals"].dtype
            and np.array_equal(a["sh_vals"], b["sh_vals"])
            and a["sh_meta"].dtype == b["sh_meta"].dtype
            and np.array_equal(a["sh_meta"], b["sh_meta"])
            and tuple(a["_meta"]) == tuple(b["_meta"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_shift_pack_bit_equal(name):
    """``shift_pack`` on the same ELL arrays: planes, meta and dims
    bit-equal, refusals alike."""
    build, packs = CASES[name]
    A = build()
    cols, vals = _ell(A)
    ours = smod.shift_pack(cols, vals, n_cols=A.shape[1])
    theirs = pallas_shift.shift_pack(cols, vals, n_cols=A.shape[1])
    assert (ours is not None) == packs
    assert _same_pack(ours, theirs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_pack_matches_jax(name):
    """Through both packages' pack pipelines (f32, no DIA): the same
    attachment, planes and meta, and the same pack kind."""
    build, packs = CASES[name]
    A = build()
    Aj = jax_pack_device(A, 1, np.float32, dia_max_diags=0)
    Ap = pack_device(A, 1, np.float32, dia_max_diags=0, device="cpu")
    assert (Ap.sh_vals is not None) == (Aj.sh_vals is not None) == packs
    if packs:
        assert np.array_equal(Ap.sh_vals.numpy(), np.asarray(Aj.sh_vals))
        assert np.array_equal(Ap.sh_meta.numpy(), np.asarray(Aj.sh_meta))
        assert Ap.sh_dims == tuple(int(v) for v in Aj.sh_dims)
        assert pack_kind(Ap) == "ell/shift"


def test_dfg_320_pack_matches_jax():
    """The slice's operator at ny = 320: 67 shift tiles of Dpad 16,
    bit-equal to the JAX package's pack; ny = 256 is refused by both (a
    tile holds more than 32 classes)."""
    A = dfg_cylinder_pressure(320)
    cols, vals = _ell(A)
    ours = smod.shift_pack(cols, vals, n_cols=A.shape[0])
    assert ours["_meta"] == (8192, 67, 16, 8320, 561536)
    assert _same_pack(ours, pallas_shift.shift_pack(cols, vals,
                                                    n_cols=A.shape[0]))
    A256 = dfg_cylinder_pressure(256)
    cols, vals = _ell(A256)
    assert smod.shift_pack(cols, vals, n_cols=A256.shape[0]) is None
    assert pallas_shift.shift_pack(cols, vals, n_cols=A256.shape[0]) is None


def _row_rel(y, ref, scale):
    diff = np.abs(np.asarray(y, np.float64) - np.asarray(ref, np.float64))
    return np.max(np.where(scale > 0, diff / np.where(scale > 0, scale, 1),
                           np.where(diff > 0, np.inf, 0.0)))


@pytest.mark.parametrize("name", [n for n, (_, p) in sorted(CASES.items())
                                  if p])
def test_plain_matches_interpret_kernel(name):
    """The plain B2 on the JAX package's own pack (carried across with
    ``interop``) against ``_shift_call`` in interpret mode, f32, each
    row to its own limit; and the f64 plain version against scipy."""
    from amgx_tpu.ops.pallas_shift import shift_spmv as jax_shift_spmv
    A = CASES[name][0]()
    Aj = jax_pack_device(A, 1, np.float32, dia_max_diags=0)
    Ap = device_matrix_from_fields(Aj, device="cpu")
    x = np.random.default_rng(11).standard_normal(A.shape[1]) \
        .astype(np.float32)
    want = np.asarray(jax_shift_spmv(Aj, jnp.asarray(x)))
    got = smod.shift_spmv(Ap, torch.from_numpy(x)).numpy()
    scale = abs(A) @ np.abs(x.astype(np.float64))
    assert _row_rel(got, want, scale) < F32_REL
    # the f32 planes widened hold the matrix rounded to f32
    A32 = sp.csr_matrix(A.astype(np.float32), dtype=np.float64)
    x64 = np.random.default_rng(12).standard_normal(A.shape[1])
    got64 = smod.shift_spmv(Ap.astype(torch.float64),
                            torch.from_numpy(x64)).numpy()
    assert _row_rel(got64, A32 @ x64, abs(A32) @ np.abs(x64)) < F64_REL


def test_plain_version_masks_the_padding():
    """Unused slots decode to columns left of 0 (``−pad − tile·T``) and
    contribute nothing; the last tile's rows past n are not returned."""
    A = _randomized(poisson5pt(37, 11), 5)
    Ad = pack_device(A, 1, np.float64, dia_max_diags=0, device="cpu")
    T, n_tiles, Dpad = Ad.sh_dims[:3]
    meta = Ad.sh_meta.reshape(n_tiles, 2 * Dpad)
    unused = [j for j in range(Dpad) if not meta[0, 2 * j:2 * j + 2].any()]
    assert unused and T > A.shape[0]
    assert Ad.sh_diffs[0, unused[0]].item() == -(T + 128)
    x = np.random.default_rng(3).standard_normal(A.shape[0])
    y = smod.shift_spmv(Ad, torch.from_numpy(x)).numpy()
    assert y.shape == (A.shape[0],)
    np.testing.assert_allclose(y, A @ x, rtol=1e-13, atol=1e-13)


def test_lean_views_match_jax():
    """A shift pack carries no ``cols``/``vals`` (the JAX package's lean
    pack) and serves the JAX package's ELL views: equal values and
    columns, built by the port and carried across from the JAX package's
    own lean pack; ``abs_rowsum`` and the SpMV read them."""
    A = _randomized(poisson7pt(8, 8, 8), 9)
    arrays, meta = jax_pack_host_arrays(A, 1, np.float32, dia_max_diags=0,
                                        lean_win=True)
    assert "sh_vals" in arrays and "vals" not in arrays
    Aj = jax_assemble({k: jnp.asarray(v) for k, v in arrays.items()}, meta)
    Ap = pack_device(A, 1, np.float32, dia_max_diags=0, device="cpu")
    carried = device_matrix_from_fields(Aj, device="cpu")
    for P in (Ap, carried):
        assert P.vals is None and P.cols is None
        assert np.array_equal(P.ell_vals_view().numpy(),
                              np.asarray(Aj.ell_vals_view()))
        assert np.array_equal(P.ell_cols_view().numpy(),
                              np.asarray(Aj.ell_cols_view()))
    A32 = sp.csr_matrix(A.astype(np.float32))
    np.testing.assert_allclose(abs_rowsum(Ap).numpy(),
                               np.asarray(abs(A32).sum(axis=1)).ravel(),
                               rtol=1e-6)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.shape[0]).astype(np.float32))
    assert torch.equal(spmv(Ap, x), spmv(carried, x))


@pytest.mark.parametrize("ny,kind", [(64, "dia"), (320, "ell/shift")])
def test_pack_rule_on_the_dfg_operator(ny, kind):
    """``Matrix.device()`` keeps DIA first (25 diagonals at ny = 64) and
    packs ny = 320 (89 diagonals) as a shift pack, as the JAX package."""
    A = dfg_cylinder_pressure(ny)
    m = Matrix(A, device="cpu")
    m.device_dtype = np.float32
    assert pack_kind(m.device()) == kind
    jm = __import__("amgx_tpu").Matrix(A)
    jm.device_dtype = np.float32
    from amgx_tpu.core.matrix import pack_kind as jax_pack_kind
    assert jax_pack_kind(jm.device()) == kind


def test_scattered_matrices_keep_b3_and_binned():
    """Too scattered for the shift planes: a scalar ELL stays on B3
    (``ell/window``) and a row past the ELL budget on the binned planes
    (``csr/binned``)."""
    m = Matrix(_scattered(), device="cpu")
    assert pack_kind(m.device(np.float32)) == "ell/window"
    A = sp.random(2100, 2100, density=0.3, random_state=1, format="lil") \
        + sp.identity(2100, format="lil")
    A[0, :] = 1.0
    assert pack_kind(Matrix(A, device="cpu").device()) == "csr/binned"


def test_dispatch_label_and_launch_count():
    A = _randomized(poisson5pt(90, 70), 3)
    Ad = pack_device(A, 1, np.float64, dia_max_diags=0, device="cpu")
    before, launches = DISPATCH["ell/shift"], smod.launch_count()
    y = spmv(Ad, torch.ones(A.shape[0], dtype=torch.float64))
    assert DISPATCH["ell/shift"] == before + 1
    assert smod.launch_count() == launches      # the CPU runs no kernel
    np.testing.assert_allclose(y.numpy(), A @ np.ones(A.shape[0]),
                               rtol=1e-13, atol=1e-13)


def test_wrapper_checks():
    A = _randomized(poisson5pt(90, 70), 3)
    Ad = pack_device(A, 1, np.float32, dia_max_diags=0, device="cpu")
    with pytest.raises(BadParametersError):
        smod.shift_spmv(Ad, torch.ones(A.shape[0], dtype=torch.float64))
    with pytest.raises(BadParametersError):
        smod.shift_spmv(Ad, torch.ones(A.shape[0] + 1))


def test_no_fallback_without_nvcc(monkeypatch):
    """A CUDA tensor never takes the plain version: without ``nvcc`` the
    build raises."""
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(smod, "_fn", None)
    monkeypatch.setattr(native, "find_nvcc", lambda: (_ for _ in ()).throw(
        DeviceError("nvcc not found")))
    monkeypatch.setattr(native, "BUILD_DIR",
                        native.BUILD_DIR / "_no_such_build")
    with pytest.raises(DeviceError):
        smod._kernel()


def _banded_tiles(n_tiles=7, T=8192, seed=4):
    """An SPD matrix whose rows in tile t couple to r ± (100 + 7t + 50k),
    k = 0..3: more than 48 global diagonals, at most 32 classes a tile,
    values f32 cannot hold."""
    n = n_tiles * T
    r = np.arange(n)
    rows, cols = [r], [r]
    for k in range(4):
        s = 100 + 7 * (r // T) + 50 * k
        keep = r + s < n
        rows += [r[keep], (r + s)[keep]]
        cols += [(r + s)[keep], r[keep]]
    off = sum(len(c) for c in cols[1:])
    vals = np.concatenate([
        8.0 + np.random.default_rng(seed).uniform(0.05, 0.3, n),
        -np.ones(off)])
    return sp.csr_matrix((vals, (np.concatenate(rows),
                                 np.concatenate(cols))), shape=(n, n))


def test_refinement_wide_shift_planes():
    """The f32 pack + f64 refinement on a shift pack whose values f32
    cannot hold: the wide operator is a lean pack of f64 planes packed
    from the host values (the same slots as the f32 pack), and the solve
    reaches the tolerance, its f64 residuals through B2's plain
    version."""
    from amgx_tpu_torch.core.matrix import ell_host_arrays
    A = _banded_tiles()
    m = Matrix(A, device="cpu")
    m.device_dtype = np.float32
    cfg = ("config_version=2, solver(out)=PCG, out:max_iters=200, "
           "out:monitor_residual=1, out:tolerance=1e-10, "
           "out:convergence=RELATIVE_INI, "
           "out:preconditioner(p)=BLOCK_JACOBI, p:max_iters=1")
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    assert pack_kind(slv.Ad) == "ell/shift"
    Ad64 = slv._wide_pack(np.dtype(np.float64))
    assert Ad64.vals is None and Ad64.cols is None
    assert Ad64.sh_vals.dtype == torch.float64
    assert Ad64.sh_dims == slv.Ad.sh_dims
    cols, vals64, _ = ell_host_arrays(A, np.float64)
    ref = smod.shift_pack(cols, vals64, n_cols=A.shape[0])
    assert np.array_equal(Ad64.sh_vals.numpy(), ref["sh_vals"])
    assert np.array_equal(
        smod.shift_planes_like(cols, vals64, slv.Ad.sh_dims,
                               slv.Ad.sh_diffs.numpy()), ref["sh_vals"])
    before = DISPATCH["ell/shift"]
    r = slv.solve(np.ones(A.shape[0]))
    assert DISPATCH["ell/shift"] > before
    x = r.x.numpy()
    assert r.status == amgx.SolveStatus.SUCCESS and x.dtype == np.float64
    assert np.linalg.norm(1 - A @ x) / np.sqrt(A.shape[0]) <= 1e-10


def _with_tiny_entry(A, row, col):
    """A copy of ``A`` with one more entry, 1e-50 (0 in f32), at
    (row, col)."""
    A = A.tolil(copy=True)
    A[row, col] = 1e-50
    return A.tocsr()


def _refined_pcg(A):
    m = Matrix(A, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(
        "config_version=2, solver(out)=PCG, out:max_iters=200, "
        "out:monitor_residual=1, out:tolerance=1e-10, "
        "out:convergence=RELATIVE_INI, "
        "out:preconditioner(p)=BLOCK_JACOBI, p:max_iters=1")
    slv.setup(m)
    assert pack_kind(slv.Ad) == "ell/shift"
    return slv


def test_refinement_planes_keep_an_f32_underflow_in_its_class():
    """An entry that is 0 in f32 but lies in a class its tile holds
    anyway goes to that class's slot of the f64 planes: the wide
    operator is the exact host operator."""
    A = _banded_tiles()
    A = _with_tiny_entry(A, 5, 5 + 100)          # diff 100: tile 0's class
    slv = _refined_pcg(A)
    Ad64 = slv._wide_pack(np.dtype(np.float64))
    assert Ad64.sh_dims == slv.Ad.sh_dims
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.shape[0]))
    y = smod.shift_spmv(Ad64, x).numpy()
    np.testing.assert_allclose(y, A @ x.numpy(), rtol=1e-12, atol=1e-12)
    assert (Ad64.sh_vals.numpy() == 1e-50).sum() == 1


def test_refinement_planes_refuse_a_class_the_f32_pack_dropped():
    """An entry that is 0 in f32 and alone in its class (a diff no other
    entry of its tile has): the f32 pack has no slot for it, and the
    refinement raises BadParametersError instead of pairing the f64
    planes with another layout."""
    from amgx_tpu_torch.errors import BadParametersError
    A = _with_tiny_entry(_banded_tiles(), 5, 5 + 3)   # diff 3: no class
    slv = _refined_pcg(A)
    with pytest.raises(BadParametersError, match="no class slot"):
        slv._wide_pack(np.dtype(np.float64))
