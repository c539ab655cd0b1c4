"""Kernels B4's and B5's compact pack (``ops/binned_spmv.py::compact_pack``)
and its plain version (``binned_compact_reference``): derived from the
planes, it keeps every stored entry (block) and no lane of the planes'
segment padding, and its plain version is bit for bit the plain version
of the planes (``binned_spmv_reference``) for b = 2…5 in every type pair
B5 takes and for b = 1 (scalar and scalar-expansion packs) in both of
B4's.  No JAX here: the planes' plain version is held to
the JAX package in tests/test_torch_binned_spmv.py."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu_torch.ops.binned_spmv as bmod
from amgx_tpu_torch.core.matrix import pack_device, pack_kind
from amgx_tpu_torch.io import spe10_block_system
from amgx_tpu_torch.io.gauntlet import elasticity3, jump2, species5

PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
         (torch.float64, torch.float64)]


def _scattered_block(nb, b, density, seed, zero_every=7):
    """Mixed degrees over several 1024-column segments, an explicit zero
    block every ``zero_every`` stored blocks and zero components inside
    blocks: the planes' (tile, segment) groups pad rows, and the pack
    drops every block whose values are all 0."""
    rng = np.random.default_rng(seed)
    base = (sp.random(nb, nb, density=density, random_state=seed,
                      format="csr") + sp.eye(nb)).tocsr()
    base.sort_indices()
    data = rng.standard_normal((base.nnz, b, b))
    data[rng.random(data.shape) < 0.1] = 0.0
    data[::zero_every] = 0.0
    return sp.bsr_matrix((data, base.indices, base.indptr),
                         shape=(nb * b, nb * b))


def _empty_tiles(b=3):
    """Rows 0..299 empty: the first two tiles hold no entry (their chunk
    is the shared zero block)."""
    rng = np.random.default_rng(5)
    base = sp.random(3000, 3000, density=0.004, random_state=5,
                     format="lil")
    base[:300] = 0
    base = sp.csr_matrix(base)
    data = rng.standard_normal((base.nnz, b, b))
    return sp.bsr_matrix((data, base.indices, base.indptr),
                         shape=(3000 * b, 3000 * b))


CASES = {
    "scattered_b2": lambda: (_scattered_block(2600, 2, 0.004, 1), 2),
    "scattered_b3": lambda: (_scattered_block(2200, 3, 0.004, 2), 3),
    "scattered_b4": lambda: (_scattered_block(2400, 4, 0.003, 3), 4),
    "scattered_b5": lambda: (_scattered_block(1500, 5, 0.005, 4), 5),
    "elasticity3": lambda: elasticity3(10),
    "jump2": lambda: jump2(24),
    "species5": lambda: species5(10),
    "empty_tiles_b3": lambda: (_empty_tiles(3), 3),
    "masked20_b4": lambda: (spe10_block_system(20, 20, 20), 4),
}


def _pack(name):
    A, b = CASES[name]()
    Ad = pack_device(A, b, np.float64, dia_max_diags=0, device="cpu")
    assert pack_kind(Ad) in ("ell/binned-block", "csr/binned-block"), \
        pack_kind(Ad)
    return sp.bsr_matrix(A, blocksize=(b, b)), b, Ad


def _x(n, dt, seed):
    x = np.random.default_rng(seed).standard_normal(n)
    x[::11] = 0.0                       # zero products of stored blocks
    x[1::13] *= -1e-30                  # tiny and negative: ±0 rounding
    return torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("vdt,xdt", PAIRS,
                         ids=["f32.f32", "bf16.f32", "f64.f64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_plain_bit_equal_to_planes(name, vdt, xdt):
    A, b, Ad = _pack(name)
    M = Ad.astype(vdt)
    x = _x(A.shape[1], xdt, seed=len(name))
    ref = bmod.binned_spmv_reference(M.bn_codes, M.bn_vals, M.bn_meta,
                                     M.bn_pos, M.bn_dims, x)
    got = bmod.binned_compact_reference(M.bn_compact, M.bn_pos, M.bn_dims,
                                        x)
    assert got.dtype == ref.dtype == xdt
    assert torch.equal(got, ref)
    # the wrapper's CPU path is that plain version
    assert torch.equal(bmod.binned_spmv(M, x), ref)
    if vdt == torch.float64:
        np.testing.assert_allclose(ref.numpy(), A @ x.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_holds_the_stored_blocks_only(name):
    """Every block with a nonzero value is in the pack once, under its
    own column, in each row's (chunk, slot) order; nothing else is, but
    the slice padding (code −1, value 0) that trails each row."""
    A, b, Ad = _pack(name)
    cp = Ad.bn_compact
    S, n_slices, slots, widest, bb = cp.dims
    assert bb == b and S == 32 // b and cp.codes.numel() == slots * S
    codes = cp.codes.numpy()
    vals = cp.vals.numpy()
    pad = codes == -1
    assert not vals[pad].any()
    nz_blocks = int((np.abs(A.data).reshape(-1, b * b).sum(1) > 0).sum())
    assert int((~pad).sum()) == nz_blocks
    # the planes' lanes against the compact entries
    lanes = int(Ad.bn_codes.numel())
    assert slots * S < lanes
    # per padded position: its entries in slots 0..count-1, first flagged
    ptr = cp.slice_ptr.numpy().astype(np.int64)
    n_pos = int(Ad.bn_dims[1]) * int(Ad.bn_dims[3])
    rop = (Ad.bn_row_of_pos.numpy() if Ad.bn_row_of_pos is not None
           else np.where(np.arange(n_pos) < Ad.bn_dims[7],
                         np.arange(n_pos), -1))
    bsr = sp.bsr_matrix(A, blocksize=(b, b))
    for p in range(0, n_pos, 37):
        s, r = divmod(p, S)
        e = (np.arange(ptr[s], ptr[s + 1]) * S + r)
        c = codes[e]
        real = c != -1
        k = int(real.sum())
        assert real[:k].all() and not real[k:].any()
        if rop[p] < 0:
            assert k == 0
            continue
        if k:
            assert c[0] < 0
        cols = np.sort(c[:k] & 0x7FFFFFFF)
        row = rop[p]
        lo, hi = bsr.indptr[row], bsr.indptr[row + 1]
        keep = np.abs(bsr.data[lo:hi]).reshape(hi - lo, b * b).sum(1) > 0
        np.testing.assert_array_equal(cols,
                                      np.sort(bsr.indices[lo:hi][keep]))


def test_compact_pack_pads_far_less_than_the_planes():
    """On the 20³ masked SPE10 slice (the config-4 stencil) the compact
    pack holds each stored block once plus its slices' padding: under
    1.5× the blocks, where the planes hold several times as many lanes."""
    A, b, Ad = _pack("masked20_b4")
    cp = Ad.bn_compact
    blocks = A.nnz // 16
    slots_total = cp.codes.numel()
    assert slots_total < 1.5 * blocks
    assert Ad.bn_codes.numel() > 2 * blocks


def test_wide_pack_derives_its_own_compact_pack():
    """The refinement's f64 pack (``Solver._wide_pack``) carries a compact
    pack of its own f64 planes: a value that rounds to 0 in f32 is still
    in it."""
    import amgx_tpu_torch as amgx
    A = spe10_block_system(20, 20, 20).tolil()
    A[0, 4] = 1e-50                     # block (0, 1): 0 in f32
    A = sp.bsr_matrix(sp.csr_matrix(A), blocksize=(4, 4))
    m = amgx.Matrix(A, block_dim=4, device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(
        "config_version=2, solver(out)=PBICGSTAB, out:max_iters=50, "
        "out:monitor_residual=1, out:tolerance=1e-10, "
        "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")
    slv.setup(m)
    assert pack_kind(m.device()) == "ell/binned-block"
    W = slv._wide_pack(np.dtype(np.float64))
    assert W.bn_compact.vals.dtype == torch.float64
    assert int((W.bn_compact.vals == 1e-50).sum()) == 1
    x = torch.ones(A.shape[1], dtype=torch.float64)
    ref = bmod.binned_spmv_reference(W.bn_codes, W.bn_vals, W.bn_meta,
                                     W.bn_pos, W.bn_dims, x)
    assert torch.equal(bmod.binned_spmv(W, x), ref)
    assert ref[0].item() == pytest.approx((A @ np.ones(A.shape[1]))[0],
                                          rel=1e-15, abs=0)


def _scalar_empty_tiles():
    """Rows 0..299 empty (the first two tiles hold no entry)."""
    base = sp.random(3000, 3000, density=0.004, random_state=6,
                     format="lil")
    base[:300] = 0
    return sp.csr_matrix(base)


def _scalar_wide_row():
    """A scalar CSR pack: row 17 holds some 3,000 entries, past the ELL
    budget (2048)."""
    rng = np.random.default_rng(7)
    n, nnz = 20000, 800000
    rows = np.r_[rng.integers(0, n, nnz), np.full(3000, 17)]
    cols = np.r_[rng.integers(0, n, nnz), rng.choice(n, 3000, replace=False)]
    A = sp.csr_matrix((rng.standard_normal(nnz + 3000), (rows, cols)),
                      shape=(n, n))
    A.sum_duplicates()
    assert np.diff(A.indptr).max() > 2048
    return A


SCALAR_CASES = {
    "masked20_expansion": lambda: pack_device(
        spe10_block_system(20, 20, 20), 4, np.float64, dia_max_diags=0,
        device="cpu", block_native=False),
    "empty_tiles_b1": lambda: pack_device(
        _scalar_empty_tiles(), 1, np.float64, ell_max_width=0,
        dia_max_diags=0, device="cpu"),
    "csr_wide_row": lambda: pack_device(
        _scalar_wide_row(), 1, np.float64, device="cpu"),
}


@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["f32.f32", "f64.f64"])
@pytest.mark.parametrize("name", sorted(SCALAR_CASES))
def test_scalar_compact_plain_bit_equal_to_planes(name, dt):
    """B4's compact pack (b = 1, slices of 32 rows): its plain version is
    the planes' bit for bit, it holds every nonzero entry once and
    trailing slice padding only, and fewer slots than the planes have
    lanes."""
    Ad = SCALAR_CASES[name]()
    assert pack_kind(Ad) in ("ell/binned", "csr/binned"), pack_kind(Ad)
    cp = Ad.bn_compact
    assert cp.dims[0] == 32 and cp.dims[4] == 1
    assert cp.codes.numel() < Ad.bn_codes.numel()
    assert int((cp.codes != -1).sum()) == int((Ad.bn_vals != 0).sum())
    M = Ad.astype(dt)
    x = _x(int(Ad.bn_dims[8]), dt, seed=len(name))
    ref = bmod.binned_spmv_reference(M.bn_codes, M.bn_vals, M.bn_meta,
                                     M.bn_pos, M.bn_dims, x)
    got = bmod.binned_compact_reference(M.bn_compact, M.bn_pos, M.bn_dims,
                                        x)
    assert got.dtype == ref.dtype == dt
    assert torch.equal(got, ref)
