"""Kernel B2's slice-masked compact pack (``ops/shift_spmv.py::
shift_compact``) and its plain version (``shift_compact_reference``).

On every case of tests/test_torch_shift_spmv.py, on the DFG cylinder
operator's fine level at ny = 64 and 320, on a tile with exactly 32
classes (bit 31 of the mask is int32's sign bit) and on the
refinement's wide f64 planes: the mask and the pointer equal a numpy
recount of the planes, the compact plain version is bit for bit the
planes' plain version (``shift_spmv_reference``) for finite x, and both
match the JAX package's B2 (``_shift_call`` in interpret mode, as
tests/test_pallas_shift.py runs it) to ``F32_REL`` a row.  The periodic
wrap and the ragged tail (n not a multiple of 32 or of T) are cases of
that list.  At ny = 64 a tile of 8192 rows holds more than 32 classes,
so both packages refuse the default pack; the case packs it at
T = 1024, the pack's own tile parameter."""
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from amgx_tpu.ops import pallas_ell, pallas_shift

import amgx_tpu_torch.ops.shift_spmv as smod
from amgx_tpu_torch.core.matrix import pack_device
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.io import dfg_cylinder_pressure

from test_torch_shift_spmv import (CASES, _banded_tiles, _ell, _refined_pcg,
                                   _row_rel, _with_tiny_entry)

#: f32 plain versions against the interpret-mode kernel, per row
#: relative to Σ_j |a_ij·x_j|: both add the same products in slot order,
#: but XLA may contract a product and its add into one rounding
F32_REL = 1e-6
#: f64 plain versions against scipy's CSR product, per row
F64_REL = 1e-12


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_shift, "_INTERPRET", True)
    monkeypatch.setattr(pallas_ell, "_INTERPRET", True)


def _band32():
    """2048 rows coupled to r + d for every d in −16 … 15: one tile of
    exactly 32 classes (Dpad = 32), the last slot in use."""
    n = 2048
    diags = [np.random.default_rng(32 + k).standard_normal(n)
             for k in range(32)]
    return sp.csr_matrix(sp.diags(diags, list(range(-16, 16)),
                                  shape=(n, n)))


#: (matrix, tile rows) of every case the compact pack is derived on
PACKED = {name: (build, smod._TILE) for name, (build, packs)
          in CASES.items() if packs}
PACKED.update({
    "dfg_64_T1024": (lambda: dfg_cylinder_pressure(64), 1024),
    "dfg_320": (lambda: dfg_cylinder_pressure(320), smod._TILE),
    "band_32_classes": (_band32, smod._TILE),
})


def _host_pack(name, dtype=np.float32):
    build, tile = PACKED[name]
    A = build()
    cols, vals = _ell(A)
    p = smod.shift_pack(cols, vals.astype(dtype), tile=tile,
                        n_cols=A.shape[1])
    assert p is not None, name
    return A, p


def _port(p):
    """(planes, diffs, dims, compact) of a host pack, as the upload
    derives them."""
    dims = tuple(int(v) for v in p["_meta"])
    planes = torch.from_numpy(p["sh_vals"])
    diffs = smod.class_diffs(torch.from_numpy(p["sh_meta"]), dims)
    return planes, diffs, dims, smod.shift_compact(planes, dims)


def _recount(planes: np.ndarray, dims):
    """Mask words (as unsigned), slot pointers and values of the compact
    pack, counted in numpy slice by slice."""
    T, n_tiles, Dpad = dims[:3]
    v = planes.reshape(n_tiles, Dpad, T // 32, 32)
    masks, ptr, vals = [], [0], []
    for t in range(n_tiles):
        for s in range(T // 32):
            used = [j for j in range(Dpad) if np.any(v[t, j, s] != 0)]
            masks.append(sum(1 << j for j in used))
            ptr.append(ptr[-1] + len(used))
            vals += [v[t, j, s] for j in used]
    vals = np.concatenate(vals) if vals else np.zeros(0, planes.dtype)
    return np.array(masks, np.int64), np.array(ptr, np.int64), vals


def _check_counts(planes, dims, cp):
    masks, ptr, vals = _recount(planes.numpy(), dims)
    assert cp.mask.dtype == cp.ptr.dtype == torch.int32
    assert np.array_equal(cp.mask.numpy().astype(np.int64) & 0xFFFFFFFF,
                          masks)
    assert np.array_equal(cp.ptr.numpy(), ptr)
    assert cp.vals.dtype == planes.dtype
    assert np.array_equal(cp.vals.numpy(), vals)
    popcounts = np.diff(ptr)
    assert cp.dims == (32, len(masks), int(ptr[-1]),
                       int(popcounts.max()))
    return masks


def _x(n, dt, seed):
    x = np.random.default_rng(seed).standard_normal(n)
    x[::11] = 0.0                       # zero products of stored entries
    x[1::13] *= -1e-30                  # tiny and negative: ±0 rounding
    return torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("name", sorted(PACKED))
def test_mask_and_pointer_match_a_recount(name):
    _, p = _host_pack(name)
    planes, _, dims, cp = _port(p)
    masks = _check_counts(planes, dims, cp)
    if name == "band_32_classes":
        assert dims[2] == 32 and (masks >> 31).any()
        assert (cp.mask < 0).any()      # bit 31: the int32 sign bit


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(PACKED))
def test_compact_plain_bit_equal_to_planes_plain(name, dt):
    A, p = _host_pack(name, np.float64)
    planes, diffs, dims, cp = _port(p)
    planes = planes.to(dt)
    cp = cp.astype(dt)
    x = _x(A.shape[1], dt, 7)
    want = smod.shift_spmv_reference(planes, diffs, dims, x, A.shape[0])
    got = smod.shift_compact_reference(cp, diffs, dims, x, A.shape[0])
    assert got.dtype == dt and got.shape == (A.shape[0],)
    assert torch.equal(got, want)
    assert not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("name", sorted(PACKED))
def test_both_plain_versions_match_interpret_kernel(name):
    """The JAX package's B2 in interpret mode on the same host pack, f32,
    each row to ``F32_REL``; the f64 compact plain version against
    scipy to ``F64_REL``."""
    A, p = _host_pack(name)
    planes, diffs, dims, cp = _port(p)
    Aj = types.SimpleNamespace(
        sh_dims=dims, sh_meta=jnp.asarray(p["sh_meta"]),
        sh_vals=jnp.asarray(p["sh_vals"]), n_rows=A.shape[0],
        n_cols=A.shape[1])
    x = np.random.default_rng(11).standard_normal(A.shape[1]) \
        .astype(np.float32)
    want = np.asarray(pallas_shift.shift_spmv(Aj, jnp.asarray(x)))
    scale = abs(A) @ np.abs(x.astype(np.float64))
    xt = torch.from_numpy(x)
    for got in (smod.shift_compact_reference(cp, diffs, dims, xt,
                                             A.shape[0]),
                smod.shift_spmv_reference(planes, diffs, dims, xt,
                                          A.shape[0])):
        assert _row_rel(got.numpy(), want, scale) < F32_REL
    A32 = sp.csr_matrix(A.astype(np.float32), dtype=np.float64)
    x64 = np.random.default_rng(12).standard_normal(A.shape[1])
    got64 = smod.shift_compact_reference(cp.astype(torch.float64), diffs,
                                         dims, torch.from_numpy(x64),
                                         A.shape[0]).numpy()
    assert _row_rel(got64, A32 @ x64, abs(A32) @ np.abs(x64)) < F64_REL


@pytest.mark.parametrize("name", sorted(CASES))
def test_upload_derives_the_compact_pack(name):
    """``pack_device`` attaches the compact pack of its own planes to
    every shift pack, and none where the pack is refused; the wrapper's
    CPU path is the compact plain version."""
    build, packs = CASES[name]
    A = build()
    Ad = pack_device(A, 1, np.float32, dia_max_diags=0, device="cpu")
    assert (Ad.sh_compact is not None) == packs
    if not packs:
        return
    _check_counts(Ad.sh_vals, Ad.sh_dims, Ad.sh_compact)
    x = _x(A.shape[1], torch.float32, 3)
    assert torch.equal(smod.shift_spmv(Ad, x), smod.shift_spmv_reference(
        Ad.sh_vals, Ad.sh_diffs, Ad.sh_dims, x, Ad.n_rows))


def test_dfg_320_pack_slices():
    """The ny = 320 fine level: 17,152 slices, 85,100 slots (4.96 a
    slice against Dpad 16), at most 7 a slice."""
    Ad = pack_device(dfg_cylinder_pressure(320), 1, np.float32,
                     dia_max_diags=0, device="cpu")
    assert Ad.sh_dims[:3] == (8192, 67, 16)
    assert Ad.sh_compact.dims == (32, 17152, 85100, 7)


def _lone_tiny_slot():
    """A 5-point operator in f64 whose slice 1 (rows 32 … 63) holds a
    single entry of column difference +1, 1e-50 in row 40: in f32 the
    slot of that slice holds only zeros."""
    A = sp.csr_matrix(CASES["poisson5_90x70"][0]())
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    hit = (rows >= 32) & (rows < 64) & (A.indices == rows + 1)
    A.data[hit] = 0.0
    A.data[hit & (rows == 40)] = 1e-50
    return A


def test_astype_keeps_the_mask():
    """f32 → f64 widens the values exactly; f64 → f32 keeps every mask
    bit even where a slot's only value underflows to 0 (a superset of
    the slots in use, never a subset), and the plain versions stay
    bit-equal."""
    A = _lone_tiny_slot()
    Ad = pack_device(A, 1, np.float64, dia_max_diags=0, device="cpu")
    cp64 = Ad.sh_compact
    A32 = Ad.astype(torch.float32)
    cp32 = A32.sh_compact
    assert torch.equal(cp32.mask, cp64.mask)
    assert torch.equal(cp32.ptr, cp64.ptr)
    assert cp32.dims == cp64.dims
    assert torch.equal(cp32.vals, cp64.vals.float())
    # the tiny entry's slot now holds only zeros, its bit is still set
    recount, _, _ = _recount(A32.sh_vals.numpy(), A32.sh_dims)
    word = cp32.mask.numpy().astype(np.int64) & 0xFFFFFFFF
    assert np.all((word & recount) == recount)
    assert np.flatnonzero(word != recount).tolist() == [1]
    x = _x(A.shape[1], torch.float32, 5)
    assert torch.equal(smod.shift_spmv(A32, x), smod.shift_spmv_reference(
        A32.sh_vals, A32.sh_diffs, A32.sh_dims, x, A32.n_rows))
    back = A32.astype(torch.float64).sh_compact
    assert torch.equal(back.mask, cp64.mask)
    assert torch.equal(back.vals, cp32.vals.double())


def test_wide_pack_derives_its_own_compact_pack():
    """The refinement's f64 planes (``shift_planes_like``) of an f32
    pack whose values f32 cannot hold, with an entry that is 0 in f32
    in a class its tile holds anyway: the wide pack's compact pack is
    that of its own planes, it keeps the 1e-50, and its plain version
    is bit for bit the planes' and the exact host operator's product."""
    A = _with_tiny_entry(_banded_tiles(), 5, 5 + 100)
    slv = _refined_pcg(A)
    Ad64 = slv._wide_pack(np.dtype(np.float64))
    cp = Ad64.sh_compact
    assert cp.vals.dtype == torch.float64
    _check_counts(Ad64.sh_vals, Ad64.sh_dims, cp)
    assert (cp.vals.numpy() == 1e-50).sum() == 1
    assert torch.equal(cp.mask, slv.Ad.sh_compact.mask)
    x = _x(A.shape[0], torch.float64, 2)
    y = smod.shift_spmv(Ad64, x)
    assert torch.equal(y, smod.shift_spmv_reference(
        Ad64.sh_vals, Ad64.sh_diffs, Ad64.sh_dims, x, Ad64.n_rows))
    np.testing.assert_allclose(y.numpy(), A @ x.numpy(), rtol=1e-12,
                               atol=1e-12)


def _broken(Ad, **fields):
    import dataclasses
    return dataclasses.replace(
        Ad, sh_compact=dataclasses.replace(Ad.sh_compact, **fields))


def test_wrapper_checks_the_compact_pack():
    """The wrapper validates the arrays the kernel reads: a pack without
    its compact form, a mask or pointer of the wrong type or shape, a
    value array that does not match the slot count or is not
    contiguous, planes and compact values in two types."""
    import dataclasses
    A = CASES["poisson5_90x70"][0]()
    Ad = pack_device(A, 1, np.float32, dia_max_diags=0, device="cpu")
    x = torch.ones(A.shape[0])
    cp = Ad.sh_compact
    bad = [dataclasses.replace(Ad, sh_compact=None),
           _broken(Ad, mask=cp.mask.long()),
           _broken(Ad, ptr=cp.ptr[:-1]),
           _broken(Ad, vals=cp.vals[:-32]),
           _broken(Ad, vals=torch.stack([cp.vals, cp.vals], 1)[:, 0]),
           _broken(Ad, vals=cp.vals.double()),
           dataclasses.replace(Ad, sh_diffs=torch.stack(
               [Ad.sh_diffs, Ad.sh_diffs], 2)[..., 0])]
    assert not bad[4].sh_compact.vals.is_contiguous()
    for B in bad:
        with pytest.raises(BadParametersError):
            smod.shift_spmv(B, x)
    smod.shift_spmv(Ad, x)
