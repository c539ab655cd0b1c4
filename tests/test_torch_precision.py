"""The precision policy of the port (``core/precision.py``,
``Solver._apply_precision_knobs``, ``AMGHierarchy._apply_precision_policy``)
against the JAX package's on the CPU, mirroring
``tests/test_mixed_precision.py``: dtype resolution and the promotion
ladder, which packs narrow to bf16, SpMV over bf16 packs (f32
accumulation, ``promote_types(A, x)`` out), the floors, and
``hierarchy_dtype`` / ``krylov_dtype`` / ``tpu_matrix_dtype`` on the
port's paths.

Counts on bf16 hierarchies follow rounding (the two packages narrow
through different chains and invert narrow diagonals differently), so
they are held to the JAX package's own band: at most 1.3× the all-f32
count (``test_mixed_precision.py:203``), in both packages, and within
that same band of each other."""
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.core import precision as jprec
from amgx_tpu.io import poisson7pt as jax_poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.core import precision
from amgx_tpu_torch.core.matrix import ComposedDIA, pack_device, pack_kind
from amgx_tpu_torch.errors import BadParametersError, SolveStatus
from amgx_tpu_torch.io import poisson7pt, spe10_block_system
from amgx_tpu_torch.ops.spmv import spmv

BF16 = torch.bfloat16
JBF16 = np.dtype("bfloat16")
#: the JAX package's iteration band for a bf16 hierarchy
BAND = 1.3

PCG_AMG = (
    "config_version=2, solver(out)=PCG, out:max_iters=400, "
    "out:monitor_residual=1, out:tolerance={tol}, "
    "out:convergence=RELATIVE_INI, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=12, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:min_coarse_rows=16, amg:coarse_solver=DENSE_LU_SOLVER")
HEADLINE = (
    "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
    "out:monitor_residual=1, out:tolerance=1e-8, "
    "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
    "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
    "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
    "amg:cycle=CG, amg:cycle_iters=2, "
    "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
    "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
    "amg:coarse_solver=DENSE_LU_SOLVER")
BF16_HIER = ", amg:hierarchy_dtype=bfloat16"


def _band(a: int, b: int) -> bool:
    return a <= math.ceil(BAND * b) and b <= math.ceil(BAND * a)


def _relres(A, x, b):
    x = x.double().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, dtype=np.float64)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


# ------------------------------------------------------------- the policy
def test_resolve_dtype_names():
    for name in ("default", "float64", "float32", "bfloat16"):
        got, want = precision.resolve_dtype(name), jprec.resolve_dtype(name)
        if want is None:
            assert got is None
        else:
            assert got.itemsize == want.itemsize
    assert precision.resolve_dtype("bfloat16") is BF16
    with pytest.raises(BadParametersError):
        precision.resolve_dtype("float16")


def test_promotion_target_ladder_shape():
    """One residue plane per rung, bounded by the host dtype, none above
    the floor — the JAX package's answers, bf16 as torch's type."""
    f32, f64 = np.dtype(np.float32), np.dtype(np.float64)
    cases = [(BF16, JBF16, f64, 1e-5), (f32, f32, f64, 1e-9),
             (BF16, JBF16, f64, 1e-9), (f32, f32, f32, 1e-9),
             (f32, f32, f64, 1e-4)]
    for dev_t, dev_j, host, tol in cases:
        got = precision.promotion_target(dev_t, host, tol)
        want = jprec.promotion_target(dev_j, host, tol)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.dtype(got) == np.dtype(want)
    assert precision.tolerance_floor(BF16) == pytest.approx(
        jprec.tolerance_floor(JBF16))


def _dia3():
    P = pack_device(sp.csr_matrix(poisson7pt(4, 4, 4)), 1, np.float32,
                    device="cpu")
    return ComposedDIA(P=P, A=P, R=P, diag=P.diag, l1row=P.diag,
                       n_rows=P.n_rows, n_cols=P.n_cols)


@pytest.mark.parametrize("kind,narrows", [
    ("dia", True), ("dia3", True), ("ell", True), ("shift", False),
    ("binned-block", True), ("binned-scalar", False), ("block-dia", True)])
def test_narrowable_pack_per_kind(kind, narrows):
    """The narrowing rule on the port's pack kinds: B1's packs, B5's
    block planes and plain ELL narrow; B4's scalar planes and B2's
    shift packs keep their dtype (the JAX package keeps its f32-only
    layouts)."""
    A = sp.csr_matrix(poisson7pt(8, 8, 8))
    R = sp.random(400, 400, density=0.03, random_state=1, format="csr")
    R = sp.csr_matrix(R + sp.identity(400))
    Bb = sp.bsr_matrix(sp.kron(R, np.ones((3, 3))).tocsr(),
                       blocksize=(3, 3))
    cpu = dict(device="cpu")
    dm = {"dia": lambda: pack_device(A, 1, np.float32, **cpu),
          "dia3": _dia3,
          "ell": lambda: pack_device(R, 1, np.float32, dia_max_diags=0,
                                     **cpu),
          "shift": lambda: pack_device(A, 1, np.float32, dia_max_diags=0,
                                       **cpu),
          "binned-block": lambda: pack_device(Bb, 3, np.float32,
                                              dia_max_diags=0, **cpu),
          "binned-scalar": lambda: pack_device(sp.csr_matrix(Bb), 1,
                                               np.float32,
                                               dia_max_diags=0,
                                               ell_max_width=4, **cpu),
          "block-dia": lambda: pack_device(
              sp.bsr_matrix(sp.kron(A, np.ones((2, 2))).tocsr(),
                            blocksize=(2, 2)), 2, np.float32, **cpu)}[kind]()
    assert precision.narrowable_pack(dm) is narrows, pack_kind(dm) \
        if kind != "dia3" else kind
    cast = precision.device_cast(dm, "bfloat16")
    assert (cast is not dm) is narrows
    if narrows:
        assert cast.dtype == BF16


def test_precision_view_casts_on_device_and_keeps_the_parent():
    m = amgx.Matrix(poisson7pt(8, 8, 8), device="cpu")
    m.device_dtype = np.float32
    parent = m.device()
    v = precision.precision_view(m, "bfloat16")
    assert v is not m and m.device() is parent
    assert v.device().dtype == BF16 and parent.dtype == torch.float32
    assert v._pack_cast_via == np.float32 and v._setup_wide is parent
    assert torch.equal(v.device().vals, parent.vals.to(BF16))
    precision.release_setup_wide(v)
    assert getattr(v, "_setup_wide", None) is None
    # a shift pack may not narrow: the parent itself comes back
    s = amgx.Matrix(sp.csr_matrix(poisson7pt(8, 8, 8)), device="cpu")
    s._dia_checked_max = 10 ** 9          # no DIA: the ELL/shift pack
    assert pack_kind(s.device()) == "ell/shift"
    assert precision.precision_view(s, "bfloat16") is s


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_bf16_spmv_accumulates_f32_like_jax(kind):
    """A bf16 pack × an f32 vector: f32 out, each value widened exactly
    (the plain versions of B1 and B3); against the JAX package's SpMV on
    its bf16 pack of the same values (f32 sums in another order)."""
    from amgx_tpu.core.matrix import pack_device as jax_pack_device
    from amgx_tpu.ops.spmv import spmv as jax_spmv
    if kind == "dia":
        A = sp.csr_matrix(poisson7pt(12, 12, 12))
        kw = {}
    else:
        A = sp.random(1500, 1500, density=0.01, random_state=3,
                      format="csr")
        A = sp.csr_matrix(A + A.T + 8.0 * sp.identity(1500))
        kw = dict(dia_max_diags=0)
    Ap = pack_device(A, 1, np.float32, device="cpu", **kw).astype(BF16)
    Aj = jax_pack_device(A, 1, np.float32, **kw).astype(JBF16)
    x = np.random.default_rng(0).standard_normal(A.shape[0]).astype(
        np.float32)
    y = spmv(Ap, torch.from_numpy(x))
    assert y.dtype == torch.float32
    import jax.numpy as jnp
    yj = np.asarray(jax_spmv(Aj, jnp.asarray(x)))
    assert yj.dtype == np.float32
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-5,
                               atol=1e-5 * np.abs(yj).max())
    # all-bf16: an f32 apply of the bf16 vector, rounded to bf16 once
    xb = torch.from_numpy(x).to(BF16)
    yb = spmv(Ap, xb)
    assert yb.dtype == BF16 and torch.equal(yb, spmv(Ap, xb.float()).to(
        BF16))


# ------------------------------------------------------------- floors
def test_below_floor_without_rung_raises():
    """A bf16 pack under an f32 host asked for 1e-8 has no honest rung:
    BadParametersError, as in the JAX package."""
    A = poisson7pt(8, 8, 8).astype(np.float32)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = "bfloat16"
    slv = amgx.create_solver(PCG_AMG.format(tol="1e-8"))
    slv.setup(m)
    with pytest.raises(BadParametersError, match="precision floor"):
        slv.solve(np.ones(A.shape[0], dtype=np.float32))


def test_bf16_pack_promotes_to_f32_rung():
    """The same pack at an f32-reachable tolerance refines bf16 → f32
    and converges honestly; the JAX package's count within the band."""
    A = poisson7pt(8, 8, 8).astype(np.float32)
    b = np.ones(A.shape[0], dtype=np.float32)
    mj = jx.Matrix(jax_poisson7pt(8, 8, 8).astype(np.float32))
    mj.device_dtype = JBF16
    sj = jx.create_solver(jx.AMGConfig(PCG_AMG.format(tol="1e-4")))
    sj.setup(mj)
    rj = sj.solve(b)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = "bfloat16"
    slv = amgx.create_solver(PCG_AMG.format(tol="1e-4"))
    slv.setup(m)
    assert slv.Ad.dtype == BF16
    refine, wide, _ = slv._promotion_plan()
    assert refine and wide == np.float32
    r = slv.solve(b)
    assert r.status == SolveStatus.SUCCESS and rj.status == 0
    assert _band(r.iterations, rj.iterations), (r.iterations,
                                                rj.iterations)
    assert _relres(A.astype(np.float64), r.x, b.astype(np.float64)) <= 2e-4


# --------------------------------------------------- the hierarchy policy
def test_bf16_hierarchy_band_and_smoother_data():
    """hierarchy_dtype=bfloat16 on PCG + SIZE_2 aggregation at 16³: every
    level bf16, the coarsest f32; the count within 1.3× of the all-f32
    count and of the JAX package's bf16 count; the level's inverted
    diagonal computed from the wide values and stored bf16."""
    A = poisson7pt(16, 16, 16)
    b = np.ones(A.shape[0])
    counts = {}
    for knob in ("", BF16_HIER):
        m = amgx.Matrix(A, device="cpu")
        m.device_dtype = np.float32
        slv = amgx.create_solver(PCG_AMG.format(tol="1e-6") + knob)
        slv.setup(m)
        r = slv.solve(b)
        assert r.status == SolveStatus.SUCCESS
        assert _relres(A, r.x, b) <= 1e-6
        counts[knob] = r.iterations
    mj = jx.Matrix(jax_poisson7pt(16, 16, 16))
    mj.device_dtype = np.float32
    sj = jx.create_solver(jx.AMGConfig(PCG_AMG.format(tol="1e-6")
                                       + BF16_HIER))
    sj.setup(mj)
    rj = sj.solve(b)
    assert counts[BF16_HIER] <= math.ceil(BAND * counts[""])
    assert _band(counts[BF16_HIER], rj.iterations), (counts,
                                                     rj.iterations)
    h = slv.preconditioner.hierarchy
    assert all(lv.Ad.dtype == BF16 for lv in h.levels)
    assert h.coarsest.device().dtype == torch.float32
    lv0 = h.levels[0]
    assert lv0.smoother.dinv.dtype == BF16
    wide = m.device().diag                      # the f32 fine pack's
    want = torch.where(wide != 0, 1.0 / torch.where(wide == 0, 1.0, wide),
                       0.0).to(BF16)
    assert torch.equal(lv0.smoother.dinv, want)
    assert getattr(lv0.A, "_setup_wide", None) is None


def test_full_ladder_reaches_1e12():
    """bf16 hierarchy, f32 Krylov pack (krylov_dtype), f64 refinement:
    1e-12 on 12³, as in the JAX package; counts within the band."""
    A = poisson7pt(12, 12, 12)
    b = np.random.default_rng(11).standard_normal(A.shape[0])
    cfg = PCG_AMG.format(tol="1e-12") + ", krylov_dtype=float32" \
        + BF16_HIER
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jx.Matrix(jax_poisson7pt(12, 12, 12)))
    rj = sj.solve(b)
    slv = amgx.create_solver(cfg)
    slv.setup(amgx.Matrix(A, device="cpu"))
    assert slv.Ad.dtype == torch.float32
    refine, wide, _ = slv._promotion_plan()
    assert refine and wide == np.float64
    r = slv.solve(b)
    assert r.status == SolveStatus.SUCCESS and rj.status == 0
    assert _relres(A, r.x, b) <= 1e-12
    assert _band(r.iterations, rj.iterations), (r.iterations,
                                                rj.iterations)
    assert any(lv.Ad.dtype == BF16
               for lv in slv.preconditioner.hierarchy.levels)


def test_krylov_dtype_sets_the_top_level_pack_only():
    """krylov_dtype is the outer solver's pack dtype (widening rebuilds
    from the host values); the caller's matrix keeps its own."""
    A = poisson7pt(8, 8, 8)
    m = amgx.Matrix(A, device="cpu")
    m.device_dtype = np.float32
    m.device()
    slv = amgx.create_solver(PCG_AMG.format(tol="1e-5")
                             + ", krylov_dtype=float64")
    slv.setup(m)
    assert slv.Ad.dtype == torch.float64 and m.device().dtype == \
        torch.float32
    assert slv.solve(np.ones(512)).status == SolveStatus.SUCCESS
    for lv in slv.preconditioner.hierarchy.levels:
        assert lv.Ad.dtype == torch.float64


CLA = PCG_AMG.format(tol="1e-8").replace(
    "amg:algorithm=AGGREGATION, amg:selector=SIZE_2",
    "amg:algorithm=CLASSICAL, amg:selector=PMIS, amg:interpolator=D2, "
    "amg:strength_threshold=0.2401").replace("BLOCK_JACOBI", "JACOBI_L1")


@pytest.mark.parametrize("case", ["headline", "classical"])
def test_paths_with_bf16_hierarchy_match_jax(case):
    """The headline (GEO, DIA levels: B1's bf16 pair) at 16³ and the
    classical stack's host loop (ELL levels narrowed: B3's bf16 pair) at
    12³, f32 pack, f64 refinement to 1e-8: both converge, counts within
    the band of the JAX package's, the coarsest f32."""
    if case == "headline":
        cfg, side = HEADLINE + BF16_HIER, 16
        mj = jx.io.poisson7pt_device(16, 16, 16, device_dtype=np.float32)
        mp = amgx.io.poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                                       device="cpu")
        want = {"dia"}
    else:
        cfg, side = CLA + BF16_HIER, 12
        mj = jx.Matrix(jax_poisson7pt(12, 12, 12))
        mj.device_dtype = np.float32
        mp = amgx.Matrix(poisson7pt(12, 12, 12), device="cpu")
        mp.device_dtype = np.float32
        want = {"dia", "ell"}
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(mj)
    rj = sj.solve(np.ones(side ** 3))
    slv = amgx.create_solver(cfg)
    slv.setup(mp)
    r = slv.solve(np.ones(side ** 3))
    assert r.status == SolveStatus.SUCCESS and rj.status == 0
    assert _band(r.iterations, rj.iterations), (r.iterations,
                                                rj.iterations)
    h = slv.preconditioner.hierarchy
    fmts = {lv.Ad.fmt for lv in h.levels if lv.Ad.dtype == BF16}
    assert want <= fmts, fmts
    assert h.coarsest.device().dtype == torch.float32


#: the all-f32 count of CLA at 16³ with the pipeline's tail at 300 rows
#: (the port on the CPU; the JAX package takes the same)
CLA_16_F32_ITERS = 20


def test_classical_pipeline_levels_narrow(monkeypatch):
    """The classical device pipeline's levels (16³, its tail cut at 300
    rows): the ``dia3`` level's three streams and the compact ELL levels
    and transfers narrow; the count stays within the band of the all-f32
    count."""
    monkeypatch.setenv("AMGX_PIPELINE_TAIL_ROWS", "300")
    m = amgx.Matrix(poisson7pt(16, 16, 16), device="cpu")
    m.device_dtype = np.float32
    slv = amgx.create_solver(CLA + BF16_HIER)
    slv.setup(m)
    r = slv.solve(np.ones(4096))
    assert r.status == SolveStatus.SUCCESS
    assert _relres(poisson7pt(16, 16, 16), r.x, np.ones(4096)) <= 1e-8
    h = slv.preconditioner.hierarchy
    fmts = [(lv.Ad.fmt, lv.Ad.dtype) for lv in h.levels]
    assert fmts[1] == ("dia3", BF16) and ("ell", BF16) in fmts, fmts
    assert all(getattr(h.levels[1].Ad, k).dtype == BF16 for k in "PAR")
    assert all(lv.P.dtype == BF16 and lv.R.dtype == BF16
               for lv in h.levels)
    assert r.iterations <= math.ceil(BAND * CLA_16_F32_ITERS), \
        r.iterations


def test_tpu_matrix_dtype_bf16_on_block_system():
    """``tpu_matrix_dtype=bfloat16`` on config 4 (PBICGSTAB +
    MULTICOLOR_DILU) over an SPE10 grid at 8³: a precision view whose
    pack is the uploaded f32 pack cast on the device; the bf16 → f32
    rung to 1e-5; the JAX package's count within the band."""
    cfg = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
           "out:monitor_residual=1, out:tolerance=1e-5, "
           "out:convergence=RELATIVE_INI, "
           "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1, "
           "tpu_matrix_dtype=bfloat16")
    A = spe10_block_system(8, 8, 8)
    b = np.ones(A.shape[0])
    mj = jx.Matrix(A, block_dim=4)
    mj.device_dtype = np.float32
    mj.device()
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj._toplevel = True
    sj.setup(mj)
    rj = sj.solve(b)
    m = amgx.Matrix(A, block_dim=4, device="cpu")
    m.device_dtype = np.float32
    parent = m.device()
    slv = amgx.create_solver(cfg)
    slv.setup(m)
    assert slv.A is not m and m.device() is parent
    assert slv.Ad.dtype == BF16 and slv.A._pack_cast_via == np.float32
    r = slv.solve(b)
    assert r.status == SolveStatus.SUCCESS and rj.status == 0
    assert _relres(A, r.x, b) <= 2e-5
    assert _band(r.iterations, rj.iterations), (r.iterations,
                                                rj.iterations)
