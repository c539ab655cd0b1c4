"""Card tier of the port's hand-written kernels: each kernel against its
plain PyTorch version on a CUDA tensor, and the classical solve on the
card.  Every test is marked ``cuda`` and skips without a card; on a
machine with one (and without JAX), run

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package."""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    return torch.device("cuda", 0)


def _rel(got, want):
    d = (got.double() - want.double()).abs().max().item()
    return d / max(want.double().abs().max().item(), 1e-300)


@pytest.mark.parametrize("vdt,xdt", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float32, torch.float64), (torch.float64, torch.float64)])
def test_dia_kernel_matches_plain(card, vdt, xdt):
    from amgx_tpu_torch.ops import dia_spmv as dmod
    g = torch.Generator(device=card).manual_seed(0)
    offsets = (-129, -128, -1, 0, 1, 128, 129)
    vals = torch.randn((7, 20000), dtype=torch.float64, device=card,
                       generator=g).to(vdt)
    x = torch.randn(20000, dtype=torch.float64, device=card,
                    generator=g).to(xdt)
    before = dmod.launch_count()
    y = dmod.dia_spmv(vals, x, offsets)
    torch.cuda.synchronize(card)
    assert dmod.launch_count() == before + 1
    tol = 1e-12 if xdt == torch.float64 else 1e-5
    assert _rel(y, dmod.dia_spmv_reference(vals, x, offsets)) < tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,n,n_cols", [(1, 999, 1000), (4, 5000, 7001),
                                        (27, 3000, 2000), (256, 300, 900)])
def test_ell_kernel_matches_plain(card, dt, K, n, n_cols):
    from amgx_tpu_torch.ops import ell_spmv as emod
    g = torch.Generator(device=card).manual_seed(K)
    cols = torch.randint(-2, n_cols + 2, (n, K), dtype=torch.int32,
                         device=card, generator=g)
    vals = torch.randn((n, K), dtype=torch.float64, device=card,
                       generator=g).to(dt)
    x = torch.randn(n_cols, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = emod.launch_count()
    y = emod.ell_spmv(cols, vals, x)
    torch.cuda.synchronize(card)
    assert emod.launch_count() == before + 1
    tol = 1e-12 if dt == torch.float64 else 1e-5
    assert _rel(y, emod.ell_spmv_reference(cols, vals, x)) < tol


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 64, 1498])
def test_dense_rows_kernel_matches_plain(card, dt, n):
    """B3 over dense rows (the dense coarse solve's inverse): bit-equal
    to its plain version, one counted launch."""
    from amgx_tpu_torch.ops import ell_spmv as emod
    g = torch.Generator(device=card).manual_seed(n)
    M = torch.randn((n, n), dtype=torch.float64, device=card,
                    generator=g).to(dt)
    x = torch.randn(n, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = emod.launch_count()
    y = emod.dense_matvec(M, x)
    torch.cuda.synchronize(card)
    assert emod.launch_count() == before + 1
    assert torch.equal(y, emod.ell_spmv_reference(None, M, x))


def test_classical_solve_on_card_matches_cpu(card):
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt
    from amgx_tpu_torch.ops.spmv import DISPATCH, reset_dispatch
    cfg = ("config_version=2, solver(out)=PCG, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
           "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
           "amg:interpolator=D2, amg:max_iters=1, "
           "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
           "amg:max_levels=16, amg:smoother(sm)=JACOBI_L1, "
           "sm:max_iters=1, amg:presweeps=2, amg:postsweeps=2, "
           "amg:min_coarse_rows=32, amg:coarse_solver=DENSE_LU_SOLVER, "
           "amg:strength_threshold=0.2401")
    out = {}
    for where in ("cuda", "cpu"):
        m = amgx.Matrix(poisson7pt(24, 24, 24), device=where)
        m.device_dtype = np.float32
        s = amgx.create_solver(cfg)
        s.setup(m)
        reset_dispatch()
        r = s.solve(np.ones(24 ** 3))
        out[where] = (r.iterations, dict(DISPATCH), r.x.cpu(),
                      [lv.level_stats()[0]
                       for lv in s.preconditioner.hierarchy.levels])
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][3] == out["cpu"][3]
    d = out["cuda"][1]
    assert d["ell/window"] > 0 and d["ell/gather"] == 0
    assert d["dia/kernel"] > 0 and d["dia/slices"] == 0
    xg, xc = out["cuda"][2], out["cpu"][2]
    assert ((xg - xc).norm() / xc.norm()).item() < 1e-6


def _binned_pack(card, b, seed, empty_rows=0):
    """A scattered b×b (or scalar) binned pack on the card, in f64."""
    import scipy.sparse as sp
    from amgx_tpu_torch.core.matrix import pack_device
    rng = np.random.default_rng(seed)
    base = sp.random(3000, 3000, density=0.004, random_state=seed,
                     format="lil")
    base[:empty_rows] = 0
    base = sp.csr_matrix(base + sp.diags(np.r_[np.zeros(empty_rows),
                                               np.ones(3000 - empty_rows)]))
    if b == 1:
        return pack_device(base, 1, np.float64, ell_max_width=0,
                           dia_max_diags=0, device=card)
    data = rng.standard_normal((base.nnz, b, b))
    bsr = sp.bsr_matrix((data, base.indices, base.indptr),
                        shape=(3000 * b, 3000 * b))
    return pack_device(bsr, b, np.float64, dia_max_diags=0, device=card)


@pytest.mark.parametrize("b,vdt", [
    (b, vdt) for b in (1, 2, 3, 4, 5)
    for vdt in (torch.float32, torch.bfloat16, torch.float64)
    if b > 1 or vdt != torch.bfloat16])        # B4: f32 and f64 planes
def test_binned_kernel_matches_plain(card, b, vdt):
    from amgx_tpu_torch.ops import binned_spmv as bmod
    Ad = _binned_pack(card, b, seed=b, empty_rows=300 if b == 3 else 0)
    assert Ad.bn_codes is not None
    M = Ad.astype(vdt)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    g = torch.Generator(device=card).manual_seed(b)
    x = torch.randn(3000 * b, dtype=torch.float64, device=card,
                    generator=g).to(xdt)
    kern = "B4" if b == 1 else "B5"
    before = bmod.launch_count(kern)
    y = bmod.binned_spmv(M, x)
    torch.cuda.synchronize(card)
    assert bmod.launch_count(kern) == before + 1
    ref = bmod.binned_spmv_reference(M.bn_codes, M.bn_vals, M.bn_meta,
                                     M.bn_pos, M.bn_dims, x)
    tol = 1e-12 if xdt == torch.float64 else 1e-5
    assert _rel(y, ref) < tol


@pytest.mark.parametrize("pdt", [np.float32, np.float64])
def test_config4_solve_on_card_matches_cpu(card, pdt):
    """The card and the CPU take the same iterations, with the f32 pack
    (+ f64 refinement) and with an f64 pack, and agree on x."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import spe10_block_system
    from amgx_tpu_torch.ops.spmv import DISPATCH, reset_dispatch
    cfg = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, "
           "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")
    A = spe10_block_system(20, 20, 20)
    out = {}
    for where in ("cuda", "cpu"):
        m = amgx.Matrix(A, block_dim=4, device=where)
        m.device_dtype = pdt
        s = amgx.create_solver(cfg)
        s.setup(m)
        reset_dispatch()
        r = s.solve(np.ones(A.shape[0]))
        out[where] = (r.iterations, dict(DISPATCH), r.x.cpu())
    assert out["cuda"][0] == out["cpu"][0], (out["cuda"][0],
                                              out["cpu"][0])
    assert out["cuda"][1]["ell/binned-block"] > 0
    xg, xc = out["cuda"][2], out["cpu"][2]
    assert ((xg - xc).norm() / xc.norm()).item() < 1e-6


@pytest.fixture(scope="module")
def dfg320():
    from amgx_tpu_torch.io import dfg_cylinder_pressure
    return dfg_cylinder_pressure(320)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_shift_kernel_matches_plain(card, dfg320, dt):
    """B2 on the DFG operator's shift pack at ny = 320 (67 tiles of Dpad
    16): bit for bit its plain version, in both type pairs."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops import shift_spmv as smod
    m = amgx.Matrix(dfg320, device=card)
    Ad = m.device(np.float64).astype(dt)
    assert amgx.pack_kind(Ad) == "ell/shift"
    assert Ad.sh_dims[:3] == (8192, 67, 16)
    g = torch.Generator(device=card).manual_seed(320)
    x = torch.randn(dfg320.shape[0], dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = smod.launch_count()
    y = smod.shift_spmv(Ad, x)
    torch.cuda.synchronize(card)
    assert smod.launch_count() == before + 1
    ref = smod.shift_spmv_reference(Ad.sh_vals, Ad.sh_diffs, Ad.sh_dims, x,
                                    Ad.n_rows)
    assert torch.equal(y, ref)


def test_dfg320_solve_on_card_matches_cpu(card, dfg320):
    """The slice's stack (the headline config, GEO → SIZE_2, hierarchy cut
    at 10 levels as in ``chip_smoke.py``) with the f32 pack + f64
    refinement at ny = 320: the card and the CPU take the same
    iterations, every fine-level SpMV on the card through B2."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops.spmv import DISPATCH, reset_dispatch
    from chip_smoke import DFG_CFG
    out = {}
    for where in ("cuda", "cpu"):
        m = amgx.Matrix(dfg320, device=where)
        m.device_dtype = np.float32
        s = amgx.create_solver(DFG_CFG)
        s.setup(m)
        reset_dispatch()
        r = s.solve(np.ones(dfg320.shape[0]))
        out[where] = (r.iterations, dict(DISPATCH), r.x.cpu())
    assert out["cuda"][0] == out["cpu"][0], (out["cuda"][0],
                                              out["cpu"][0])
    d = out["cuda"][1]
    assert d["ell/shift"] > 0 and d["ell/window"] > 0
    assert d["ell/gather"] == 0 and d["dia/slices"] == 0
    xg, xc = out["cuda"][2], out["cpu"][2]
    assert ((xg - xc).norm() / xc.norm()).item() < 1e-6
