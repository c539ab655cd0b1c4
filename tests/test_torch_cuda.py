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
    (torch.float32, torch.float64), (torch.float64, torch.float64),
    (torch.bfloat16, torch.float64)])
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
    from amgx_tpu_torch.ops.ordered import dense_matvec
    g = torch.Generator(device=card).manual_seed(n)
    M = torch.randn((n, n), dtype=torch.float64, device=card,
                    generator=g).to(dt)
    x = torch.randn(n, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = emod.launch_count()
    y = dense_matvec(M, x)
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
    16): bit for bit both plain versions, the compact pack's and the
    planes', in both type pairs."""
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
    assert torch.equal(y, smod.shift_compact_reference(
        Ad.sh_compact, Ad.sh_diffs, Ad.sh_dims, x, Ad.n_rows))


def _shift_edge_case(case):
    """A scipy CSR for :func:`test_compact_b2_bit_equal_edge_cases`."""
    import scipy.sparse as sp
    from amgx_tpu_torch.io import poisson5pt
    rng = np.random.default_rng(17)
    if case == "band_32_classes":
        n = 2048
        return sp.csr_matrix(sp.diags(
            [rng.standard_normal(n) for _ in range(32)], list(range(-16, 16)),
            shape=(n, n)))
    if case == "periodic":
        n = 4000
        r = np.arange(n)
        return sp.csr_matrix((np.r_[np.full(n, 2.0), -np.ones(2 * n)],
                              (np.r_[r, r, r],
                               np.r_[r, (r + 1) % n, (r - 1) % n])),
                             shape=(n, n))
    A = sp.csr_matrix(poisson5pt(37, 11) if case == "ragged_tail"
                      else poisson5pt(90, 70))
    A.data = rng.standard_normal(A.nnz)
    if case == "lone_tiny_slot":
        # slice 1's only entry of difference +1 is 1e-50: 0 in f32
        rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
        hit = (rows >= 32) & (rows < 64) & (A.indices == rows + 1)
        A.data[hit] = 0.0
        A.data[hit & (rows == 40)] = 1e-50
    return A


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["band_32_classes", "periodic",
                                  "ragged_tail", "lone_tiny_slot"])
def test_compact_b2_bit_equal_edge_cases(card, dt, case):
    """B2 over the compact pack on a tile of exactly 32 classes (mask
    bit 31), a periodic wrap, a ragged tail (407 rows: not a multiple of
    32) and an f64 pack whose one slot of a slice underflows in f32 (a
    mask bit over zeros): bit for bit both plain versions."""
    from amgx_tpu_torch.core.matrix import pack_device, pack_kind
    from amgx_tpu_torch.ops import shift_spmv as smod
    Ad = pack_device(_shift_edge_case(case), 1, np.float64,
                     dia_max_diags=0, device=card)
    assert pack_kind(Ad) == "ell/shift"
    if case == "band_32_classes":
        assert Ad.sh_dims[2] == 32 and (Ad.sh_compact.mask < 0).any()
    M = Ad.astype(dt)
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(M.n_cols, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = smod.launch_count()
    y = smod.shift_spmv(M, x)
    torch.cuda.synchronize(card)
    assert smod.launch_count() == before + 1
    assert torch.equal(y, smod.shift_spmv_reference(
        M.sh_vals, M.sh_diffs, M.sh_dims, x, M.n_rows))
    assert torch.equal(y, smod.shift_compact_reference(
        M.sh_compact, M.sh_diffs, M.sh_dims, x, M.n_rows))


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


@pytest.mark.parametrize("b,vdt", [
    (b, vdt) for b in (2, 3, 4, 5)
    for vdt in (torch.float32, torch.bfloat16, torch.float64)])
def test_compact_b5_bit_equal_to_both_plain_versions(card, b, vdt):
    """B5 over its compact pack: bit for bit its own plain version and
    the plain version of the planes it was derived from."""
    from amgx_tpu_torch.ops import binned_spmv as bmod
    Ad = _binned_pack(card, b, seed=10 + b, empty_rows=300 if b == 3 else 0)
    M = Ad.astype(vdt)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    g = torch.Generator(device=card).manual_seed(b)
    x = torch.randn(3000 * b, dtype=torch.float64, device=card,
                    generator=g).to(xdt)
    before = bmod.launch_count("B5")
    y = bmod.binned_spmv(M, x)
    torch.cuda.synchronize(card)
    assert bmod.launch_count("B5") == before + 1
    assert torch.equal(y, bmod.binned_compact_reference(
        M.bn_compact, M.bn_pos, M.bn_dims, x))
    assert torch.equal(y, bmod.binned_spmv_reference(
        M.bn_codes, M.bn_vals, M.bn_meta, M.bn_pos, M.bn_dims, x))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [11, 33, 256])
def test_ell_row_len_kernel_bit_equal(card, dt, K):
    """B3 stopped at each row's row_len: bit for bit its plain version
    (which reads every slot) and the kernel over all K slots."""
    from amgx_tpu_torch.ops import ell_spmv as emod
    g = torch.Generator(device=card).manual_seed(K)
    n, n_cols = 20000, 30000
    cols = torch.randint(0, n_cols, (n, K), dtype=torch.int32, device=card,
                         generator=g)
    vals = torch.randn((n, K), dtype=torch.float64, device=card,
                       generator=g)
    keep = torch.randint(0, K + 1, (n, 1), device=card, generator=g)
    vals = torch.where(torch.arange(K, device=card) < keep, vals, 0).to(dt)
    vals[::17, 0] = 0                   # zeros inside rows too
    x = torch.randn(n_cols, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    rl = emod.ell_row_len(vals)
    before = emod.launch_count()
    y = emod.ell_spmv(cols, vals, x, rl)
    torch.cuda.synchronize(card)
    assert emod.launch_count() == before + 1
    assert torch.equal(y, emod.ell_spmv_reference(cols, vals, x))
    assert torch.equal(y, emod.ell_spmv(cols, vals, x))


def _graph_case(case, card):
    """A solver set up on the card for one of the three AMG paths."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   poisson7pt_device)
    from chip_smoke import BLOCK_CFG, CFG_CLA, DFG_CFG, HEADLINE_CFG
    if case in ("headline16", "scaled16"):
        A = poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                              device=card)
        cfg = HEADLINE_CFG if case == "headline16" else \
            HEADLINE_CFG + ", amg:error_scaling=2"
    elif case == "elast12":
        from amgx_tpu_torch.io.gauntlet import elasticity3
        host, b = elasticity3(12)
        A = amgx.Matrix(host, block_dim=b, device=card)
        A.device_dtype = np.float32
        cfg = BLOCK_CFG
    else:
        host = poisson7pt(24, 24, 24) if case == "classical24" else \
            dfg_cylinder_pressure(64)
        A = amgx.Matrix(host, device=card)
        A.device_dtype = np.float32
        cfg = CFG_CLA + ", amg:strength_threshold=0.2401" \
            if case == "classical24" else DFG_CFG
    slv = amgx.create_solver(cfg)
    slv.setup(A)
    return slv


GRAPH_CASES = ["headline16", "classical24", "dfg64", "scaled16",
               "elast12"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_replay_equals_eager_application(card, case):
    """One AMG application replayed from its CUDA graph is torch.equal to
    an eager application on the same vector, and a replay returns a tensor
    the next replay leaves alone."""
    slv = _graph_case(case, card)
    pre = slv.preconditioner
    n = slv.Ad.n
    g = torch.Generator(device=card).manual_seed(0)
    r = torch.randn(n, dtype=torch.float64, device=card,
                    generator=g).to(torch.float32)
    first = pre.apply(r)
    assert len(pre.graphs) == 1
    z = pre.apply(r)
    eager = pre._apply_eager(r)
    torch.cuda.synchronize(card)
    assert torch.equal(z, eager) and torch.equal(first, eager)
    z2 = pre.apply(2 * r)
    torch.cuda.synchronize(card)
    assert torch.equal(z, eager) and not torch.equal(z2, z)
    assert len(pre.graphs) == 1
    pre.setup(pre.A)
    assert pre.graphs == {}


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graphed_solve_counts_equal_eager(card, case, monkeypatch):
    """A warm solve through the graph counts the same launches and
    dispatches as the same solve with eager applications, and gives the
    same x bit for bit."""
    from amgx_tpu_torch.utils import cuda_graph as cg
    slv = _graph_case(case, card)
    b = torch.ones(slv.Ad.n, dtype=torch.float64, device=card)
    slv.solve(b)

    def counted():
        for c in cg.counters():
            for k in c:
                c[k] = 0
        res = slv.solve(b)
        torch.cuda.synchronize(card)
        return res, cg.snapshot()

    rg, cnt_g = counted()
    monkeypatch.setattr(slv.preconditioner, "apply",
                        slv.preconditioner._apply_eager)
    re, cnt_e = counted()
    assert rg.iterations == re.iterations
    assert cnt_g == cnt_e
    assert torch.equal(rg.x, re.x)


@pytest.mark.parametrize("vdt,xdt", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float32, torch.float64), (torch.float64, torch.float64)])
@pytest.mark.parametrize("n,n_cols,nd,shift", [
    (262144, 262144, 7, 0), (200003, 200003, 25, 0), (300000, 250000, 9, 0),
    (100000, 180000, 25, 0), (131072, 131072, 7, 1), (5000, 5000, 48, 0)])
def test_dia_kernel_bit_equal_interior_and_edge(card, vdt, xdt, n, n_cols,
                                                nd, shift):
    """B1's interior (branch-free) and edge CTAs: bit for bit its plain
    version at nd = 7 and 25 (compiled with nd known) and at other nd,
    with n_cols ≠ n, n not divisible by 4, and values at a storage
    offset that rules out the vector loads (``shift``)."""
    from amgx_tpu_torch.ops import dia_spmv as dmod
    g = torch.Generator(device=card).manual_seed(n + nd)
    span = min(n, n_cols) // 4
    offsets = sorted(torch.randperm(2 * span, generator=g, device=card)
                     [:nd].sub(span).tolist())
    if nd == 7:
        offsets = [-4096, -64, -1, 0, 1, 64, 4096]
    buf = torch.randn(nd * n + shift, dtype=torch.float64, device=card,
                      generator=g).to(vdt)
    vals = buf[shift:].view(nd, n)
    x = torch.randn(n_cols, dtype=torch.float64, device=card,
                    generator=g).to(xdt)
    before = dmod.launch_count()
    y = dmod.dia_spmv(vals, x, offsets)
    torch.cuda.synchronize(card)
    assert dmod.launch_count() == before + 1
    assert torch.equal(y, dmod.dia_spmv_reference(vals, x, offsets))


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["expansion", "empty_tiles", "wide_row"])
def test_compact_b4_bit_equal_to_both_plain_versions(card, dt, case):
    """B4 over the compact pack (b = 1): bit for bit the plain version of
    the planes and the compact plain version, on the 20³ masked SPE10
    expansion, a pack with empty tiles and a scalar CSR pack with a row
    wider than 2048."""
    import scipy.sparse as sp
    from amgx_tpu_torch.core.matrix import pack_device, pack_kind
    from amgx_tpu_torch.io import spe10_block_system
    from amgx_tpu_torch.ops import binned_spmv as bmod
    if case == "expansion":
        Ad = pack_device(spe10_block_system(20, 20, 20), 4, np.float64,
                         dia_max_diags=0, device=card, block_native=False)
    elif case == "empty_tiles":
        Ad = _binned_pack(card, 1, seed=21, empty_rows=300)
    else:
        rng = np.random.default_rng(7)
        n, nnz = 20000, 800000
        rows = np.r_[rng.integers(0, n, nnz), np.full(3000, 17)]
        cols = np.r_[rng.integers(0, n, nnz),
                     rng.choice(n, 3000, replace=False)]
        A = sp.csr_matrix((rng.standard_normal(nnz + 3000), (rows, cols)),
                          shape=(n, n))
        A.sum_duplicates()
        Ad = pack_device(A, 1, np.float64, device=card)
    assert pack_kind(Ad) in ("ell/binned", "csr/binned")
    M = Ad.astype(dt)
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(int(Ad.bn_dims[8]), dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = bmod.launch_count("B4")
    y = bmod.binned_spmv(M, x)
    torch.cuda.synchronize(card)
    assert bmod.launch_count("B4") == before + 1
    assert torch.equal(y, bmod.binned_spmv_reference(
        M.bn_codes, M.bn_vals, M.bn_meta, M.bn_pos, M.bn_dims, x))
    assert torch.equal(y, bmod.binned_compact_reference(
        M.bn_compact, M.bn_pos, M.bn_dims, x))


@pytest.mark.parametrize("pdt", [np.float32, np.float64])
def test_block_jacobi_solve_on_card_matches_cpu(card, pdt):
    """BLOCK_JACOBI on 4×4 blocks (the guarded block inverse, applied as
    ordered b×b products): the card and the CPU take the same iterations
    on the 20³ masked SPE10 system, x within 1e-6."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import spe10_block_system
    from chip_smoke import CFG_BJ
    A = spe10_block_system(20, 20, 20)
    out = {}
    for where in ("cuda", "cpu"):
        m = amgx.Matrix(A, block_dim=4, device=where)
        m.device_dtype = pdt
        s = amgx.create_solver(CFG_BJ)
        s.setup(m)
        assert s.preconditioner.dinv.shape[1:] == (4, 4)
        r = s.solve(np.ones(A.shape[0]))
        assert r.status == amgx.SolveStatus.SUCCESS
        out[where] = (r.iterations, r.x.cpu())
    assert out["cuda"][0] == out["cpu"][0], (out["cuda"][0], out["cpu"][0])
    xg, xc = out["cuda"][1], out["cpu"][1]
    assert ((xg - xc).norm() / xc.norm()).item() < 1e-6


def _nested(where):
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt_device
    from chip_smoke import NESTED_CFG
    A = poisson7pt_device(16, 16, 16, device_dtype=np.float32, device=where)
    slv = amgx.create_solver(NESTED_CFG)
    slv.setup(A)
    return slv


def test_nested_amg_replay_equals_eager_and_counts(card):
    """An AMG as the coarse solver of the graphed AMG: the outer graph
    holds the inner cycle's kernels (no inner graph is built with it), a
    replay is bit-equal to an eager application and credits its
    launches."""
    from amgx_tpu_torch.solvers.amg_solver import AMGSolver
    from amgx_tpu_torch.utils import cuda_graph as cg
    slv = _nested(card)
    pre = slv.preconditioner
    inner = pre.hierarchy.coarse_solver
    assert isinstance(inner, AMGSolver)
    g = torch.Generator(device=card).manual_seed(0)
    r = torch.randn(slv.Ad.n, dtype=torch.float64, device=card,
                    generator=g).to(torch.float32)
    first = pre.apply(r)
    assert len(pre.graphs) == 1 and inner.graphs == {}
    for c in cg.counters():
        for k in c:
            c[k] = 0
    z = pre.apply(r)
    torch.cuda.synchronize(card)
    replay = cg.snapshot()
    for c in cg.counters():
        for k in c:
            c[k] = 0
    eager = pre._apply_eager(r)
    torch.cuda.synchronize(card)
    assert cg.snapshot() == replay
    assert torch.equal(z, eager) and torch.equal(first, eager)


def test_nested_amg_solve_on_card_matches_cpu(card):
    """The nested-AMG headline at 16³ with the f32 pack: the card (outer
    graph replays) takes the CPU's iterations with x bit-equal."""
    out = {}
    for where in ("cuda", "cpu"):
        r = _nested(where).solve(np.ones(16 ** 3))
        out[where] = (r.iterations, r.x.cpu())
    assert out["cuda"][0] == out["cpu"][0] == 16, (out["cuda"][0],
                                                   out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def _family_checks():
    """One small stack per solver name of the solver-family slice (the
    shapes of chip_smoke phase 28, smaller): (cfg, make(where), n)."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import (dfg_cylinder_pressure, poisson7pt,
                                   poisson7pt_device, spe10_block_system)
    from chip_smoke import (CFG4, CFG_CLA, CHEB_NOPREC_CFG, HEADLINE_CFG,
                            IDR_DILU_CFG, ILU_CFG, MCGS_CFG)

    def host(A, b=1):
        def make(where):
            m = amgx.Matrix(A, block_dim=b, device=where)
            m.device_dtype = np.float32
            return m
        return make, A.shape[0]

    def gen(where):
        return poisson7pt_device(12, 12, 12, device_dtype=np.float32,
                                 device=where)

    cla = CFG_CLA + ", amg:strength_threshold=0.2401"
    out = {}
    for name in ("GMRES", "PCGF", "PCG_CA", "PCG_PIPE"):
        out[name] = (cla.replace("solver(out)=PCG", f"solver(out)={name}"),
                     lambda: host(poisson7pt(16, 16, 16)))
    for mode in ("CA", "PIPELINED"):
        out[f"PCG-{mode}"] = (cla + f", out:krylov_comm={mode}",
                              lambda: host(poisson7pt(16, 16, 16)))
    out["CF_JACOBI"] = (cla.replace("JACOBI_L1", "CF_JACOBI"),
                        lambda: host(poisson7pt(16, 16, 16)))
    for sm in ("CHEBYSHEV_POLY", "POLYNOMIAL", "KPZ_POLYNOMIAL",
               "CHEBYSHEV", "MULTICOLOR_GS", "GS", "FIXCOLOR_GS",
               "KACZMARZ", "MULTICOLOR_ILU"):
        out[sm] = (HEADLINE_CFG.replace("BLOCK_JACOBI", sm),
                   lambda: (gen, 12 ** 3))
    # PCGF: CG whose inner products are ordered on both devices
    out["NOSOLVER"] = (
        CFG_CLA.split(", out:preconditioner")[0].replace(
            "solver(out)=PCG", "solver(out)=PCGF")
        + ", out:preconditioner(p)=NOSOLVER",
        lambda: host(poisson7pt(16, 16, 16)))
    out["NOSOLVER-smoother"] = (HEADLINE_CFG.replace("BLOCK_JACOBI",
                                                     "NOSOLVER"),
                                lambda: (gen, 12 ** 3))
    out["CHEBYSHEV-noprec"] = (CHEB_NOPREC_CFG.format(it=40),
                               lambda: (gen, 12 ** 3))
    blk = lambda: host(spe10_block_system(8, 8, 8), 4)
    out["IDR"] = (IDR_DILU_CFG, blk)
    out["IDRMSYNC"] = (IDR_DILU_CFG.replace("=IDR", "=IDRMSYNC"), blk)
    out["MULTICOLOR_GS-block"] = (MCGS_CFG, blk)
    out["KACZMARZ-block"] = (CFG4.replace("MULTICOLOR_DILU", "KACZMARZ"),
                             blk)
    out["MULTICOLOR_ILU-dfg"] = (ILU_CFG,
                                 lambda: host(dfg_cylinder_pressure(16)))
    return out


FAMILY_CASES = ["CF_JACOBI", "CHEBYSHEV", "CHEBYSHEV-noprec",
                "CHEBYSHEV_POLY", "FIXCOLOR_GS", "GMRES", "GS", "IDR",
                "IDRMSYNC", "KACZMARZ", "KACZMARZ-block", "KPZ_POLYNOMIAL",
                "MULTICOLOR_GS", "MULTICOLOR_GS-block", "MULTICOLOR_ILU",
                "MULTICOLOR_ILU-dfg", "NOSOLVER", "PCG-CA", "PCG-PIPELINED",
                "PCGF", "PCG_CA", "PCG_PIPE", "POLYNOMIAL"]


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_family_solve_on_card_matches_cpu(card, case):
    """Each solver name of the solver-family slice on the card against
    the same stack on the CPU (f32 pack, f64 refinement): equal
    iterations, x within chip_smoke.SMALL_X_RTOL and bit-equal, except
    IDRMSYNC, whose s × s solves are library calls."""
    import amgx_tpu_torch as amgx
    from chip_smoke import small_card_vs_cpu
    cfg, mk = _family_checks()[case]
    make, n = mk()
    small_card_vs_cpu(amgx, case, cfg, make, n,
                      bit_equal=case != "IDRMSYNC")


FAMILY_GRAPH_SMOOTHERS = ["CHEBYSHEV", "CHEBYSHEV_POLY", "CF_JACOBI",
                          "FIXCOLOR_GS", "GS", "KACZMARZ", "KPZ_POLYNOMIAL",
                          "MULTICOLOR_GS", "MULTICOLOR_ILU", "NOSOLVER",
                          "POLYNOMIAL"]


@pytest.mark.parametrize("sm", FAMILY_GRAPH_SMOOTHERS)
def test_family_smoother_graph_replay_equals_eager(card, sm):
    """An AMG application with one of the slice's smoothers, replayed from
    its CUDA graph, is torch.equal to an eager application, and credits
    the eager application's launches."""
    from amgx_tpu_torch.utils import cuda_graph as cg
    cfg, mk = _family_checks()["NOSOLVER-smoother" if sm == "NOSOLVER"
                               else sm]
    make, n = mk()
    import amgx_tpu_torch as amgx
    slv = amgx.create_solver(cfg)
    slv.setup(make(card))
    pre = slv.preconditioner
    g = torch.Generator(device=card).manual_seed(1)
    r = torch.randn(n, dtype=torch.float64, device=card,
                    generator=g).to(torch.float32)
    first = pre.apply(r)
    assert len(pre.graphs) == 1

    def counted(fn):
        for c in cg.counters():
            for k in c:
                c[k] = 0
        z = fn(r)
        torch.cuda.synchronize(card)
        return z, cg.snapshot()

    z, cnt_g = counted(pre.apply)
    eager, cnt_e = counted(pre._apply_eager)
    assert torch.equal(z, eager) and torch.equal(first, eager)
    assert cnt_g == cnt_e


def _resetup_case(case, where):
    """A reuse-configured solver of one of the three AMG paths, set up on
    ``where``, with its host matrix and its handle."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import dfg_cylinder_pressure, poisson7pt
    from chip_smoke import CFG_CLA, DFG_CFG, HEADLINE_CFG
    if case == "headline16":
        A, cfg = poisson7pt(16, 16, 16), HEADLINE_CFG
    elif case == "classical24":
        A = poisson7pt(24, 24, 24)
        cfg = CFG_CLA + ", amg:strength_threshold=0.2401"
    else:
        # SIZE_2 named: at ny = 64 the operator has a DIA plan under GEO
        A = dfg_cylinder_pressure(64)
        cfg = DFG_CFG.replace("amg:selector=GEO", "amg:selector=SIZE_2")
    m = amgx.Matrix(A, device=where)
    m.device_dtype = np.float32
    slv = amgx.create_solver(cfg + ", amg:structure_reuse_levels=-1")
    slv.setup(m)
    return slv, A, m


def _drifted(host, k):
    """The values of D_k·A·D_k, D_k = diag(1 + 0.1·u·k), in the entry
    order of ``host`` (a CSR, or a BSR of b×b blocks)."""
    u = np.random.default_rng(5).uniform(size=host.shape[0])
    d = 1.0 + 0.1 * u * k
    b = host.blocksize[0] if hasattr(host, "blocksize") else 1
    rows = np.repeat(np.arange(host.indptr.size - 1), np.diff(host.indptr))
    db = d.reshape(-1, b)
    if b == 1:
        return host.data * d[rows] * d[host.indices]
    return db[rows][:, :, None] * host.data * db[host.indices][:, None, :]


RESETUP_PATHS = {"headline16": "dia_device",
                 "classical24": "classical_device", "dfg64": "host_replay"}


@pytest.mark.parametrize("case", sorted(RESETUP_PATHS))
def test_resetup_replay_equals_eager(card, case):
    """After a values-only resetup the graph captured before it is kept
    (no capture), and its replay is torch.equal to an eager application
    on the refreshed hierarchy, crediting the same launches."""
    from amgx_tpu_torch.utils import cuda_graph as cg
    slv, A, m = _resetup_case(case, card)
    pre = slv.preconditioner
    g = torch.Generator(device=card).manual_seed(1)
    r = torch.randn(A.shape[0], dtype=torch.float64, device=card,
                    generator=g).to(torch.float32)
    before = pre.apply(r)
    graph = next(iter(pre.graphs.values()))
    caps = cg.CAPTURES["count"]
    m.replace_coefficients(_drifted(m.host, 1))
    slv.resetup(m)
    assert pre.hierarchy.last_resetup == RESETUP_PATHS[case]
    assert pre.rebind["graphs_kept"] == 1, pre.rebind
    assert next(iter(pre.graphs.values())) is graph

    def counted(fn):
        for c in cg.counters():
            for k in c:
                c[k] = 0
        out = fn(r)
        torch.cuda.synchronize(card)
        return out, cg.snapshot()

    z, cnt_g = counted(pre.apply)
    e, cnt_e = counted(pre._apply_eager)
    assert cg.CAPTURES["count"] == caps
    assert torch.equal(z, e) and cnt_g == cnt_e
    assert not torch.equal(z, before)


def test_resetup_graphs_kept_on_values_dropped_on_shape(card):
    """A value change keeps the graphs; a change of size (a resetup under
    ``structure_reuse_levels=0``, which coarsens afresh) drops them and
    says why; the next application captures anew."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt
    from amgx_tpu_torch.utils import cuda_graph as cg
    from chip_smoke import HEADLINE_CFG
    slv, A, m = _resetup_case("headline16", card)
    slv.solve(np.ones(A.shape[0]))
    m.replace_coefficients(_drifted(m.host, 2))
    slv.resetup(m)
    assert slv.preconditioner.rebind["graphs_kept"] == 1
    slv2 = amgx.create_solver(HEADLINE_CFG)
    slv2.setup(amgx.Matrix(A, device=card))
    slv2.solve(np.ones(A.shape[0]))
    caps = cg.CAPTURES["count"]
    A3 = poisson7pt(16, 16, 12)
    slv2.resetup(amgx.Matrix(A3, device=card))
    rb = slv2.preconditioner.rebind
    assert rb["graphs_dropped"] == 1 and "became" in rb["drops"][-1]
    assert slv2.preconditioner.graphs == {}
    res = slv2.solve(np.ones(A3.shape[0]))
    assert res.status == amgx.SolveStatus.SUCCESS
    assert cg.CAPTURES["count"] == caps + 1


@pytest.mark.parametrize("case", ["headline16", "config4"])
def test_resetup_solve_on_card_matches_cpu(card, case):
    """Before and after each of two resetups the card takes the CPU's
    iterations with the f32 pack, x bit-equal (the second resetup keeps
    the graph the first solve captured a second time)."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import spe10_block_system
    from chip_smoke import CFG4
    out = {}
    for where in ("cuda", "cpu"):
        if case == "headline16":
            slv, A, m = _resetup_case(case, where)
        else:
            A = spe10_block_system(12, 12, 12)
            m = amgx.Matrix(A, block_dim=4, device=where)
            m.device_dtype = np.float32
            slv = amgx.create_solver(CFG4)
            slv.setup(m)
        got = []
        host0 = m.host.copy()
        for k in (0, 1, 2):
            if k:
                m.replace_coefficients(_drifted(host0, k))
                slv.resetup(m)
            r = slv.solve(np.ones(A.shape[0]))
            assert r.status == amgx.SolveStatus.SUCCESS
            got.append((r.iterations, r.x.cpu()))
        out[where] = got
    for (ig, xg), (ic, xc) in zip(out["cuda"], out["cpu"]):
        assert ig == ic
        assert torch.equal(xg, xc)


# ------------------------------------------------------ the solve boundary
@pytest.mark.parametrize("K,n,n_cols", [(1, 999, 1000), (7, 5000, 7001),
                                        (27, 3000, 2000), (256, 300, 900)])
def test_ell_bf16_pair_bit_equal(card, K, n, n_cols):
    """B3's (bf16, f32) pair: each value widened in registers, summed in
    f32 in the (f32, f32) pair's order — bit-equal to the plain version,
    with and without row_len, one counted launch each."""
    from amgx_tpu_torch.ops import ell_spmv as emod
    g = torch.Generator(device=card).manual_seed(K + 1)
    cols = torch.randint(-2, n_cols + 2, (n, K), dtype=torch.int32,
                         device=card, generator=g)
    vals = torch.randn((n, K), dtype=torch.float64, device=card,
                       generator=g).to(torch.bfloat16)
    keep = torch.randint(0, K + 1, (n, 1), device=card, generator=g)
    vals = torch.where(torch.arange(K, device=card) < keep, vals, 0)
    x = torch.randn(n_cols, dtype=torch.float32, device=card, generator=g)
    ref = emod.ell_spmv_reference(cols, vals, x)
    for rl in (None, emod.ell_row_len(vals)):
        before = emod.LAUNCHES["bf16.f32"]
        y = emod.ell_spmv(cols, vals, x, rl)
        torch.cuda.synchronize(card)
        assert emod.LAUNCHES["bf16.f32"] == before + 1
        assert y.dtype == torch.float32
        assert torch.equal(y, ref)


@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,n,n_cols", [(1, 999, 1000), (7, 5000, 7001),
                                        (27, 3000, 2000), (256, 300, 900)])
def test_ell_f64_widening_pairs_bit_equal(card, vdt, K, n, n_cols):
    """B3's (f32, f64) and (bf16, f64) pairs (a level narrowed by
    ``hierarchy_dtype`` under an f64 outer solver): each value widened
    exactly to f64 — bit-equal to the plain version, with and without
    row_len, one counted launch each."""
    from amgx_tpu_torch.ops import ell_spmv as emod
    g = torch.Generator(device=card).manual_seed(K + 2)
    cols = torch.randint(-2, n_cols + 2, (n, K), dtype=torch.int32,
                         device=card, generator=g)
    vals = torch.randn((n, K), dtype=torch.float64, device=card,
                       generator=g).to(vdt)
    keep = torch.randint(0, K + 1, (n, 1), device=card, generator=g)
    vals = torch.where(torch.arange(K, device=card) < keep, vals, 0)
    x = torch.randn(n_cols, dtype=torch.float64, device=card, generator=g)
    ref = emod.ell_spmv_reference(cols, vals, x)
    key = f"{emod._SHORT[vdt]}.f64"
    for rl in (None, emod.ell_row_len(vals)):
        before = emod.LAUNCHES[key]
        y = emod.ell_spmv(cols, vals, x, rl)
        torch.cuda.synchronize(card)
        assert emod.LAUNCHES[key] == before + 1
        assert y.dtype == torch.float64
        assert torch.equal(y, ref)


@pytest.mark.parametrize("hd", ["float32", "bfloat16"])
def test_narrow_levels_under_f64_launch_kernels(card, hd):
    """ROADMAP C13 on the card: ``hierarchy_dtype`` float32 / bfloat16
    under an f64 outer solver (an f64 upload, SIZE_2 aggregation: a DIA
    fine level, ELL coarse levels) launches B1 and B3 in their (·, f64)
    pairs, counts no decline, and takes the CPU's count, x within 1e-12
    (an f64 inner product is one library reduction)."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    from amgx_tpu_torch.ops import spmv as smod
    A = poisson7pt(12, 12, 12)
    cfg = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
           "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
           "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=20, "
           "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
           "amg:presweeps=1, amg:postsweeps=1, amg:min_coarse_rows=16, "
           f"amg:coarse_solver=DENSE_LU_SOLVER, hierarchy_dtype={hd}")
    short = "f32" if hd == "float32" else "bf16"
    out = {}
    for where in ("cuda", "cpu"):
        s = amgx.create_solver(cfg)
        s.setup(amgx.Matrix(A, device=where))
        smod.reset_dispatch()
        dmod.reset_launches()
        emod.reset_launches()
        r = s.solve(np.ones(A.shape[0]))
        out[where] = (r.iterations, r.x.cpu(), dict(dmod.LAUNCHES),
                      dict(emod.LAUNCHES), dict(smod.declines()))
    it, x, b1, b3, declines = out["cuda"]
    assert x.dtype == torch.float64
    assert b1[f"{short}.f64"] > 0 and b3[f"{short}.f64"] > 0, (b1, b3)
    assert not any(declines.values()), declines
    assert it == out["cpu"][0]
    xc = out["cpu"][1]
    assert (x - xc).norm() <= 1e-12 * xc.norm()


def test_dia_bf16_pair_bit_equal_at_128(card):
    """B1's (bf16, f32) pair on the 128³ operator cast to bf16 (the
    headline's narrowed fine level), bit-equal to its plain version."""
    from amgx_tpu_torch.io import poisson7pt_device
    from amgx_tpu_torch.ops import dia_spmv as dmod
    A = poisson7pt_device(128, 128, 128, device_dtype=np.float32,
                          device="cuda").device().astype(torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(128 ** 3, dtype=torch.float32, device=card,
                    generator=g)
    y = dmod.dia_spmv(A.vals, x, A.dia_offsets)
    assert torch.equal(y, dmod.dia_spmv_reference(A.vals, x,
                                                  A.dia_offsets))


@pytest.mark.parametrize("case", ["headline", "classical"])
def test_bf16_hierarchy_solve_on_card_matches_cpu(card, case):
    """hierarchy_dtype=bfloat16 at 24³: the card takes the CPU's
    iterations and x bit for bit (every bf16 pair is bit-equal to its
    plain version, and the sums keep their order)."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt, poisson7pt_device
    from chip_smoke import BF16_HIER, CFG_CLA, HEADLINE_CFG
    out = {}
    for where in ("cuda", "cpu"):
        if case == "headline":
            m = poisson7pt_device(24, 24, 24, device_dtype=np.float32,
                                  device=where)
            cfg = HEADLINE_CFG + BF16_HIER
        else:
            m = amgx.Matrix(poisson7pt(24, 24, 24), device=where)
            m.device_dtype = np.float32
            cfg = CFG_CLA + ", amg:strength_threshold=0.2401" + BF16_HIER
        s = amgx.create_solver(cfg)
        s.setup(m)
        r = s.solve(np.ones(24 ** 3))
        assert r.status == amgx.SolveStatus.SUCCESS
        out[where] = (r.iterations, r.x.cpu())
    assert out["cuda"][0] == out["cpu"][0]
    assert torch.equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("rows", [100, 4096])
def test_host_tail_bit_equal_to_all_card(card, rows):
    """amg_host_levels_rows: the tail's levels on the CPU, the graph cut
    into segments around each entry; x and iterations equal to the
    all-card run, a replay bit-equal to an eager application."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt_device
    from chip_smoke import HEADLINE_CFG
    A = poisson7pt_device(32, 32, 32, device_dtype=np.float32,
                          device="cuda")
    got = {}
    for knob in ("", f", amg_host_levels_rows={rows}"):
        s = amgx.create_solver(HEADLINE_CFG + knob)
        s.setup(A)
        r = s.solve(np.ones(32 ** 3))
        assert r.status == amgx.SolveStatus.SUCCESS
        got[knob] = (r.iterations, r.x, s.preconditioner)
    (ia, xa, _), (ih, xh, pre) = got[""], got[f", amg_host_levels_rows={rows}"]
    assert ia == ih and torch.equal(xa, xh)
    (g,) = pre.graphs.values()
    assert g.stats["segments"] > 1 and g.stats["host_steps"] == \
        g.stats["segments"] - 1
    b = torch.randn(32 ** 3, dtype=torch.float32, device=card)
    assert torch.equal(pre.apply(b), pre._apply_eager(b))


def test_scaled_and_reordered_solves_on_card_match_cpu(card):
    """scaling and matrix_reorder=RCM at 16³ on an f32 pack (the scaled
    solves to 1e-4, which f32 reaches unrefined): equal counts, x
    bit-equal on the card and the CPU."""
    import scipy.sparse as sp
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt
    from chip_smoke import CFG_CLA
    A0 = sp.csr_matrix(poisson7pt(16, 16, 16))
    p = np.random.default_rng(5).permutation(A0.shape[0])
    loose = CFG_CLA.replace("out:tolerance=1e-8", "out:tolerance=1e-4")
    for A, cfg in (
            (A0, loose + ", out:scaling=NBINORMALIZATION"),
            (A0, loose + ", out:scaling=DIAGONAL_SYMMETRIC"),
            (sp.csr_matrix(A0[p][:, p]),
             CFG_CLA + ", out:matrix_reorder=RCM")):
        out = {}
        for where in ("cuda", "cpu"):
            m = amgx.Matrix(A, device=where)
            m.device_dtype = np.float32
            s = amgx.create_solver(cfg)
            s.setup(m)
            r = s.solve(np.ones(A.shape[0]))
            assert r.status == amgx.SolveStatus.SUCCESS
            out[where] = (r.iterations, r.x.cpu())
        assert out["cuda"][0] == out["cpu"][0], cfg
        assert torch.equal(out["cuda"][1], out["cpu"][1]), cfg


def test_restart_rung_replays_the_graph(card):
    """values_nan once with recovery_policy=AUTO: restart recovers and
    the AMG's graph captured by the first attempt is replayed."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt_device
    from amgx_tpu_torch.utils import cuda_graph, faultinject
    from chip_smoke import HEADLINE_CFG
    faultinject.reset()
    try:
        A = poisson7pt_device(24, 24, 24, device_dtype=np.float32,
                              device="cuda")
        s = amgx.create_solver(HEADLINE_CFG + ", recovery_policy=AUTO, "
                               "fault_inject=values_nan:iter:3:count:1")
        s.setup(A)
        c0 = cuda_graph.CAPTURES["count"]
        r = s.solve(np.ones(24 ** 3))
        assert r.recovery == {"kind": "nan_poison", "action": "restart",
                              "attempts": 1, "outcome": "recovered"}
        assert cuda_graph.CAPTURES["count"] - c0 == 1
    finally:
        faultinject.reset()


@pytest.mark.parametrize("cdt", [torch.complex64, torch.complex128])
def test_complex_spmv_declines_on_card(card, cdt):
    """A complex pack takes the plain path on the card (the JAX package's
    kernels take real dtypes only), counted as a decline; no kernel
    launches, the wrappers refuse a complex tensor handed to them, and a
    c64 apply gives the CPU's bits."""
    import scipy.sparse as sp
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.errors import BadParametersError
    from amgx_tpu_torch.io import poisson7pt
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    from amgx_tpu_torch.ops import spmv as smod
    ndt = np.complex64 if cdt == torch.complex64 else np.complex128
    L = poisson7pt(12, 12, 12).astype(np.complex128)
    A = sp.csr_matrix(L + (-0.4 + 0.35j) * sp.identity(L.shape[0]))
    rng = np.random.default_rng(1)
    S = sp.random(500, 500, density=0.02, format="csr",
                  random_state=np.random.RandomState(1)) * (1 + 2j) \
        + sp.identity(500)
    for M, label in ((A, "dia/slices"), (S, "ell/gather")):
        M = sp.csr_matrix(M).astype(ndt)
        xh = (rng.standard_normal(M.shape[0])
              + 1j * rng.standard_normal(M.shape[0])).astype(ndt)
        gpu = amgx.Matrix(M, device=card).device()
        cpu = amgx.Matrix(M, device="cpu").device()
        smod.reset_dispatch()
        b1, b3 = dmod.launch_count(), emod.launch_count()
        y = smod.spmv(gpu, torch.from_numpy(xh).to(card))
        torch.cuda.synchronize(card)
        assert smod.declines()[label] == 1 and smod.DISPATCH[label] == 1
        assert dmod.launch_count() == b1 and emod.launch_count() == b3
        want = smod.spmv(cpu, torch.from_numpy(xh))
        if cdt == torch.complex64:
            assert torch.equal(y.cpu(), want)
        else:
            assert _rel(torch.view_as_real(y.cpu()),
                        torch.view_as_real(want)) < 1e-13
    x = torch.ones(gpu.n_rows, dtype=cdt, device=card)
    with pytest.raises(BadParametersError):
        emod.ell_spmv(gpu.cols, gpu.vals, x)


def test_solve_multi_lanes_bit_equal(card):
    """Each lane of ``solve_multi`` on the card is the bits of a single
    ``solve`` of its right-hand side (the f32 headline stack, 16³)."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.io import poisson7pt_device
    cfg = (
        "config_version=2, solver(out)=FGMRES, out:max_iters=100, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
        "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
        "amg:selector=GEO, amg:max_iters=1, amg:max_levels=20, "
        "amg:cycle=CG, amg:cycle_iters=2, "
        "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
        "amg:presweeps=2, amg:postsweeps=2, amg:min_coarse_rows=32, "
        "amg:coarse_solver=DENSE_LU_SOLVER")
    A = poisson7pt_device(16, 16, 16, device_dtype=np.float32, device=card)
    slv = amgx.create_solver(cfg)
    slv.setup(A)
    g = torch.Generator(device=card).manual_seed(3)
    B = torch.randn((4, 16 ** 3), dtype=torch.float64, device=card,
                    generator=g)
    out = slv.solve_multi(B)
    assert len(out) == 4
    for bj, rj in zip(B, out):
        single = slv.solve(bj)
        assert rj.iterations == single.iterations and rj.status == 0
        assert torch.equal(rj.x, single.x)
    assert len(slv.solve_multi(B[:3], pad_to_bucket=True)) == 3


def _dist_poisson(brick, where, pdt):
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.distributed import (make_mesh,
                                            partition_offsets_from_vector)
    from amgx_tpu_torch.io import generate_distributed_poisson_7pt
    A, pv = generate_distributed_poisson_7pt(brick, brick, brick, 2, 2, 2)
    m = amgx.Matrix(A, device=where)
    m.device_dtype = pdt
    m.set_distribution(make_mesh(8, device=where),
                       offsets=partition_offsets_from_vector(pv, 8))
    return A, m


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_sharded_interior_kernel_bit_equal(card, dt):
    """B3 on the stacked sharded interior (halo columns −1, skipped) is
    its plain version bit for bit, and the distributed SpMV on the card
    is the CPU's."""
    from amgx_tpu_torch.distributed import dist_spmv, shard_vector
    from amgx_tpu_torch.ops import ell_spmv as emod
    A, m = _dist_poisson(12, "cuda", np.dtype(str(dt).split(".")[1]))
    Ad = m.device()
    assert Ad.fmt == "sharded-ell" and bool((Ad.cols < 0).any())
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(Ad.n_cols, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = emod.launch_count()
    y = emod.ell_spmv(Ad.cols, Ad.vals, x, Ad.row_len)
    torch.cuda.synchronize(card)
    assert emod.launch_count() == before + 1
    assert torch.equal(y, emod.ell_spmv_reference(Ad.cols, Ad.vals, x))
    _, mc = _dist_poisson(12, "cpu", np.dtype(str(dt).split(".")[1]))
    xv = np.random.default_rng(0).standard_normal(A.shape[0])
    yg = dist_spmv(Ad, shard_vector(Ad, xv))
    Acd = mc.device()
    yc = dist_spmv(Acd, shard_vector(Acd, xv))
    assert torch.equal(yg.cpu(), yc)


def test_distributed_solve_on_card_matches_cpu(card):
    """The distributed FGMRES + SIZE_2 stack at 12³ in 8 shards, f32
    pack: the card takes the CPU's count with x bit-equal, every SpMV a
    ``sharded/window`` (B3) and the AMG one graph."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.ops import spmv as smod
    cfg = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-5, "
           "out:convergence=RELATIVE_INI, out:gmres_n_restart=20, "
           "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
           "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=12, "
           "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
           "amg:presweeps=1, amg:postsweeps=2, amg:min_coarse_rows=16, "
           "amg:coarse_solver=DENSE_LU_SOLVER")
    out = {}
    for where in ("cuda", "cpu"):
        A, m = _dist_poisson(6, where, np.float32)
        s = amgx.create_solver(cfg)
        s.setup(m)
        smod.reset_dispatch()
        r = s.solve(np.ones(A.shape[0]))
        out[where] = (r.iterations, r.x.cpu(), dict(smod.DISPATCH), s)
    assert out["cuda"][0] == out["cpu"][0]
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2]["sharded/window"] > 0
    assert out["cuda"][2]["sharded/gather"] == 0
    assert len(out["cuda"][3].preconditioner.graphs) == 1


def _dist_block(where, pdt, grid=(10, 10, 10)):
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.distributed import make_mesh
    from amgx_tpu_torch.io import spe10_block_system
    A = spe10_block_system(*grid)
    m = amgx.Matrix(A, block_dim=4, device=where)
    m.device_dtype = pdt
    m.set_distribution(make_mesh(8, device=where))
    return A, m


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_stacked_block_interior_b5_bit_equal(card, dt):
    """B5 over the stacked block interior of a 4×4 sharded pack is its
    plain version bit for bit; the block distributed SpMV on the card
    counts ``sharded/block-binned`` and one stacked launch, no plain
    path, and equals the CPU's bit for bit."""
    from amgx_tpu_torch.distributed import dist_spmv, shard_vector
    from amgx_tpu_torch.ops import binned_spmv as bmod
    from amgx_tpu_torch.ops import spmv as smod
    npdt = np.dtype(str(dt).split(".")[1])
    A, m = _dist_block("cuda", npdt)
    Ad = m.device()
    I = Ad.interior
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(Ad.n, dtype=torch.float64, device=card,
                    generator=g).to(dt)
    before = bmod.launch_count("B5-stacked")
    y = bmod.compact_spmv(I.compact, I.pos, I.row_of_pos, I.dims, x)
    torch.cuda.synchronize(card)
    assert bmod.launch_count("B5-stacked") == before + 1
    assert torch.equal(y, bmod.binned_compact_reference(I.compact, I.pos,
                                                        I.dims, x))
    _, mc = _dist_block("cpu", npdt)
    Acd = mc.device()
    xv = np.random.default_rng(1).standard_normal(A.shape[0])
    smod.reset_dispatch()
    yg = smod.spmv(Ad, shard_vector(Ad, xv))
    assert smod.DISPATCH["sharded/block-binned"] == 1
    assert smod.DISPATCH["sharded/block-plain"] == 0
    assert torch.equal(yg.cpu(), dist_spmv(Acd, shard_vector(Acd, xv)))


def test_bf16_sharded_interior_pairs_bit_equal(card):
    """ROADMAP item 7c: a bf16 sharded pack (``Matrix.device(dtype=
    torch.bfloat16)``) — B3 (bf16, f32) on the stacked interior and B5
    (bf16, f32) on the stacked block interior, each its plain version
    bit for bit; ``ops.spmv`` of each counts one kernel launch and no
    plain label, and y (bf16) is the CPU's bit for bit."""
    from amgx_tpu_torch.distributed import shard_vector
    from amgx_tpu_torch.ops import binned_spmv as bmod
    from amgx_tpu_torch.ops import ell_spmv as emod
    from amgx_tpu_torch.ops import spmv as smod
    bf16 = torch.bfloat16
    A, m = _dist_poisson(12, "cuda", np.float32)
    _, mc = _dist_poisson(12, "cpu", np.float32)
    B, mb = _dist_block("cuda", np.float32)
    _, mbc = _dist_block("cpu", np.float32)
    for host, mg, mcpu, label in ((A, m, mc, "sharded/window"),
                                  (B, mb, mbc, "sharded/block-binned")):
        D, Dc = mg.device(dtype=bf16), mcpu.device(dtype=bf16)
        assert D.dtype == bf16
        xv = np.random.default_rng(2).standard_normal(host.shape[0])
        x = shard_vector(D, xv)
        assert x.dtype == bf16
        xf = x.float()
        if D.block_dim == 1:
            before = emod.launch_count()
            y = emod.ell_spmv(D.cols, D.vals, xf, D.row_len)
            torch.cuda.synchronize(card)
            assert emod.launch_count() == before + 1
            assert torch.equal(y, emod.ell_spmv_reference(D.cols, D.vals,
                                                          xf))
        else:
            I = D.interior
            before = bmod.launch_count("B5-stacked")
            y = bmod.compact_spmv(I.compact, I.pos, I.row_of_pos, I.dims,
                                  xf)
            torch.cuda.synchronize(card)
            assert bmod.launch_count("B5-stacked") == before + 1
            assert torch.equal(y, bmod.binned_compact_reference(
                I.compact, I.pos, I.dims, xf))
        smod.reset_dispatch()
        yg = smod.spmv(D, x)
        assert yg.dtype == bf16 and smod.DISPATCH[label] == 1
        assert not any(smod.declines().values())
        assert torch.equal(yg.cpu(), smod.spmv(Dc, shard_vector(Dc, xv)))


def test_complex_sharded_solve_on_card_matches_cpu(card):
    """ROADMAP item 7c: the 8³ Helmholtz (c128) in 8 shards under FGMRES
    + SIZE_2 aggregation — the card takes the CPU's count, x to 1e-12;
    its interiors are counted declines (``sharded/gather``), no kernel
    launch."""
    import scipy.sparse as sp
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.distributed import make_mesh
    from amgx_tpu_torch.io import poisson7pt
    from amgx_tpu_torch.ops import spmv as smod
    L = sp.csr_matrix(poisson7pt(8, 8, 8), dtype=np.complex128)
    A = sp.csr_matrix(L + (-0.4 + 0.35j) * sp.identity(512))
    rng = np.random.default_rng(2)
    b = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    cfg = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
           "out:monitor_residual=1, out:tolerance=1e-8, "
           "out:convergence=RELATIVE_INI, out:gmres_n_restart=6, "
           "out:preconditioner(amg)=AMG, amg:algorithm=AGGREGATION, "
           "amg:selector=SIZE_2, amg:max_iters=1, amg:max_levels=20, "
           "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, "
           "amg:presweeps=1, amg:postsweeps=1, amg:min_coarse_rows=16, "
           "amg:coarse_solver=DENSE_LU_SOLVER")
    out = {}
    for where in ("cuda", "cpu"):
        m = amgx.Matrix(A, device=where)
        m.set_distribution(make_mesh(8, device=where))
        s = amgx.create_solver(cfg)
        s.setup(m)
        smod.reset_dispatch()
        r = s.solve(b)
        out[where] = (r.iterations, r.x.cpu().numpy(),
                      dict(smod.declines()))
    assert out["cuda"][0] == out["cpu"][0]
    xg, xc = out["cuda"][1], out["cpu"][1]
    assert np.linalg.norm(xg - xc) <= 1e-12 * np.linalg.norm(xc)
    assert out["cuda"][2]["sharded/gather"] > 0


def test_distributed_config4_and_classical_on_card_match_cpu(card):
    """Config 4 in 8 shards of 4×4 blocks and the distributed classical
    stack at 16³, f32 packs: the card takes the CPU's counts with x
    bit-equal; the DILU applies make no halo exchange."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch.distributed import matrix as tdm
    cfg4 = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
            "out:monitor_residual=1, out:tolerance=1e-5, "
            "out:convergence=RELATIVE_INI, "
            "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")
    cla = ("config_version=2, solver(out)=PCG, out:max_iters=60, "
           "out:monitor_residual=1, out:tolerance=1e-5, "
           "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
           "amg:algorithm=CLASSICAL, amg:selector=PMIS, "
           "amg:interpolator=D2, amg:max_iters=1, "
           "amg:interp_max_elements=4, amg:max_row_sum=0.9, "
           "amg:max_levels=6, amg:smoother(sm)=JACOBI_L1, sm:max_iters=1, "
           "amg:presweeps=1, amg:postsweeps=1, amg:min_coarse_rows=8, "
           "amg:coarse_solver=DENSE_LU_SOLVER, determinism_flag=1")
    for cfg, make in ((cfg4, lambda w: _dist_block(w, np.float32)),
                      (cla, lambda w: _dist_poisson(8, w, np.float32))):
        out = {}
        for where in ("cuda", "cpu"):
            A, m = make(where)
            s = amgx.create_solver(cfg)
            s.setup(m)
            r = s.solve(np.ones(A.shape[0]))
            out[where] = (r.iterations, r.x.cpu(), s)
        assert out["cuda"][0] == out["cpu"][0]
        assert torch.equal(out["cuda"][1], out["cpu"][1])
    pre = out["cuda"][2].preconditioner
    calls = []
    orig = tdm._exchange
    tdm._exchange = lambda *a: calls.append(1) or orig(*a)
    try:
        s4 = amgx.create_solver(cfg4)
        A, m = _dist_block("cuda", np.float32)
        s4.setup(m)
        s4.preconditioner._apply_dilu(torch.ones(m.device().n,
                                                 device=card))
    finally:
        tdm._exchange = orig
    assert calls == []
    assert pre.hierarchy._structure[0][0] == "classical-dist"


def _capi_upload(capi, side, cfg_str, mode="dDDI"):
    """The side³ 7-point CSR and its grid through the C API in ``mode``:
    (config, resources, matrix handle)."""
    from chip_smoke import capi_poisson
    A, geo = capi_poisson(side)
    rc, cfg = capi.AMGX_config_create(cfg_str)
    rc, rsrc = capi.AMGX_resources_create_simple(cfg)
    rc, M = capi.AMGX_matrix_create(rsrc, mode)
    assert capi.AMGX_matrix_upload_all(M, A.shape[0], A.nnz, 1, 1,
                                       A.indptr, A.indices, A.data) == 0
    assert capi.AMGX_matrix_attach_geometry(M, *geo) == 0
    return A, cfg, rsrc, M


def test_capi_spmv_bit_equal_direct(card):
    """A dDDI upload's ``AMGX_matrix_vector_multiply``: one B1 launch on
    the mode's f64 pack, bit-equal to the port's direct ``ops.spmv``."""
    from amgx_tpu_torch import capi
    from amgx_tpu_torch.ops import dia_spmv as dmod
    from amgx_tpu_torch.ops import spmv as smod
    A, cfg, rsrc, M = _capi_upload(capi, 24, "config_version=2")
    rc, v = capi.AMGX_vector_create(rsrc, "dDDI")
    rc, y = capi.AMGX_vector_create(rsrc, "dDDI")
    n = A.shape[0]
    assert capi.AMGX_vector_upload(
        v, n, 1, np.random.default_rng(0).standard_normal(n)) == 0
    assert v.data.is_cuda and v.data.dtype == torch.float64
    before = dmod.launch_count()
    assert capi.AMGX_matrix_vector_multiply(M, v, y) == 0
    torch.cuda.synchronize(card)
    assert dmod.launch_count() == before + 1
    pack = M.matrix.device(dtype=np.float64)
    assert pack.fmt == "dia" and y.data.is_cuda
    assert torch.equal(y.data, smod.spmv(pack, v.data))
    rc, yh = capi.AMGX_vector_download(y)
    np.testing.assert_allclose(yh, A @ v.data.cpu().numpy(), rtol=1e-13,
                               atol=1e-13)


def test_capi_solve_bit_equal_direct(card):
    """One C-API solve (headline config, dDDI: f32 pack, f64
    refinement) at 32³, equal in count and bits to the port's direct
    ``create_solver`` path on the same uploaded matrix."""
    import amgx_tpu_torch as amgx
    from amgx_tpu_torch import capi
    from chip_smoke import HEADLINE_CFG
    A, cfg, rsrc, M = _capi_upload(capi, 32, HEADLINE_CFG)
    n = A.shape[0]
    rc, b = capi.AMGX_vector_create(rsrc, "dDDI")
    rc, x = capi.AMGX_vector_create(rsrc, "dDDI")
    capi.AMGX_vector_upload(b, n, 1, np.ones(n))
    capi.AMGX_vector_set_zero(x, n, 1)
    rc, slv = capi.AMGX_solver_create(rsrc, "dDDI", cfg)
    assert capi.AMGX_solver_setup(slv, M) == 0
    assert capi.AMGX_solver_solve(slv, b, x) == 0
    rc, iters = capi.AMGX_solver_get_iterations_number(slv)
    rc, xs = capi.AMGX_vector_download(x)
    direct = amgx.create_solver(HEADLINE_CFG)
    direct.setup(M.matrix)
    res = direct.solve(np.ones(n))
    assert res.iterations == iters
    assert np.array_equal(res.x.cpu().numpy(), xs)
    assert np.linalg.norm(1.0 - A @ xs) / np.sqrt(n) <= 1e-8
