"""b×b sharded packs (``amgx_tpu_torch.distributed.matrix``:
``shard_block_matrix``, the block ``dist_spmv`` with kernel B5's plain
version over the stacked block interior) held against the JAX package
on the CPU: the packed arrays and maps, the SpMV against the JAX package
and scipy (8 shards and a 2-rank mesh), the stacked interior against a
per-shard product, and BASELINE config 4 (PBICGSTAB + MULTICOLOR_DILU)
on a sharded 4×4 pack with the JAX package's count.  The JAX side runs
on the 8-device virtual CPU mesh of ``tests/conftest.py``; the port's
mesh holds its shards on the CPU.  Sizes stay at 12³ or less."""
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.distributed import matrix as jdm
from amgx_tpu.io import poisson7pt as jpoisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.distributed import matrix as tdm
from amgx_tpu_torch.errors import BadParametersError
from amgx_tpu_torch.io import spe10_block_system
from amgx_tpu_torch.ops import binned_spmv as bmod
from amgx_tpu_torch.ops import spmv as smod

#: tests/test_distributed.py:663-700: BASELINE config 4 on the mesh
CFG4 = ("config_version=2, solver(out)=PBICGSTAB, out:max_iters=200, "
        "out:monitor_residual=1, out:tolerance=1e-8, "
        "out:convergence=RELATIVE_INI, "
        "out:preconditioner(pre)=MULTICOLOR_DILU, pre:max_iters=1")


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((8,), ("p",))


@pytest.fixture(scope="module")
def tmesh():
    return tdm.make_mesh(8, device="cpu")


def _random_bsr(b: int, side: int = 6, seed: int = 0) -> sp.bsr_matrix:
    """A 7-point block pattern with random b×b blocks (made from a seed
    with numpy)."""
    A0 = sp.csr_matrix(jpoisson7pt(side, side, side))
    bsr = sp.kron(A0, np.ones((b, b))).tobsr(blocksize=(b, b))
    bsr.data[:] = np.random.default_rng(seed).standard_normal(
        bsr.data.shape)
    return bsr


OFFSETS = {"equal": None,
           "nonuniform": np.array([0, 20, 50, 80, 100, 130, 160, 200, 216])}


@pytest.mark.parametrize("case", sorted(OFFSETS))
@pytest.mark.parametrize("b", [2, 4])
def test_shard_block_matrix_arrays_match_jax(b, case, jmesh, tmesh):
    """The JAX package's arrays exactly: cols (P, n_loc, K), vals (P,
    n_loc, K, b, b), diag, the ring-1/ring-2 maps and distances, the
    boundary rows; the port's send maps are rebased by p·n_loc."""
    bsr = _random_bsr(b)
    offs = OFFSETS[case]
    J = jdm.shard_block_matrix(bsr, b, jmesh, offsets=offs)
    T = tdm.shard_block_matrix(bsr, b, tmesh, offsets=offs)
    assert (T.n_loc, T.n_parts, T.block_dim, T.ell_width) == \
        (J.n_loc, J.n_parts, J.block_dim, J.ell_width)
    assert T.dists == J.dists and T.dists2 == J.dists2
    assert T.offsets == J.offsets and T.n == J.n
    np.testing.assert_array_equal(T.host_cols, np.asarray(J.cols))
    np.testing.assert_array_equal(
        T.vals.numpy().reshape(np.asarray(J.vals).shape), np.asarray(J.vals))
    np.testing.assert_array_equal(T.diag.numpy(), np.asarray(J.diag))
    base = np.arange(8)[:, None] * T.n_loc
    np.testing.assert_array_equal(T.send_idx.numpy() - base,
                                  np.asarray(J.send_idx))
    np.testing.assert_array_equal(T.halo_src.numpy(), np.asarray(J.halo_src))
    np.testing.assert_array_equal(T.send_idx2.numpy() - base,
                                  np.asarray(J.send_idx2))
    np.testing.assert_array_equal(T.halo_src2.numpy(),
                                  np.asarray(J.halo_src2))
    assert T.halo_counts == J.halo_counts and \
        T.bnd_counts == J.bnd_counts
    jb = np.asarray(J.bnd_rows)
    want = np.concatenate([p * T.n_loc + jb[p, :T.bnd_counts[p]]
                           for p in range(8)])
    np.testing.assert_array_equal(T.bnd_rows.numpy(), want)


def test_block_matrix_dtype_gates(tmesh):
    """ROADMAP item 7c: a complex b×b sharded pack packs complex values
    and carries no B5 interior (B5 refuses complex values; its interior
    applies on the plain path); a bf16 one is the f32 pack cast on the
    device, its B5 interior bf16; a pack of integers raises."""
    bsr = _random_bsr(2)
    C = tdm.shard_block_matrix(bsr.astype(np.complex128), 2, tmesh)
    assert C.dtype == torch.complex128 and C.interior is None
    m = amgx.Matrix(bsr, block_dim=2, device="cpu")
    m.set_distribution(tmesh)
    m.device_dtype = torch.bfloat16
    B = m.device()
    assert B.dtype == torch.bfloat16
    assert B.interior.compact.vals.dtype == torch.bfloat16
    with pytest.raises(BadParametersError):
        tdm.shard_block_matrix(bsr, 2, tmesh, dtype=np.int32)


SPMV_CASES = {"b2": (2, 8, None), "b3": (3, 8, "nonuniform"),
              "b4": (4, 8, None), "b4_two_ranks": (4, 2, None)}


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_block_dist_spmv_matches_jax_and_scipy(case, jmesh, tmesh):
    """The block distributed SpMV (halo exchange of (B, b) buffers, B5's
    plain version over the stacked interior, the boundary blocks) equals
    the JAX package's and scipy's to 1e-13 relative, on 8 shards and on
    a 2-rank mesh; the CPU runs no kernel and counts
    ``sharded/block-plain``."""
    b, P, offs = SPMV_CASES[case]
    bsr = _random_bsr(b, seed=P + b)
    offs = OFFSETS.get(offs) if offs else None
    jm = jmesh if P == 8 else jdm.make_mesh(P)
    tm = tmesh if P == 8 else tdm.make_mesh(P, device="cpu")
    J = jdm.shard_block_matrix(bsr, b, jm, offsets=offs)
    T = tdm.shard_block_matrix(bsr, b, tm, offsets=offs)
    x = np.random.default_rng(7).standard_normal(bsr.shape[0])
    yj = jdm.unshard_vector(J, jax.jit(lambda v: jdm.dist_spmv(J, v))(
        jdm.shard_vector(J, x)))
    smod.reset_dispatch()
    bmod.reset_launches()
    yt = tdm.unshard_vector(T, smod.spmv(T, tdm.shard_vector(T, x))).numpy()
    assert smod.DISPATCH["sharded/block-plain"] == 1
    assert smod.DISPATCH["sharded/block-binned"] == 0
    assert bmod.launch_count() == 0
    ref = bsr @ x
    scale = np.abs(ref).max()
    np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(yt, ref, rtol=0, atol=1e-13 * scale)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_stacked_interior_bits_equal_per_shard_plain_b5(dt, tmesh):
    """The stacked interior through B5's plain version gives each
    shard's rows bit for bit as the shard's own binned pack over
    [x_local] (the plan's column stride keeps every row's chunks), and
    the block dist_spmv is that interior plus the boundary rows' halo
    blocks summed in slot order, bit for bit."""
    bsr = spe10_block_system(8, 8, 8).astype(dt)
    offs = np.array([0, 50, 100, 160, 230, 300, 360, 420,
                     bsr.shape[0] // 4])
    T = tdm.shard_block_matrix(bsr, 4, tmesh, offsets=offs)
    I = T.interior
    n_loc, b = T.n_loc, 4
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(T.n)
                         .astype(dt))
    stacked = bmod.binned_compact_reference(I.compact, I.pos, I.dims, x)
    blocks = tdm.split_bsr_rows(bsr, offs)
    part = tdm.build_partition_from_blocks(
        tdm._index_blocks(blocks, bsr.shape[1] // 4), offs, n_rings=2)
    for p in range(8):
        loc = tdm.local_block_csr(blocks, part, dt, p)
        own = tdm.binned_interior(loc, n_loc, dt, torch.device("cpu"))
        xp = x[p * n_loc * b:(p + 1) * n_loc * b]
        want = bmod.binned_compact_reference(own.compact, own.pos, own.dims,
                                             xp)
        assert torch.equal(stacked[p * n_loc * b:(p + 1) * n_loc * b],
                           want), p
    # the boundary correction, written out
    halo = tdm.exchange_halo(T, x, 1)
    hz = torch.cat([halo.reshape(-1, b), halo.new_zeros((1, b))])
    g = hz[T.bnd_hidx]
    per_slot = T.bnd_vals[..., 0] * g[:, :, None, 0]
    for c in range(1, b):
        per_slot = per_slot + T.bnd_vals[..., c] * g[:, :, None, c]
    corr = per_slot[:, 0]
    for k in range(1, per_slot.shape[1]):
        corr = corr + per_slot[:, k]
    want = stacked.clone().reshape(-1, b)
    want[T.bnd_rows] = want[T.bnd_rows] + corr
    assert torch.equal(tdm.dist_spmv(T, x), want.reshape(-1))


def test_compact_spmv_on_cuda_tensor_launches_no_plain_path(monkeypatch):
    """On a CUDA tensor the stacked interior's wrapper launches kernel B5
    (here a recorder in its place) and never its plain version."""
    bsr = _random_bsr(4, side=4)
    I = tdm.binned_interior(bsr, bsr.shape[1] // 4, np.float64,
                            torch.device("cpu"))
    launched = []
    monkeypatch.setattr(bmod, "_launch",
                        lambda cp, rop, dims, x, kern: launched.append(kern))

    def refuse(*_a, **_k):
        raise AssertionError("plain version on a CUDA tensor")

    monkeypatch.setattr(bmod, "binned_compact_reference", refuse)

    class CudaVector:
        """Stands in for a CUDA tensor: the wrapper reads only these."""
        is_cuda = True
        dtype = torch.float64
        device = I.compact.vals.device
        shape = (bsr.shape[1],)

        def dim(self):
            return 1

    bmod.compact_spmv(I.compact, I.pos, I.row_of_pos, I.dims, CudaVector())
    assert launched == ["B5-stacked"]


def test_block_upload_from_blocks_matches_global(tmesh):
    """``set_distributed_blocks(..., block_dim=4)`` (per-rank BSR row
    blocks, never assembled) solves PBICGSTAB + BLOCK_JACOBI to the bits
    of the global upload; config 4's DILU there colors each rank's
    blocks on their own (as the JAX package colors a block-distributed
    upload) and converges."""
    bsr = spe10_block_system(6, 6, 6)
    nb = bsr.shape[0] // 4
    offs = np.minimum(np.arange(9) * (-(-nb // 8)), nb)
    blocks = tdm.split_bsr_rows(bsr, offs)
    mb = amgx.Matrix(device="cpu")
    mb.set_distributed_blocks(blocks, offs, tmesh, block_dim=4)
    assert mb.shape == bsr.shape and mb.n_block_rows == nb
    mg = amgx.Matrix(bsr, block_dim=4, device="cpu")
    mg.set_distribution(tmesh, offsets=offs)
    xs = []
    for m in (mb, mg):
        s = amgx.create_solver(CFG4.replace("MULTICOLOR_DILU",
                                            "BLOCK_JACOBI"))
        s.setup(m)
        r = s.solve(np.ones(bsr.shape[0]))
        assert r.status == 0
        xs.append((r.iterations, r.x))
    assert xs[0][0] == xs[1][0] and torch.equal(xs[0][1], xs[1][1])
    s = amgx.create_solver(CFG4)
    s.setup(mb)
    r = s.solve(np.ones(bsr.shape[0]))
    assert r.status == 0
    relres = np.linalg.norm(1 - bsr @ r.x.numpy()) / np.sqrt(bsr.shape[0])
    assert relres < 1e-8


def test_sharded_config4_spe10_matches_jax(jmesh, tmesh):
    """Config 4 on a small SPE10 grid (4×4 blocks, 5 % inactive cells)
    in 8 shards, f64: the JAX package's count, x to 1e-10 of its
    largest entry."""
    bsr = spe10_block_system(8, 8, 8)
    b = np.ones(bsr.shape[0])
    mj = jx.Matrix(bsr, block_dim=4)
    mj.set_distribution(jmesh)
    sj = jx.create_solver(jx.AMGConfig(CFG4))
    sj.setup(mj)
    rj = sj.solve(b)
    xj = np.asarray(rj.x)
    mt = amgx.Matrix(bsr, block_dim=4, device="cpu")
    mt.set_distribution(tmesh)
    st = amgx.create_solver(CFG4)
    st.setup(mt)
    rt = st.solve(b)
    assert rt.iterations == int(rj.iterations) and int(rt.status) == 0
    assert mt.device().block_dim == 4
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=0,
                               atol=1e-10 * np.abs(xj).max())
