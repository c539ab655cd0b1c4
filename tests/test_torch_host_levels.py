"""``amg_host_levels_rows`` on the port (``AMGHierarchy._place_host_tail``,
``amg/cycles.py``, ``utils/cuda_graph.py::host_step``) against the JAX
package on the CPU, mirroring ``test_amg.py:231-250``: the levels at or
below the threshold form the host tail, the solve takes the JAX
package's iterations and x (f64, to ``X_RTOL``), and on the CPU — where
the device is the host — the tail changes no bit.  The segmented capture
is checked with a stand-in graph; the card side (segments, x bit-equal
to the all-card run) is ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 35."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import amgx_tpu as jx
from amgx_tpu.io import poisson7pt as jax_poisson7pt

import amgx_tpu_torch as amgx
from amgx_tpu_torch.io import poisson7pt
from amgx_tpu_torch.utils import cuda_graph as cg

#: f64 solutions of the same solve in another summation order
X_RTOL = 1e-8

CFG = ("config_version=2, solver(out)=FGMRES, out:max_iters=100, "
       "out:monitor_residual=1, out:tolerance=1e-8, "
       "out:convergence=RELATIVE_INI, out:preconditioner(amg)=AMG, "
       "amg:algorithm=AGGREGATION, amg:selector=GEO, amg:max_iters=1, "
       "amg:cycle=CG, amg:cycle_iters=2, "
       "amg:smoother(sm)=BLOCK_JACOBI, sm:max_iters=1, amg:presweeps=1, "
       "amg:postsweeps=2, amg:min_coarse_rows=32, "
       "amg:coarse_solver=DENSE_LU_SOLVER, out:store_res_history=1")


@pytest.mark.parametrize("rows,cycle", [(512, "CG"), (100, "V"),
                                        (-1, "CG")])
def test_hybrid_host_levels_match_jax(rows, cycle):
    """The hybrid hierarchy of ``test_amg.py:231-250`` at 12³: the JAX
    package's iterations, histories and x; relres ≤ 1e-8; the host tail
    starts at the first level of at most ``rows`` rows."""
    cfg = CFG.replace("amg:cycle=CG", f"amg:cycle={cycle}") \
        + f", amg_host_levels_rows={rows}"
    A = sp.csr_matrix(poisson7pt(12, 12, 12))
    b = np.ones(A.shape[0])
    sj = jx.create_solver(jx.AMGConfig(cfg))
    sj.setup(jx.Matrix(sp.csr_matrix(jax_poisson7pt(12, 12, 12))))
    rj = sj.solve(b)
    s = amgx.create_solver(cfg)
    s.setup(amgx.Matrix(A, device="cpu"))
    r = s.solve(b)
    assert r.status == 0 and r.iterations == rj.iterations
    np.testing.assert_allclose(r.residual_history,
                               np.asarray(rj.residual_history), rtol=1e-8)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(r.x.numpy(), xj, rtol=0,
                               atol=X_RTOL * np.abs(xj).max())
    assert np.linalg.norm(b - A @ r.x.numpy()) / np.linalg.norm(b) <= 1e-8
    h = s.preconditioner.hierarchy
    sizes = [lv.Ad.n_rows for lv in h.levels] + [h.coarsest.n_block_rows]
    if rows < 0:
        assert h.host_from == len(sizes)
    else:
        assert all(n > rows for n in sizes[:h.host_from])
        assert all(n <= rows for n in sizes[h.host_from:])
    # on the CPU the tail never leaves: every level stays where it was
    assert all(lv.A.placement.type == "cpu" for lv in h.levels)
    assert h.coarsest.placement.type == "cpu"


def test_host_tail_changes_no_bit_on_the_cpu():
    """f32 pack + f64 refinement at 16³: with and without a host tail the
    same iterations and x bit for bit (the tail's ops are the device's
    plain versions)."""
    out = []
    for knob in ("", ", amg_host_levels_rows=600"):
        A = amgx.io.poisson7pt_device(16, 16, 16, device_dtype=np.float32,
                                      device="cpu")
        s = amgx.create_solver(CFG + knob)
        s.setup(A)
        r = s.solve(np.ones(4096))
        out.append((r.iterations, r.x))
    assert out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])


class _StandInGraph:
    """Records the capture and replay calls a segment gets."""

    log: list = []

    def __init__(self, keep_graph=False):
        self.id = sum(e[0] == "new" for e in _StandInGraph.log)
        _StandInGraph.log.append(["new", self.id])

    def capture_begin(self, pool=None):
        _StandInGraph.log.append(["begin", self.id])

    def capture_end(self):
        _StandInGraph.log.append(["end", self.id])

    def replay(self):
        _StandInGraph.log.append(["replay", self.id])


def test_segments_cut_at_each_host_step(monkeypatch):
    """A segmented capture ends the open segment at each host step and
    opens the next; a replay runs segment k, then the recorded step on
    CPU copies of its inputs, writing the static tensor segment k + 1
    reads."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    _StandInGraph.log = []
    seg = cg._Segments(pool=None)
    monkeypatch.setattr(cg, "_segments", seg)
    calls = []

    def tail(b, x):
        calls.append((b.device.type, x.device.type))
        return b * 2 + x

    b1, x1 = torch.arange(4.0), torch.zeros(4)
    ret1 = cg.host_step(tail, b1, x1)
    ret2 = cg.host_step(tail, b1 + 1, x1)
    seg.graphs[-1].capture_end()
    monkeypatch.setattr(cg, "_segments", None)
    assert len(seg.graphs) == 3 and len(seg.steps) == 2
    assert [e[0] for e in _StandInGraph.log] == [
        "new", "begin", "end", "new", "begin", "end", "new", "begin",
        "end"]
    assert calls == []                    # nothing ran while capturing
    seg.replay()
    assert [e for e in _StandInGraph.log if e[0] == "replay"] == [
        ["replay", 0], ["replay", 1], ["replay", 2]]
    assert calls == [("cpu", "cpu")] * 2
    assert torch.equal(ret1, torch.arange(4.0) * 2)
    assert torch.equal(ret2, (torch.arange(4.0) + 1) * 2)
    # eagerly (no capture) a host step runs at once
    assert torch.equal(cg.host_step(tail, b1, x1), b1 * 2)
