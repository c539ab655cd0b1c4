"""The CUDA-graph helper's counting (``utils/cuda_graph.py``), on the CPU
with a stand-in for the capture step: the increments a captured
application makes are taken back out of the launch and dispatch counters
and credited on every replay, so a graphed solve counts as an eager one.
The capture and replay themselves need a card (tests/test_torch_cuda.py).
No JAX here."""
import numpy as np
import pytest
import torch

import amgx_tpu_torch as amgx
from amgx_tpu_torch.errors import DeviceError
from amgx_tpu_torch.io import poisson7pt_device
from amgx_tpu_torch.utils import cuda_graph as cg

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


@pytest.fixture
def amg():
    A = poisson7pt_device(12, 12, 12, device_dtype=np.float32, device="cpu")
    slv = amgx.create_solver(HEADLINE)
    slv.setup(A)
    return slv.preconditioner


def _zero():
    for c in cg.counters():
        for k in c:
            c[k] = 0


def _flat():
    return [dict(c) for c in cg.counters()]


def test_counters_cover_every_kernel_and_dispatch():
    from amgx_tpu_torch import device
    from amgx_tpu_torch.ops import (binned_spmv, dia_spmv, ell_spmv,
                                    shift_spmv, spmv)
    live = cg.counters()
    for c in (spmv.DISPATCH, dia_spmv.LAUNCHES, ell_spmv.LAUNCHES,
              shift_spmv.LAUNCHES, binned_spmv.LAUNCHES["B4"],
              binned_spmv.LAUNCHES["B5"], device.HOST_SYNCS):
        assert any(c is d for d in live)


def test_capture_increments_are_taken_out_and_credited(amg):
    """Stand-in capture: the application runs on CPU tensors (its Python
    counts as it would while captured).  The counters read as before it;
    each credit adds exactly one eager application's counts."""
    b = torch.ones(12 ** 3, dtype=torch.float32)
    _zero()
    amg._apply_eager(b)
    eager = _flat()
    assert eager[0]["dia/slices"] > 0
    _zero()
    out, delta = cg.counted_capture(lambda: amg._apply_eager(b))
    assert out.shape == b.shape
    assert all(not any(c.values()) for c in _flat())
    for k in range(1, 4):
        cg.credit(delta)
        assert _flat() == [{key: k * v for key, v in c.items()}
                           for c in eager]


def test_counters_restored_when_the_capture_raises(amg):
    _zero()
    before = _flat()

    def fails():
        amg._apply_eager(torch.ones(12 ** 3, dtype=torch.float32))
        raise RuntimeError("capture refused")

    with pytest.raises(RuntimeError):
        cg.counted_capture(fails)
    assert _flat() == before


def test_cpu_application_stays_eager(amg):
    """On a CPU tensor ``apply`` is the eager cycle: no graph is made."""
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(
        12 ** 3).astype(np.float32))
    assert torch.equal(amg.apply(b), amg._apply_eager(b))
    assert amg.graphs == {}
    with pytest.raises(DeviceError):
        cg.CudaGraphCall(amg._apply_eager, b)


def test_setup_drops_the_graphs(amg):
    amg.graphs[(1, torch.float32, 1, True)] = object()
    amg.setup(amg.A)
    assert amg.graphs == {}


def test_building_only_inside_a_graph_warm_up_or_capture():
    """``building()`` holds while a warm-up or capture runs (nested ones
    too) and is restored when it raises: a nested AMG reads it to run
    eagerly into the outer graph."""
    assert not cg.building()
    seen = []

    def inner():
        seen.append(cg.building())
        return cg._built(lambda: seen.append(cg.building()))

    cg._built(inner)
    assert seen == [True, True] and not cg.building()

    def fails():
        raise DeviceError("capture refused")

    with pytest.raises(DeviceError):
        cg._built(fails)
    assert not cg.building()
