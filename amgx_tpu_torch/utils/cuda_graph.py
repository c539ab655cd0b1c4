"""One fixed sequence of device work captured as a CUDA graph and replayed.

The eager AMG cycle is launch-bound: every visit of a level is a few
dozen small kernels, each costing some 15 µs of host time, and the
CG K-cycle visits level i 2^i times per application.  The work of one
application is data-independent once the hierarchy is set up (the
K-cycle keeps α and β as 0-d device tensors and never syncs with the
host), so it is recorded once with :class:`torch.cuda.CUDAGraph` and
replayed as one launch (the JAX package records the same cycle as one
XLA program, ``amgx_tpu/amg/cycles.py``).

:class:`CudaGraphCall` runs a callable once eagerly on a side stream
(lazy kernel builds and cached views happen there, and its result is the
first call's answer), captures it against static copies of its tensor
arguments in a private memory pool, and replays it on later calls,
returning a copy of the static output that the next replay will not
overwrite.  There is no fallback: a capture or replay that fails raises.

Nesting: while a :class:`CudaGraphCall` runs its warm-up or its capture
(:func:`building`), a callable that would build a graph of its own (an
AMG nested in the AMG, as coarse solver or smoother) runs eagerly
instead: in the capture its kernels join the outer graph as nodes of
their own, and in the warm-up no inner graph is captured that no replay
would use.

Counting under replay: a replay launches no wrapper, so the launch and
dispatch counters (``ops/spmv.py::DISPATCH``, the ``LAUNCHES`` of the
four kernel modules, ``device.HOST_SYNCS``) would stop moving.  The
increments the callable makes while it is captured (it runs its Python,
but the device runs nothing) are taken back out of the counters
(:func:`counted_capture`) and credited again on every replay
(:func:`credit`), so the counts of a solve read the same as eager ones.
"""
from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from ..errors import DeviceError


#: how many :class:`CudaGraphCall` warm-ups or captures are running
_building = 0
#: graphs captured since the last reset (a kept graph is not captured
#: again after a resetup)
CAPTURES = {"count": 0}


def building() -> bool:
    """True while a :class:`CudaGraphCall` warm-up or capture runs, or
    the current stream is capturing."""
    return _building > 0 or (torch.cuda.is_available()
                             and torch.cuda.is_current_stream_capturing())


def _built(fn: Callable, *args):
    """``fn(*args)`` with :func:`building` true throughout."""
    global _building
    _building += 1
    try:
        return fn(*args)
    finally:
        _building -= 1


def counters() -> List[Dict[str, int]]:
    """Every launch and dispatch counter of the port, as the dicts
    themselves (their identity is what the wrappers update)."""
    from .. import device
    from ..ops import binned_spmv, dia_spmv, ell_spmv, shift_spmv, spmv
    return [spmv.DISPATCH, dia_spmv.LAUNCHES, ell_spmv.LAUNCHES,
            shift_spmv.LAUNCHES, *binned_spmv.LAUNCHES.values(),
            device.HOST_SYNCS]


def snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in counters()]


def counted_capture(capture: Callable):
    """Run ``capture()`` — a step that records device work without
    running it — and return ``(its result, the counter increments it
    made)``; the counters are left as they were before it, also when it
    raises."""
    live = counters()
    before = snapshot()
    try:
        got = capture()
        after = snapshot()
    finally:
        for c, b in zip(live, before):
            c.update(b)
    delta = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
             for a, b in zip(after, before)]
    return got, delta


def credit(delta) -> None:
    """Add one replay's increments (from :func:`counted_capture`) to the
    counters."""
    for c, d in zip(counters(), delta):
        for k, v in d.items():
            c[k] += v


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured, kept graph (``cuGraphGetNodes`` of
    ``libcuda`` on its ``cudaGraph_t``, the same handle as a
    ``CUgraph``)."""
    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = fn(ctypes.c_void_p(graph.raw_cuda_graph()), None,
            ctypes.byref(count))
    if rc != 0:
        raise DeviceError(f"cuGraphGetNodes failed (code {rc})")
    return int(count.value)


class CudaGraphCall:
    """``fn(*args)`` (CUDA tensors in, one CUDA tensor out) captured as a
    CUDA graph.  Construction runs the warm-up and the capture;
    :meth:`take_first` hands out the warm-up's result, :meth:`__call__`
    replays.

    ``stats`` records the capture: seconds of the eager warm-up, of the
    capture and of the instantiation, the graph's node count and the
    bytes its private pool reserved."""

    def __init__(self, fn: Callable, *args: torch.Tensor):
        dev = args[0].device
        if dev.type != "cuda":
            raise DeviceError(f"CudaGraphCall on a {dev.type} tensor")
        cur = torch.cuda.current_stream(dev)
        self.static_in = tuple(a.clone() for a in args)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            first = _built(fn, *self.static_in)
        cur.wait_stream(side)
        first.record_stream(cur)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        # the capture empties the cache first: the baseline does too
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

        def capture():
            # a garbage collection inside the capture may free another
            # graph (an old solver's, held by a reference cycle), whose
            # destruction invalidates the capture: collect first, then
            # hold the collector off until the capture ends
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    return _built(fn, *self.static_in)
            finally:
                if enabled:
                    gc.enable()

        self.static_out, self.delta = counted_capture(capture)
        CAPTURES["count"] += 1
        t2 = time.perf_counter()
        nodes = graph_nodes(self.graph)
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.first: Optional[torch.Tensor] = first
        self.stats = dict(
            warmup_s=t1 - t0, capture_s=t2 - t1,
            instantiate_s=t3 - t2, nodes=nodes,
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved)

    def take_first(self) -> torch.Tensor:
        """The warm-up's result (the first call's answer), handed out
        once."""
        out, self.first = self.first, None
        return out

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        self.graph.replay()
        credit(self.delta)
        return self.static_out.clone()
