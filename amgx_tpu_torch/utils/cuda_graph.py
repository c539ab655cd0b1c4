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

Host steps (``amg_host_levels_rows``): a CUDA graph cannot hold host
work, so an application whose coarse levels run on the CPU is captured
as *segments* cut at each entry into that tail (:func:`host_step`; the
K-cycle enters the tail once per visit of the level above it).  Each
segment is a graph of its own in one shared memory pool; a replay runs
segment k, then the recorded host step on CPU copies of its device
inputs (eagerly, on the CPU tensors of the tail), copies the result into
the static tensor segment k + 1 reads, and so on.  Without a host tail
the capture is one segment: the application stays one graph.

Counting under replay: a replay launches no wrapper, so the launch and
dispatch counters (``ops/spmv.py::DISPATCH``, the ``LAUNCHES`` of the
four kernel modules, ``device.HOST_SYNCS``) would stop moving.  The
increments the callable makes while it is captured (it runs its Python,
but the device runs nothing) are taken back out of the counters
(:func:`counted_capture`) and credited again on every replay
(:func:`credit`), so the counts of a solve read the same as eager ones;
with telemetry on, a replay also adds its SpMV applies to the
``amgx_spmv_dispatch_total`` metric.

Scopes under replay (telemetry on): a replay runs no Python, so the
``amgx/<area>/<name>`` ranges (``telemetry/scopes.py``) that name each
eager launch are absent from a replay's trace.  While a graph is
captured, every range boundary notes how many nodes the capture holds
(:func:`scope_mark`); after the capture each kernel, copy and set node
(in the order the capture created them, which a one-stream capture
replays in) knows the ranges open when it was captured
(``CudaGraphCall.scope_maps``).  Each replay of a segment runs inside a
``record_function`` range ``amgx_graph:<n>.<k>``, by which
``telemetry/deviceprof.py`` finds the map of the graph a trace's
kernels came from.  Telemetry off, nothing is noted and a replay opens
no range; neither adds a node.
"""
from __future__ import annotations

import ctypes
import gc
import itertools
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

import torch

from ..errors import DeviceError


#: how many :class:`CudaGraphCall` warm-ups or captures are running
_building = 0
#: the capture in progress (:class:`_Segments`), or None
_segments = None
#: graphs captured since the last reset (a kept graph is not captured
#: again after a resetup)
CAPTURES = {"count": 0}
#: held through every warm-up and capture: a process-wide change that
#: must not land inside a capture (starting or stopping the profiler,
#: ``telemetry/httpd.py``) takes it too
CAPTURE_LOCK = threading.RLock()


#: live graphs by their number (the ``amgx_graph:<n>.<k>`` ranges)
GRAPHS: "weakref.WeakValueDictionary[int, CudaGraphCall]" = \
    weakref.WeakValueDictionary()
_graph_ids = itertools.count(1)
#: node types that appear as device activities in a profiler trace
_KERNEL, _MEMCPY, _MEMSET = 0, 1, 2


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


def host_step(fn: Callable, b: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """``fn(b, x)`` on CPU copies of ``b`` and ``x``, its result (shaped
    and typed like ``x``) brought back to their device: an entry into
    the host tail of a hierarchy.  Eagerly it runs at once; inside a
    segmented capture it cuts the graph here and records the step, which
    every replay runs between the two segments (:class:`_Segments`)."""
    if _segments is not None:
        return _segments.cut(fn, b, x)
    host = torch.device("cpu")
    return fn(b.to(host), x.to(host)).to(x.device)


class _Segments:
    """The state of a segmented capture: the segment graphs so far (the
    last one capturing), and per host step the function, its device
    inputs (produced by the segment before it) and the static tensor the
    segment after it reads."""

    def __init__(self, pool):
        self.pool = pool
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.steps: list = []
        #: per segment, the scope ranges open at its start and its
        #: boundary marks (node count, range name or None for a close)
        self.opened: List[List[str]] = []
        self.marks: List[list] = []
        self.stack: List[str] = []
        self.begin()

    def begin(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self.graphs.append(g)
        self.opened.append(list(self.stack))
        self.marks.append([])

    def mark(self, name: Optional[str]):
        self.marks[-1].append((_capture_nodes(), name))
        if name is not None:
            self.stack.append(name)
        elif self.stack:
            self.stack.pop()

    def cut(self, fn, b, x):
        self.graphs[-1].capture_end()
        ret = torch.empty_like(x)
        self.steps.append((fn, b, x, ret))
        self.begin()
        return ret

    def replay(self, names=None):
        host = torch.device("cpu")
        for k, g in enumerate(self.graphs):
            if names is None:
                g.replay()
            else:
                with torch.profiler.record_function(names[k]):
                    g.replay()
            if k < len(self.steps):
                fn, b, x, ret = self.steps[k]
                ret.copy_(fn(b.to(host), x.to(host)))


def scope_mark(name: Optional[str]) -> None:
    """A scope range opened (``name``) or closed (None): noted with the
    node count of the capture in progress, if any."""
    if _segments is not None:
        _segments.mark(name)


def _libcuda():
    return ctypes.CDLL("libcuda.so.1")


def _capture_nodes() -> int:
    """Nodes of the graph the current stream is capturing
    (``cuStreamGetCaptureInfo`` then ``cuGraphGetNodes``)."""
    lib = _libcuda()
    status, cid = ctypes.c_int(0), ctypes.c_uint64(0)
    graph, deps = ctypes.c_void_p(), ctypes.c_void_p()
    ndeps = ctypes.c_size_t(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    fn = getattr(lib, "cuStreamGetCaptureInfo_v2", None)
    if fn is not None:
        rc = fn(stream, ctypes.byref(status), ctypes.byref(cid),
                ctypes.byref(graph), ctypes.byref(deps),
                ctypes.byref(ndeps))
    else:
        edges = ctypes.c_void_p()
        rc = lib.cuStreamGetCaptureInfo_v3(
            stream, ctypes.byref(status), ctypes.byref(cid),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(edges),
            ctypes.byref(ndeps))
    if rc != 0:
        raise DeviceError(f"cuStreamGetCaptureInfo failed (code {rc})")
    count = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(graph, None, ctypes.byref(count))
    if rc != 0:
        raise DeviceError(f"cuGraphGetNodes failed (code {rc})")
    return int(count.value)


def _kernel_name(lib, node) -> Optional[str]:
    """The (mangled) function name of a kernel node, where the driver
    can say it (``cuFuncGetName``, CUDA 12.3 and later); else None."""
    params = (ctypes.c_byte * 128)()
    get = getattr(lib, "cuGraphKernelNodeGetParams_v2", None) or \
        getattr(lib, "cuGraphKernelNodeGetParams", None)
    name_of = getattr(lib, "cuFuncGetName", None)
    if get is None or name_of is None or \
            get(node, ctypes.byref(params)) != 0:
        return None
    func = ctypes.c_void_p.from_buffer(params, 0)
    if not func.value:
        return None
    out = ctypes.c_char_p()
    if name_of(ctypes.byref(out), func) != 0 or out.value is None:
        return None
    return out.value.decode(errors="replace")


def node_scopes(graph: torch.cuda.CUDAGraph, opened: List[str],
                marks: list) -> List[tuple]:
    """``(node type, kernel name or None, scope chain)`` of each kernel,
    copy and set node of a captured graph, in the order the capture
    created them; the chain joins the ranges open when the node was
    captured, outermost first."""
    lib = _libcuda()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(g, None, ctypes.byref(count)) != 0:
        raise DeviceError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if lib.cuGraphGetNodes(g, nodes, ctypes.byref(count)) != 0:
        raise DeviceError("cuGraphGetNodes failed")
    out = []
    typ = ctypes.c_int(0)
    for i, chain in enumerate(node_chains(count.value, opened, marks)):
        if lib.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                  ctypes.byref(typ)) != 0:
            raise DeviceError("cuGraphNodeGetType failed")
        if typ.value in (_KERNEL, _MEMCPY, _MEMSET):
            kname = _kernel_name(lib, ctypes.c_void_p(nodes[i])) \
                if typ.value == _KERNEL else None
            out.append((typ.value, kname, chain))
    return out


def node_chains(n_nodes: int, opened: List[str], marks: list) -> List[str]:
    """The scope chain of each of ``n_nodes`` nodes: a mark (c, name)
    opens ``name`` (or, with None, closes the innermost range) for the
    nodes from the c-th on; ``opened`` were open at the start."""
    stack, mi, out = list(opened), 0, []
    for i in range(n_nodes):
        while mi < len(marks) and marks[mi][0] <= i:
            name = marks[mi][1]
            if name is not None:
                stack.append(name)
            elif stack:
                stack.pop()
            mi += 1
        out.append("/".join(stack))
    return out


def counters() -> List[Dict[str, int]]:
    """Every launch and dispatch counter of the port, as the dicts
    themselves (their identity is what the wrappers update)."""
    from .. import device
    from ..ops import binned_spmv, dia_spmv, ell_spmv, shift_spmv, spmv
    return [spmv.DISPATCH, spmv.ON_CUDA, dia_spmv.LAUNCHES,
            ell_spmv.LAUNCHES, shift_spmv.LAUNCHES,
            *binned_spmv.LAUNCHES.values(), device.HOST_SYNCS,
            spmv.MODEL_BYTES]


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
    counters, and with telemetry on its SpMV applies to the
    ``amgx_spmv_dispatch_total`` metric."""
    from ..ops import spmv
    from ..telemetry import metrics, recorder
    live = counters()
    for c, d in zip(live, delta):
        for k, v in d.items():
            c[k] += v
    if recorder.is_enabled():
        for c, d in zip(live, delta):
            if c is spmv.DISPATCH:
                for k, v in d.items():
                    metrics.counter_inc("amgx_spmv_dispatch_total",
                                        float(v), pack=k)


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
    """``fn(*args)`` (CUDA tensors in, one CUDA tensor out) captured as
    CUDA graph segments cut at each :func:`host_step` — one graph when
    ``fn`` takes none.  Construction runs the warm-up and the capture;
    :meth:`take_first` hands out the warm-up's result, :meth:`__call__`
    replays.

    ``stats`` records the capture: seconds of the eager warm-up, of the
    capture and of the instantiation, the node count (summed over the
    segments), the bytes its private pool reserved, and the segment and
    host-step counts (1 and 0 without a host tail)."""

    def __init__(self, fn: Callable, *args: torch.Tensor):
        with CAPTURE_LOCK:
            self._build(fn, *args)

    def _build(self, fn: Callable, *args: torch.Tensor):
        from ..telemetry import metrics, recorder, setup_profile
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

        def capture():
            global _segments
            # a garbage collection inside the capture may free another
            # graph (an old solver's, held by a reference cycle), whose
            # destruction invalidates the capture: collect first, then
            # hold the collector off until the capture ends
            torch.cuda.synchronize(dev)
            gc.collect()
            enabled = gc.isenabled()
            gc.disable()
            side.wait_stream(cur)
            try:
                with torch.cuda.stream(side):
                    seg = _Segments(torch.cuda.graph_pool_handle())
                    _segments = seg
                    try:
                        out = _built(fn, *self.static_in)
                    finally:
                        # a capture that raises ends its open segment
                        _segments = None
                        seg.graphs[-1].capture_end()
                cur.wait_stream(side)
                self.segments = seg
                return out
            finally:
                if enabled:
                    gc.enable()

        self.static_out, self.delta = counted_capture(capture)
        CAPTURES["count"] += 1
        t2 = time.perf_counter()
        metrics.counter_inc("amgx_jit_trace_total")
        setup_profile.note_duration(False, t2 - t1)
        graphs = self.segments.graphs
        nodes = sum(graph_nodes(g) for g in graphs)
        #: per segment, the scope chain of each kernel, copy and set
        #: node (telemetry on at capture), else None
        self.scope_maps = None
        self.number = next(_graph_ids)
        if recorder.is_enabled():
            seg = self.segments
            self.scope_maps = [node_scopes(g, o, m) for g, o, m in
                               zip(graphs, seg.opened, seg.marks)]
            GRAPHS[self.number] = self
        for g in graphs:
            g.instantiate()
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.first: Optional[torch.Tensor] = first
        self.stats = dict(
            warmup_s=t1 - t0, capture_s=t2 - t1,
            instantiate_s=t3 - t2, nodes=nodes,
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
            segments=len(graphs), host_steps=len(self.segments.steps))

    def take_first(self) -> torch.Tensor:
        """The warm-up's result (the first call's answer), handed out
        once."""
        out, self.first = self.first, None
        return out

    def range_names(self) -> List[str]:
        """The ``record_function`` range of each segment's replay."""
        return [f"amgx_graph:{self.number}.{k}"
                for k in range(len(self.segments.graphs))]

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        from ..telemetry import recorder
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        self.segments.replay(self.range_names()
                             if recorder.is_enabled() else None)
        credit(self.delta)
        return self.static_out.clone()
