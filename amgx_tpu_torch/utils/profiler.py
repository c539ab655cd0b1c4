"""CPU profiler tree + phase timers.

Reference: ``base/include/amgx_timer.h`` — ``Profiler_tree`` /
``Profiler_entry`` aggregating RAII ``AMGX_CPU_PROFILER`` markers
(``amgx_timer.h:150-274``), per-level phase timers (``levelProfile``).  Here: nested context-manager markers aggregated in a
tree, plus optional forwarding to ``torch.profiler.record_function``
(and an NVTX range while a card is present) so markers show up in
``torch.profiler`` traces (port of ``amgx_tpu/utils/profiler.py``).

Every marker also doubles as a telemetry span: when the structured
telemetry layer (:mod:`amgx_tpu.telemetry`) is enabled, ``scope()``
appends typed ``span_begin``/``span_end`` records to its ring buffer —
one instrumentation point, two consumers (the in-process aggregate tree
and the exportable trace).
"""
from __future__ import annotations

import contextlib
import warnings
import time
from typing import Dict, Optional

from ..telemetry import recorder as _telemetry

_forward = False


def enable_trace_annotations(enable: bool = True):
    """Forward every marker to ``torch.profiler.record_function`` (and
    NVTX on a card); off by default."""
    global _forward
    _forward = enable


class _Annotation:
    """A ``record_function`` range, plus an NVTX range when CUDA is up."""

    __slots__ = ("rf", "nvtx")

    def __init__(self, name: str):
        import torch
        self.rf = torch.profiler.record_function(name)
        self.nvtx = torch.cuda.is_available() and \
            torch.cuda.is_initialized()
        self.rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self):
        if self.nvtx:
            import torch
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(None, None, None)


class ProfilerEntry:
    __slots__ = ("name", "total", "count", "children", "_start")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: Dict[str, "ProfilerEntry"] = {}
        self._start = 0.0

    def child(self, name):
        if name not in self.children:
            self.children[name] = ProfilerEntry(name)
        return self.children[name]


class ProfilerTree:
    """Singleton-ish profiler tree (reference Profiler_tree)."""

    def __init__(self):
        self.root = ProfilerEntry("root")
        self._stack = [self.root]

    @contextlib.contextmanager
    def scope(self, name: str, _attrs: Optional[dict] = None):
        entry = self._stack[-1].child(name)
        self._stack.append(entry)
        try:
            # annotation setup BEFORE the timer starts: an import/enter
            # failure here must neither corrupt the stack depth (the
            # outer finally pops) nor charge its cost to the entry
            ann = _Annotation(name) if _forward else None
            try:
                sid = _telemetry.span_begin(name, _attrs) \
                    if _telemetry.is_enabled() else None
                t0 = time.perf_counter()
                try:
                    yield entry
                finally:
                    entry.total += time.perf_counter() - t0
                    entry.count += 1
                    _telemetry.span_end(sid, name)
            finally:
                if ann is not None:
                    ann.close()
        finally:
            self._stack.pop()

    def report(self) -> str:
        lines = []

        def rec(entry, depth):
            if depth > 0:
                lines.append(f"{'  ' * depth}{entry.name:<40s} "
                             f"{entry.total:10.6f}s  x{entry.count}")
            for c in entry.children.values():
                rec(c, depth + 1)

        rec(self.root, 0)
        return "\n".join(lines)

    def reset(self):
        self.root = ProfilerEntry("root")
        self._stack = [self.root]


import threading as _threading

_tls = _threading.local()


def profiler_tree() -> ProfilerTree:
    """Per-THREAD profiler tree: markers now live in the library's hot
    paths, and concurrent solver instances (amgx_capi_multi-style
    drivers) must not interleave push/pops on one shared stack."""
    tree = getattr(_tls, "tree", None)
    if tree is None:
        tree = _tls.tree = ProfilerTree()
    return tree


def cpu_profiler(name: str):
    """RAII marker (reference AMGX_CPU_PROFILER, amgx_timer.h:269)."""
    return profiler_tree().scope(name)


#: warn-once latch for TimerMap.toc-without-tic (module-wide: the
#: mistake is a call-site bug, not per-instance state)
_TOC_WARNED = False


class TimerMap:
    """Named wall-clock timers (reference TimerMap, amgx_timer.h:435)."""

    def __init__(self):
        self._timers: Dict[str, float] = {}
        self._starts: Dict[str, float] = {}

    def tic(self, name):
        self._starts[name] = time.perf_counter()

    def toc(self, name) -> float:
        t0 = self._starts.pop(name, None)
        if t0 is None:
            # toc without tic: 0.0 without an entry in the map, and a
            # warning once per process
            global _TOC_WARNED
            if not _TOC_WARNED:
                _TOC_WARNED = True
                warnings.warn(
                    f"TimerMap.toc({name!r}) called without a matching "
                    "tic(); returning 0.0", RuntimeWarning, stacklevel=2)
            return 0.0
        dt = time.perf_counter() - t0
        self._timers[name] = self._timers.get(name, 0.0) + dt
        return dt

    def get(self, name) -> float:
        return self._timers.get(name, 0.0)

    def report(self) -> str:
        return "\n".join(f"{k:<30s} {v:10.6f}s"
                         for k, v in sorted(self._timers.items()))
