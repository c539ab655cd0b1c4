"""Shared ``torch.profiler`` chrome-trace plumbing (port of
``amgx_tpu/telemetry/proftrace.py``).

:mod:`amgx_tpu_torch.telemetry.deviceprof` needs these mechanics:
resolve a trace argument to a file (``prof.export_chrome_trace`` output,
gzipped or not, or a directory of them: the newest wins), load it,
normalise the accepted trace spellings (path / loaded dict / raw event
iterable) to an event list, do interval arithmetic over complete
("X") slices, and join a trace's device activities to the
``amgx/<area>/<name>`` ranges that launched them
(:func:`scoped_device_slices`).  Host-side file parsing only.
"""
from __future__ import annotations

import gzip
import json
import os
import re
from typing import Iterable, Iterator, List, Optional

#: device activity categories of a torch.profiler trace, and the node
#: type (utils/cuda_graph.py) each corresponds to
DEVICE_CATS = {"kernel": 0, "gpu_memcpy": 1, "gpu_memset": 2}
#: host-side launch calls (runtime and driver API) carrying the
#: correlation id of the device activities they started
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: record_function ranges on the host
ANNOTATION_CAT = "user_annotation"
#: prefix of the range a CUDA graph segment's replay runs in
GRAPH_RANGE = "amgx_graph:"

#: trace-viewer metadata / host-side bookkeeping phases that are not
#: device work at all
SKIP_PH = {"M", "I", "C"}


def load_json(path: str) -> Optional[dict]:
    """Load a chrome-trace JSON file (gzip-aware); None on any error."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def find_trace_file(path: str) -> Optional[str]:
    """Resolve a trace argument to a concrete chrome-trace file.

    Accepts the file itself (any ``.json`` / ``.json.gz``) or a
    directory, searched recursively for ``*.json`` / ``*.json.gz`` (as
    ``torch.profiler.tensorboard_trace_handler`` writes them); the
    newest match wins.
    """
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        return None
    hits: List[str] = []
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f.endswith((".json", ".json.gz")):
                hits.append(os.path.join(root, f))
    if not hits:
        return None
    return max(hits, key=lambda p: os.path.getmtime(p))


def trace_events(trace: "str | dict | Iterable[dict]") -> List[dict]:
    """Normalise any accepted trace spelling to its event list.

    ``trace``: a path (file or profiler logdir), a loaded chrome-trace
    dict, or an iterable of trace events.  Returns ``[]`` when the path
    resolves to nothing or the file is unreadable/malformed — callers
    then degrade the same way they would on an empty capture.
    """
    if isinstance(trace, str):
        f = find_trace_file(trace)
        data = load_json(f) if f else None
        if data is None:
            return []
        ev = data.get("traceEvents", [])
        return ev if isinstance(ev, list) else []
    if isinstance(trace, dict):
        ev = trace.get("traceEvents", [])
        return ev if isinstance(ev, list) else []
    try:
        return list(trace)
    except TypeError:           # None, int, ... — nothing to measure
        return []


def complete_slices(events: Iterable[dict]) -> Iterator[dict]:
    """The complete ("X") duration slices of a trace: every event that
    carries real wall extent (metadata/instant/counter phases and
    zero/None-duration rows are dropped).  Malformed rows (non-dict, or
    non-numeric ts/dur) are skipped rather than raised — profiler traces
    in the wild carry junk."""
    for ev in events:
        if not isinstance(ev, dict):
            continue
        if ev.get("ph", "X") in SKIP_PH:
            continue
        dur = ev.get("dur")
        ts = ev.get("ts")
        if not isinstance(dur, (int, float)) or \
                not isinstance(ts, (int, float)) or dur <= 0:
            continue
        yield ev


def merge_intervals(iv: List[tuple]) -> List[tuple]:
    """Coalesce (start, end) intervals into a sorted disjoint cover."""
    iv = sorted(iv)
    out: List[tuple] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_len(s: float, e: float, merged: List[tuple]) -> float:
    """Length of [s, e) covered by a :func:`merge_intervals` result."""
    total = 0.0
    for ms, me in merged:
        if me <= s:
            continue
        if ms >= e:
            break
        total += min(e, me) - max(s, ms)
    return total


def union_len(iv: List[tuple]) -> float:
    """Total length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merge_intervals(iv))


# ------------------------------------------- torch.profiler scope join
def is_device_trace(events: List[dict]) -> bool:
    """True when the events hold torch.profiler device activities."""
    return any(isinstance(ev, dict) and ev.get("cat") in DEVICE_CATS
               for ev in events)


def _enclosing(annotations: List[tuple], queries: List[tuple]) -> dict:
    """For each query (t, key) on one thread, the names of the
    annotation ranges (start, end, name) containing t, outermost first;
    the ranges of one thread nest (record_function is a stack)."""
    out = {}
    ann = sorted(annotations, key=lambda a: (a[0], -a[1]))
    stack: List[tuple] = []
    ai = 0
    for t, key in sorted(queries, key=lambda q: q[0]):
        while ai < len(ann) and ann[ai][0] <= t:
            while stack and stack[-1][1] < ann[ai][0]:
                stack.pop()
            stack.append(ann[ai])
            ai += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [a[2] for a in stack if a[1] >= t]
    return out


def scoped_device_slices(events: List[dict],
                         graph_maps: Optional[dict] = None
                         ) -> "tuple[List[dict], dict]":
    """The device activities (kernels, copies, sets) of a torch.profiler
    trace, each with ``args["amgx_scopes"]``: the ``amgx/…`` ranges open
    on the launching thread when it was launched, outermost first,
    joined by ``/``.

    A kernel replayed from a CUDA graph was launched by the graph launch
    inside an ``amgx_graph:<n>.<k>`` range; ``graph_maps[(n, k)]`` is
    that segment's node list (``CudaGraphCall.scope_maps``): the
    launch's activities, in start order, take the node chains in order
    when their count and kinds match the map node for node (and, where
    both names are known, each kernel's name appears in its node's);
    else they keep the launch's own ranges only.  A launch whose first
    or last activities the profiler did not record (a replay running as
    the profile starts) maps onto the nodes its activities match as a
    suffix or a prefix of the map.  Returns ``(slices, stats)``;
    ``stats`` counts the graph launches seen, mapped and mapped partly,
    and the kernel names checked."""
    annotations: dict = {}
    launches: dict = {}
    device: dict = {}
    for ev in complete_slices(events):
        cat = ev.get("cat")
        args = ev.get("args") or {}
        if cat == ANNOTATION_CAT:
            name = str(ev.get("name", ""))
            if name.startswith("amgx/") or name.startswith(GRAPH_RANGE):
                annotations.setdefault(
                    (ev.get("pid"), ev.get("tid")), []).append(
                    (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                     name))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ev
        elif cat in DEVICE_CATS:
            device.setdefault(args.get("correlation"), []).append(ev)
    queries: dict = {}
    for corr, ev in launches.items():
        queries.setdefault((ev.get("pid"), ev.get("tid")), []).append(
            (float(ev["ts"]), corr))
    chain_of: dict = {}
    for key, q in queries.items():
        chain_of.update(_enclosing(annotations.get(key, []), q))
    stats = {"graph_launches": 0, "graph_launches_mapped": 0,
             "graph_launches_partial": 0, "names_checked": 0,
             "names_matched": 0}
    out: List[dict] = []
    for corr, evs in device.items():
        names = chain_of.get(corr, [])
        outer = [n for n in names if n.startswith("amgx/")]
        graph = [n for n in names if n.startswith(GRAPH_RANGE)]
        chains = ["/".join(outer)] * len(evs)
        evs = sorted(evs, key=lambda e: float(e["ts"]))
        rt = launches.get(corr)
        if rt is not None and "GraphLaunch" in str(rt.get("name", "")):
            stats["graph_launches"] += 1
            nodes = (graph_maps or {}).get(_graph_key(graph[-1])) \
                if graph else None
            part = _aligned(evs, nodes, stats) if nodes is not None \
                else None
            if part is not None:
                stats["graph_launches_mapped"] += 1
                stats["graph_launches_partial"] += len(part) < len(nodes)
                chains = ["/".join(c for c in ("/".join(outer), nd[2])
                                   if c) for nd in part]
        for ev, chain in zip(evs, chains):
            ev = dict(ev)
            if chain:
                ev["args"] = dict(ev.get("args") or {},
                                  amgx_scopes=chain)
            out.append(ev)
    return out, stats


def _graph_key(name: str) -> tuple:
    n, k = name[len(GRAPH_RANGE):].split(".")
    return int(n), int(k)


def _base_name(name: str) -> str:
    """The function's own identifier in a demangled kernel name
    ("void ns::dia_spmv_f32<4>(float const*, …)" → "dia_spmv_f32")."""
    s = name.replace("(anonymous namespace)::", "").split("(")[0]
    s = s.split("<")[0].strip().split(" ")[-1]
    return s.split("::")[-1]


def _aligned(evs: List[dict], nodes: List[tuple],
             stats: dict) -> Optional[List[tuple]]:
    """The nodes a graph launch's activities are, in order: all of them,
    or — when the profiler missed some at either end — the suffix or
    prefix they match; None when they match neither."""
    k = len(evs)
    if k > len(nodes):
        return None
    offsets = [0] if k == len(nodes) else [len(nodes) - k, 0]
    for off in offsets:
        trial: dict = {"names_checked": 0, "names_matched": 0}
        if _nodes_match(evs, nodes[off:off + k], trial):
            stats["names_checked"] += trial["names_checked"]
            stats["names_matched"] += trial["names_matched"]
            return nodes[off:off + k]
        stats.setdefault("mismatch", trial.get("mismatch"))
    return None


def _nodes_match(evs: List[dict], nodes: List[tuple], stats: dict) -> bool:
    """Whether a graph launch's activities are its map's nodes, in order:
    the same count, the same kinds, and each known kernel name's own
    identifier inside its node's name.  The first mismatch is kept in
    ``stats["mismatch"]``."""
    def miss(i, why):
        stats.setdefault("mismatch", dict(
            at=i, why=why, n_events=len(evs), n_nodes=len(nodes),
            events=[(e.get("cat"), str(e.get("name", ""))[:80])
                    for e in evs[max(i - 2, 0):i + 3]],
            nodes=[(t, (k or "")[:80]) for t, k, _c in
                   nodes[max(i - 2, 0):i + 3]]))
        return False

    if len(evs) != len(nodes):
        return miss(0, "count")
    for i, (ev, (typ, kname, _chain)) in enumerate(zip(evs, nodes)):
        if DEVICE_CATS.get(ev.get("cat")) != typ:
            return miss(i, "kind")
        if kname:
            stats["names_checked"] += 1
            base = _base_name(str(ev.get("name", "")))
            if base and base not in kname:
                return miss(i, "name")
            stats["names_matched"] += 1
    return True
