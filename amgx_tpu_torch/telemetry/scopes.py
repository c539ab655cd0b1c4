"""The versioned ``amgx/<area>/<name>`` scope contract (port of
``amgx_tpu/telemetry/scopes.py``).

Host spans measure when work was *queued*; to attribute measured
**device** time to amgx concepts, the code that launches the kernels
runs inside :func:`scope` ranges — a ``torch.profiler.record_function``
range (and an NVTX range on a card) named ``amgx/<area>/<name>``.
:mod:`.deviceprof` joins each kernel of a ``torch.profiler`` trace back
to the ranges open when it was launched; a kernel replayed from a CUDA
graph is joined through the scopes recorded while the graph was
captured (``utils/cuda_graph.py``: each range boundary notes how many
nodes the capture held, so every node knows its ranges).

``<area>`` is one of :data:`AREAS` and every ``/``-separated segment
matches ``[a-z0-9_]+`` (so :func:`extract_scopes` can cut the contract
prefix out of a longer string).  The vocabulary per area:

* ``cycle``  — ``level<N>/{pre_smooth,post_smooth,restrict,prolong}``,
  ``coarse_solve``, ``kcycle<N>`` (amg/cycles.py)
* ``spmv``   — the sanitised dispatch labels of :data:`SPMV_PACKS`
  (ops/spmv.py; ``-`` → ``_``)
* ``smoother`` — the smoother's config name, sanitised (solvers/base.py
  wraps every smoother application)
* ``krylov`` — the stage vocabulary :data:`KRYLOV_STAGES`
  (solvers/krylov.py)
* ``dist``   — ``halo_exchange`` (distributed/matrix.py)

With telemetry off :func:`scope` costs one attribute check and returns
a shared no-op context: no range is opened and a capture records
nothing.  :data:`SCOPE_VERSION` is the JAX package's, so the two read
each other's ``device_anatomy`` events.
"""
from __future__ import annotations

import contextlib
import re
from typing import Iterable, List, Optional

from . import recorder as _recorder

#: version of the naming contract carried by every device_anatomy event
SCOPE_VERSION = 1

#: the taxonomy's top-level areas
AREAS = ("cycle", "spmv", "smoother", "krylov", "dist")

#: every label the port's SpMV dispatch (ops/spmv.py ``DISPATCH``) can
#: scope an apply with, plus ``dia3`` (a composition of three DIA
#: applies); the un-sanitised spelling
SPMV_PACKS = (
    "dia3", "op",
    "dia/kernel", "dia/slices", "dia/block-kernel", "dia/block-slices",
    "dense", "dense/lanes",
    "ell/shift", "ell/window", "ell/binned", "ell/gather",
    "ell/binned-block", "ell/block-gather",
    "csr/binned", "csr/binned-block",
    "csr/segsum", "csr/segsum-lean", "csr/block-segsum",
    "sharded/window", "sharded/gather", "sharded/block-binned",
    "sharded/block-plain",
)

#: the Krylov per-stage vocabulary (solvers/krylov.py)
KRYLOV_STAGES = ("precond", "reduce", "arnoldi", "givens", "update")

#: the per-level cycle components (amg/cycles.py)
CYCLE_COMPONENTS = ("pre_smooth", "post_smooth", "restrict", "prolong")

_SEG = r"[a-z0-9_]+"
#: full-match check of a finished scope name
SCOPE_RE = re.compile(rf"amgx(?:/{_SEG})+\Z")
#: extraction hint over raw trace strings (op names / metadata) — no
#: trailing anchor; dots, hyphens, uppercase terminate the match
TRACE_RE = re.compile(rf"amgx(?:/{_SEG})+")

_CYCLE_LEVEL_RE = re.compile(r"level\d+\Z")
_KCYCLE_RE = re.compile(r"kcycle\d+\Z")


def sanitize(name: str) -> str:
    """Map any label into the scope segment alphabet: lowercase, and
    every character outside ``[a-z0-9_/]`` becomes ``_`` (so the pack
    name ``ell/binned-block`` scopes as ``ell/binned_block``)."""
    return re.sub(r"[^a-z0-9_/]", "_", str(name).lower())


def scope_name(area: str, name: str) -> str:
    """The contract name ``amgx/<area>/<sanitised name>``.

    Raises ``ValueError`` on an unknown area or a name that cannot be
    sanitised into the contract (empty segments).
    """
    if area not in AREAS:
        raise ValueError(f"unknown scope area {area!r} "
                         f"(contract v{SCOPE_VERSION} areas: {AREAS})")
    s = f"amgx/{area}/{sanitize(name)}"
    if not SCOPE_RE.match(s):
        raise ValueError(f"scope name {s!r} violates the "
                         f"amgx/<area>/<name> contract")
    return s


class _Scope:
    """An open contract range: ``record_function``, an NVTX range on a
    card, and the boundary marks of a capture in progress."""

    __slots__ = ("name", "rf", "nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch
        from ..utils import cuda_graph
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.nvtx = torch.cuda.is_available() and \
            torch.cuda.is_initialized()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        cuda_graph.scope_mark(self.name)
        return self

    def __exit__(self, *exc):
        import torch
        from ..utils import cuda_graph
        cuda_graph.scope_mark(None)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(*exc)
        return False


_NULL = contextlib.nullcontext()


def scope(area: str, name: str):
    """The contract range ``amgx/<area>/<name>`` (the one primitive every
    instrumented launch site calls); a shared no-op context when
    telemetry is off."""
    if not _recorder._STATE.enabled:
        return _NULL
    return _Scope(scope_name(area, name))


def validate(name: str) -> bool:
    """True iff ``name`` is a well-formed contract scope name with a
    known area."""
    if not isinstance(name, str) or not SCOPE_RE.match(name):
        return False
    parts = name.split("/")
    return len(parts) >= 3 and parts[1] in AREAS


#: sanitised pack names, longest first so two-segment packs win the
#: prefix match over their one-segment heads
_SPMV_LEAVES = sorted({sanitize(p) for p in SPMV_PACKS},
                      key=lambda p: -p.count("/"))


def canonicalize(raw: str) -> Optional[str]:
    """Trim a trace-extracted ``amgx/…`` string back to its contract
    scope name, dropping trailing segments that are not part of it
    ("amgx/cycle/level0/pre_smooth/fusion" →
    "amgx/cycle/level0/pre_smooth").  None when the string is not a
    recognisable scope."""
    if not isinstance(raw, str) or not raw.startswith("amgx/"):
        return None
    segs = raw.split("/")[1:]
    if len(segs) < 2:
        return None
    area, rest = segs[0], segs[1:]
    leaf: Optional[List[str]] = None
    if area == "cycle":
        if _CYCLE_LEVEL_RE.match(rest[0]) and len(rest) >= 2 \
                and rest[1] in CYCLE_COMPONENTS:
            leaf = rest[:2]
        elif rest[0] == "coarse_solve" or _KCYCLE_RE.match(rest[0]):
            leaf = rest[:1]
    elif area == "spmv":
        joined = "/".join(rest)
        for pack in _SPMV_LEAVES:
            if joined == pack or joined.startswith(pack + "/"):
                leaf = pack.split("/")
                break
    elif area == "smoother":
        leaf = rest[:1]
    elif area == "krylov":
        if rest[0] in KRYLOV_STAGES:
            leaf = rest[:1]
    elif area == "dist":
        if rest[0] == "halo_exchange":
            leaf = rest[:1]
    if leaf is None:
        return None
    name = "/".join(["amgx", area] + leaf)
    return name if validate(name) else None


def extract_scopes(text: str) -> List[str]:
    """Every canonical scope name embedded in a raw trace string,
    outermost first.  Nested scopes concatenate
    ("amgx/cycle/level0/pre_smooth/amgx/spmv/dia3/…", the chain
    :mod:`.deviceprof` writes on each kernel), so each interior
    ``amgx/`` segment boundary starts a new candidate."""
    out: List[str] = []
    for m in TRACE_RE.finditer(text):
        raw = m.group(0)
        starts = [i for i in range(len(raw))
                  if raw.startswith("amgx/", i)
                  and (i == 0 or raw[i - 1] == "/")]
        for j, st in enumerate(starts):
            end = starts[j + 1] if j + 1 < len(starts) else len(raw)
            c = canonicalize(raw[st:end].rstrip("/"))
            if c and c not in out:
                out.append(c)
    return out


def scopes_in_event(ev: dict) -> List[str]:
    """The canonical scopes referenced by one chrome-trace event: its
    name plus any string ``args`` values (:mod:`.deviceprof` writes a
    kernel's scope chain in ``args["amgx_scopes"]``; the JAX package's
    traces carry it in op metadata)."""
    found = extract_scopes(str(ev.get("name", "")))
    args = ev.get("args")
    if isinstance(args, dict):
        for v in args.values():
            if isinstance(v, str):
                for s in extract_scopes(v):
                    if s not in found:
                        found.append(s)
    return found


def smoother_scopes(names: Iterable[str]) -> List[str]:
    """Contract scope names for a set of smoother config names (what
    the coverage lint expects solvers/base.py to emit)."""
    return [scope_name("smoother", n) for n in names]
