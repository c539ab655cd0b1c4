"""Device-memory ledger: ownership attribution and OOM post-mortems
(port of ``amgx_tpu/telemetry/memledger.py``).

On an accelerator the question "who owns these bytes" decides whether
the next setup fits.  This module is the bytes-side twin of
:mod:`amgx_tpu_torch.telemetry.deviceprof` (which attributes device
*time*): a process-wide ledger joining two sources:

* an **ownership registry** — allocation sites register their tensors
  under the versioned ``amgx/<owner>/<name>`` taxonomy (hierarchy level
  packs, P/R transfer packs, smoother state, coarse factors, the
  top-level operator pack, distributed packs, the tensors a CUDA graph
  holds — its static inputs and outputs in its private pool, owner
  ``amgx/solve/graph_<n>``).  Entries hold **weak references** so the
  ledger never pins memory; :func:`release` drops an entry, and a dead
  tensor simply stops counting.  Tensors are deduplicated by storage,
  so views and packs that share a storage (a precision view, a shared
  level pack) count once, charged to the first owner in
  :data:`OWNERS` order;
* the **allocator's truth** — ``torch.cuda.memory_stats()``
  ``allocated_bytes.all.current`` / ``.peak`` on a card, with the
  card's total memory as its limit.  On the CPU there is no allocator
  truth: ``bytes_in_use`` is the registered bytes, ``measured=false``.

The honesty invariant ``accounted + unaccounted ≡ bytes_in_use`` holds
per device in both modes and is test-asserted.

On a device out-of-memory — ``torch.cuda.OutOfMemoryError``, or the
``fault_inject`` point ``oom`` — the solver calls
:func:`emit_postmortem`, producing a schema-validated
``oom_postmortem`` event: ledger snapshot, top-k owners, recent
headroom history and eviction suggestions.

Zero-overhead contract: with the ``memledger`` knob off (default),
every entry point returns after one attribute check.
"""
from __future__ import annotations

import collections
import re
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

#: version of the ownership taxonomy carried by every ledger event
LEDGER_VERSION = 1

#: the taxonomy's owner areas.  Order matters: census claims resolve in
#: this order, and the AGGREGATE owners (whole-tree registrations that
#: overlap the specific packs — serve cache entries, solve bindings)
#: only claim buffers no specific owner claimed, so a hierarchy pack
#: inside a cached session is charged to ``hierarchy/…`` once.
OWNERS = ("hierarchy", "transfer", "smoother", "coarse", "matrix",
          "dist", "aot", "serve", "solve")

#: owners whose registrations are whole-tree aggregates of buffers that
#: specific owners may also claim
AGGREGATE_OWNERS = frozenset({"aot", "serve", "solve"})

_SEG = r"[a-z0-9_]+"
#: full-match check of a finished owner name
OWNER_RE = re.compile(rf"amgx(?:/{_SEG})+\Z")

#: samples kept in the headroom history ring (OOM post-mortems replay it)
HISTORY_LEN = 64


def sanitize(name: str) -> str:
    """Map any label into the owner segment alphabet (the scopes.py
    rule): lowercase, everything outside ``[a-z0-9_/]`` becomes ``_``."""
    return re.sub(r"[^a-z0-9_/]", "_", str(name).lower())


def owner_name(owner: str, name: str) -> str:
    """The contract name ``amgx/<owner>/<sanitised name>``; raises
    ``ValueError`` on an unknown owner or an unsanitisable name."""
    if owner not in OWNERS:
        raise ValueError(f"unknown ledger owner {owner!r} "
                         f"(contract v{LEDGER_VERSION} owners: {OWNERS})")
    s = f"amgx/{owner}/{sanitize(name)}"
    if not OWNER_RE.match(s):
        raise ValueError(f"owner name {s!r} violates the "
                         f"amgx/<owner>/<name> contract")
    return s


def validate(name: str) -> bool:
    """True iff ``name`` is a well-formed owner name with a known
    owner area."""
    if not isinstance(name, str) or not OWNER_RE.match(name):
        return False
    parts = name.split("/")
    return len(parts) >= 3 and parts[1] in OWNERS


# --------------------------------------------------------------- state
class _Entry:
    __slots__ = ("name", "refs", "host_bytes")

    def __init__(self, name: str):
        self.name = name
        #: weakrefs to the registered tensors (dead refs stop counting)
        self.refs: List[weakref.ref] = []
        #: host-side bytes — listed in the owners table, excluded from
        #: the device invariant
        self.host_bytes = 0


class _State:
    __slots__ = ("enabled", "lock", "entries", "token_counter",
                 "sample_s", "last_sample", "history")

    def __init__(self):
        self.enabled = False
        self.lock = threading.Lock()
        self.entries: Dict[int, _Entry] = {}
        self.token_counter = 0
        self.sample_s = 0.5
        self.last_sample = 0.0
        #: recent (t, device -> headroom/bytes_in_use) samples
        self.history: collections.deque = collections.deque(
            maxlen=HISTORY_LEN)


_STATE = _State()


def is_enabled() -> bool:
    return _STATE.enabled


def enable(sample_s: Optional[float] = None):
    """Turn the ledger on (idempotent); also enables the recorder so
    ledger events land in the ring (the setup_profile precedent)."""
    if sample_s is not None and float(sample_s) >= 0:
        _STATE.sample_s = float(sample_s)
    _STATE.enabled = True
    from . import recorder
    recorder.enable()


def disable():
    _STATE.enabled = False


def reset():
    """Drop all registrations and history (test isolation, via
    ``telemetry.reset``)."""
    with _STATE.lock:
        _STATE.entries.clear()
        _STATE.history.clear()
        _STATE.last_sample = 0.0
    _STATE.enabled = False


def entry_count() -> int:
    """Registered (un-released) entries — the register/release balance
    tests assert this returns to baseline across setup→teardown."""
    with _STATE.lock:
        return len(_STATE.entries)


# ------------------------------------------------------------ registry
def _tensor_leaves(tree, _seen=None, _depth=0) -> list:
    """The tensors of a tree of tensors, dataclasses, dicts, sequences
    and plain objects (their attributes), each object visited once."""
    import dataclasses
    import torch
    if _seen is None:
        _seen = set()
    if tree is None or id(tree) in _seen or _depth > 8:
        return []
    _seen.add(id(tree))
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (str, bytes, int, float, bool, type)):
        return []
    if isinstance(tree, dict):
        items = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        items = list(tree)
    elif dataclasses.is_dataclass(tree):
        items = [getattr(tree, f.name, None)
                 for f in dataclasses.fields(tree)]
    elif hasattr(tree, "__dict__"):
        items = list(vars(tree).values())
    else:
        return []
    out = []
    for v in items:
        out.extend(_tensor_leaves(v, _seen, _depth + 1))
    return out


def register(name: str, tree) -> Optional[int]:
    """Register the tensors of ``tree`` under ``name`` (a
    :func:`owner_name` contract string).  Returns an opaque token for
    :func:`release`, or None when the ledger is off (the zero-overhead
    path — the tree is not even traversed).

    The registry holds weakrefs only: registration never extends a
    tensor's lifetime, and a released or collected pack silently stops
    counting."""
    if not _STATE.enabled:
        return None
    if not validate(name):
        raise ValueError(f"invalid ledger owner name {name!r}")
    e = _Entry(name)
    for leaf in _tensor_leaves(tree):
        e.refs.append(weakref.ref(leaf))
    with _STATE.lock:
        _STATE.token_counter += 1
        tok = _STATE.token_counter
        _STATE.entries[tok] = e
    return tok


def register_bytes(name: str, nbytes: int) -> Optional[int]:
    """Register a host-byte owner: shown in the owners table, excluded
    from the device honesty invariant."""
    if not _STATE.enabled:
        return None
    if not validate(name):
        raise ValueError(f"invalid ledger owner name {name!r}")
    e = _Entry(name)
    e.host_bytes = max(int(nbytes), 0)
    with _STATE.lock:
        _STATE.token_counter += 1
        tok = _STATE.token_counter
        _STATE.entries[tok] = e
    return tok


def release(token: Optional[int]):
    """Drop one registration (None tokens — from a disabled-ledger
    register — are accepted and ignored)."""
    if token is None:
        return
    with _STATE.lock:
        _STATE.entries.pop(token, None)


# -------------------------------------------------------------- census
def _storage_key(t) -> Tuple[str, int, int]:
    """(device label, storage address, storage bytes) of a tensor: the
    dedupe key that makes views of one storage count once."""
    st = t.untyped_storage()
    return str(t.device), int(st.data_ptr()), int(st.nbytes())


def _census() -> Tuple[Dict[str, int], Dict[str, Dict[str, int]], int,
                       int]:
    """Per device the registered storages' bytes, each storage once, and
    per owner the bytes it claims: specific owners first, ``matrix``
    (the top-level operator pack, which an AMG hierarchy's level 0
    shares) after them, the aggregate owners last."""
    with _STATE.lock:
        entries = list(_STATE.entries.values())

    def rank(e: _Entry) -> int:
        parts = e.name.split("/")
        area = parts[1] if len(parts) > 1 else ""
        if area in AGGREGATE_OWNERS:
            return 2
        return 1 if area == "matrix" else 0

    seen: set = set()
    dev_census: Dict[str, int] = {}
    dev_owner: Dict[str, Dict[str, int]] = {}
    n_live = n_owned = 0
    for e in sorted(entries, key=rank):
        for ref in e.refs:
            t = ref()
            if t is None:
                continue
            n_live += 1
            dev, ptr, nb = _storage_key(t)
            if (dev, ptr) in seen or nb == 0:
                continue
            seen.add((dev, ptr))
            n_owned += 1
            dev_census[dev] = dev_census.get(dev, 0) + nb
            d = dev_owner.setdefault(dev, {})
            d[e.name] = d.get(e.name, 0) + nb
    return dev_census, dev_owner, n_live, n_owned


def _backend_stats() -> Dict[str, dict]:
    """Per card the allocator's stats (empty without CUDA — the CPU's
    honest stub)."""
    import torch
    out: Dict[str, dict] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if not ms:
            continue
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak",
                                            0)),
            "bytes_limit": int(
                torch.cuda.get_device_properties(i).total_memory)}
    return out


def snapshot() -> dict:
    """The ledger snapshot: per-device owner attribution of the
    registered storages joined to the allocator's stats.

    ALWAYS returns a dict; ``measured`` is True only when a card's
    allocator stats were read.  Per device: ``accounted_bytes +
    unaccounted_bytes == bytes_in_use`` exactly — without allocator
    stats, ``bytes_in_use`` is the registered bytes so the invariant
    stays arithmetic."""
    dev_census, dev_owner, n_live, n_owned = _census()
    stats = _backend_stats()
    measured = bool(stats)
    devices: Dict[str, dict] = {}
    for dev in sorted(set(dev_census) | set(stats)):
        owners = dict(sorted((dev_owner.get(dev) or {}).items()))
        accounted = sum(owners.values())
        census = dev_census.get(dev, 0)
        ms = stats.get(dev)
        if ms is not None:
            in_use = int(ms["bytes_in_use"])
            # a registered storage the caching allocator did not serve
            # (none today) could put the census above in_use; cap so the
            # invariant stays exact
            accounted = min(accounted, in_use)
            d = {
                "bytes_in_use": in_use,
                "accounted_bytes": accounted,
                "unaccounted_bytes": in_use - accounted,
                "census_bytes": census,
                "peak_bytes": int(ms["peak_bytes_in_use"]),
                "bytes_limit": int(ms["bytes_limit"]),
            }
            d["headroom_bytes"] = max(d["bytes_limit"] - in_use, 0)
        else:
            d = {
                "bytes_in_use": census,
                "accounted_bytes": accounted,
                "unaccounted_bytes": census - accounted,
                "census_bytes": census,
                "peak_bytes": 0,
                "bytes_limit": 0,
                "headroom_bytes": 0,
            }
        d["owners"] = owners
        devices[dev] = d

    owners_total: Dict[str, int] = {}
    for d in devices.values():
        for o, nb in d["owners"].items():
            owners_total[o] = owners_total.get(o, 0) + nb
    host_owners: Dict[str, int] = {}
    with _STATE.lock:
        entries = list(_STATE.entries.values())
        n_entries = len(entries)
    for e in entries:
        if e.host_bytes:
            host_owners[e.name] = host_owners.get(e.name, 0) \
                + e.host_bytes
    return {
        "measured": measured,
        "ledger_version": LEDGER_VERSION,
        "devices": devices,
        "owners": dict(sorted(owners_total.items())),
        "host_owners": dict(sorted(host_owners.items())),
        "n_live_arrays": n_live,
        "n_owned_arrays": n_owned,
        "registered_entries": n_entries,
    }


def top_owners(snap: dict, n: int = 5) -> List[Tuple[str, int]]:
    """The ``n`` largest (owner, bytes) pairs of a snapshot — what the
    post-mortem, doctor and bench_trend print."""
    ow = snap.get("owners") or {}
    return sorted(((k, int(v)) for k, v in ow.items()),
                  key=lambda kv: -kv[1])[:n]


# ----------------------------------------------------------- surfacing
def _record_history(snap: dict):
    sample = {dev: {"bytes_in_use": d["bytes_in_use"],
                    "headroom_bytes": d["headroom_bytes"]}
              for dev, d in (snap.get("devices") or {}).items()}
    with _STATE.lock:
        _STATE.history.append(
            {"t": time.perf_counter(), "devices": sample})


def headroom_history() -> List[dict]:
    with _STATE.lock:
        return list(_STATE.history)


def emit(snap: dict, phase: str = ""):
    """Record one snapshot: a schema-validated ``hbm_snapshot`` event
    plus the ``amgx_hbm_*`` gauges (owner family cleared first — a
    released owner must not leave a stale series).  No-op when
    telemetry is off."""
    from . import metrics, recorder
    if not recorder.is_enabled():
        return
    reg = metrics.registry()
    reg.gauge_clear("amgx_hbm_bytes")
    for dev, d in (snap.get("devices") or {}).items():
        for o, nb in (d.get("owners") or {}).items():
            metrics.gauge_set("amgx_hbm_bytes", nb, device=dev, owner=o)
        if snap.get("measured"):
            metrics.gauge_set("amgx_hbm_headroom_bytes",
                              d["headroom_bytes"], device=dev)
            metrics.gauge_set("amgx_hbm_peak_bytes",
                              d["peak_bytes"], device=dev)
    recorder.event("hbm_snapshot", phase=str(phase), **snap)


def maybe_sample(phase: str = "", force: bool = False) -> Optional[dict]:
    """Rate-limited snapshot+emit — the hook solver setup phases, solve
    completion and serve dispatch call.  Honours ``memledger_sample_s``
    (0 = sample every call); returns the snapshot when one was taken."""
    if not _STATE.enabled:
        return None
    now = time.perf_counter()
    if not force and _STATE.sample_s > 0 \
            and (now - _STATE.last_sample) < _STATE.sample_s:
        return None
    _STATE.last_sample = now
    snap = snapshot()
    _record_history(snap)
    emit(snap, phase=phase)
    return snap


# ------------------------------------------------------- OOM handling
def is_oom_error(err: BaseException) -> bool:
    """True for device out-of-memory failures: the AMGX ``NO_MEMORY``
    return code (faultinject's injected OOM) and PyTorch's
    ``torch.cuda.OutOfMemoryError``."""
    import torch
    from ..errors import AMGXError, RC
    if isinstance(err, AMGXError) and err.rc == RC.NO_MEMORY:
        return True
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    s = str(err).lower()
    return ("resource_exhausted" in s or "resource exhausted" in s
            or "out of memory" in s or "out-of-memory" in s)


def suggestions(snap: dict) -> List[dict]:
    """Doctor-grade eviction suggestions ordered by relevance to what
    is actually resident (each a ``{knob, hint}`` pair)."""
    ow = snap.get("owners") or {}
    out: List[dict] = []
    if any(k.startswith("amgx/hierarchy/")
           or k.startswith("amgx/transfer/") for k in ow):
        out.append({"knob": "hierarchy_dtype",
                    "hint": "store coarse hierarchy packs in bfloat16 "
                            "(hierarchy_dtype=bfloat16) — roughly "
                            "halves level+transfer bytes"})
    if any(k.startswith("amgx/dist/") for k in ow):
        out.append({"knob": "dist_agglomerate_min_rows",
                    "hint": "raise the agglomeration threshold so "
                            "coarse levels consolidate onto fewer "
                            "devices earlier"})
    if not out:
        out.append({"knob": "memledger",
                    "hint": "no owned bytes resident — the allocation "
                            "likely predates ledger registration; "
                            "free cached blocks "
                            "(torch.cuda.empty_cache) and retry"})
    return out


def postmortem(err: BaseException, where: str,
               snap: Optional[dict] = None) -> dict:
    """Build the OOM post-mortem bundle (pure — no emission)."""
    if snap is None:
        snap = snapshot()
    msg = str(err)
    return {
        "where": str(where),
        "error": msg[:500],
        "error_type": type(err).__name__,
        "injected": "injected" in msg,
        "ledger_version": LEDGER_VERSION,
        "measured": bool(snap.get("measured")),
        "snapshot": snap,
        "top_owners": [[k, v] for k, v in top_owners(snap)],
        "headroom_history": headroom_history(),
        "suggestions": suggestions(snap),
    }


def emit_postmortem(err: BaseException, where: str,
                    in_recovery: bool = False) -> Optional[dict]:
    """Emit one schema-validated ``oom_postmortem`` event for a device
    OOM (idempotent per exception object: the solver and serve layers
    both wrap the same call stack, and the bundle must be emitted once,
    at the innermost layer that saw it).  Returns the bundle, or None
    when nothing was emitted (ledger off — the zero-overhead contract —
    or recorder off, or already emitted for this exception)."""
    from . import recorder
    if not _STATE.enabled or not recorder.is_enabled():
        return None
    if getattr(err, "_amgx_postmortem_emitted", False):
        return None
    try:
        err._amgx_postmortem_emitted = True
    except Exception:
        pass
    pm = postmortem(err, where)
    pm["in_recovery"] = bool(in_recovery)
    recorder.event("oom_postmortem", **pm)
    return pm
