"""The warm-start store: setup plans across processes (the port's
counterpart of ``amgx_tpu/serve/aot.py``).

The JAX package serialises its compiled XLA executables, so a fresh
process skips tracing and compiling.  The port has two kinds of warm
state, and a third that cannot persist:

* **built kernels** — ``native.py`` builds each ``csrc/<name>.cu`` into
  ``lib<name>-<digest>.so`` (the digest covers source and flags) under
  its build directory; the ``compile_cache_dir`` knob points that
  directory at a shared place, and a process that finds a library there
  builds nothing.  That is the XLA persistent cache's counterpart;
* **setup plans** — the device setup engine's symbolic Galerkin plans
  (``ops/spgemm.py`` ``GalerkinPlan``, the aggregation ``_AggPlan``; a
  classical level's refresh plan takes its schedules from the cached
  Galerkin plan) are index arrays keyed by operator structure.  This
  store keeps them in the ``aot_store_dir`` knob's directory, one
  ``<key>.npz`` per plan, so a fresh process loads instead of running
  the symbolic pass;
* **CUDA graphs** belong to the process that captured them and cannot
  be serialised: ``SolveService.warmup`` captures them anew.

Key anatomy (:func:`aot_key`): the plan's tag (``rap`` / ``rapd`` /
``agg``), the config hash (empty: a plan depends on structure alone),
the engine's own key parts (the structure fingerprints of the operands
and the dtype), a layout version and the backend (device type and, on
the card, its compute capability).  The torch and CUDA versions ride in
the entry and are checked at load, as the JAX store checks jax/jaxlib:
a mismatch is a ``compile_cache_fallback`` event (reason ``version``)
and a normal rebuild, never a crash or a silent miss.  A corrupt entry
(a truncated file, an unreadable archive, a field the layout lacks)
falls back the same way (reason ``corrupt:<error>``) and is deleted.

Entries are written atomically (``utils/fsio.py``: tmp + rename), so
concurrent processes warming the same directory never observe half an
entry.  ``amgx_aot_store_{bytes,entries}`` gauges track the footprint;
loads and misses count into
``amgx_compile_cache_{hits,misses}_total{layer="aot"}``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import telemetry
from ..utils import fsio

#: environment default for the store root (the config knob
#: ``aot_store_dir`` overrides; empty/0 disables) — child processes of a
#: warm-start probe inherit it
ENV_STORE = "AMGX_TPU_AOT_STORE"

_SUFFIX = ".npz"

#: plan-layout version mixed into the key: a change of the plans' fields
#: must miss on entries written under the old layout, not mis-decode them
_LAYOUT_VERSION = "plans1"


def backend_fingerprint() -> str:
    """The device a plan is built for: ``cpu``, or ``cuda:sm_<cc>``."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        return f"cuda:sm_{major}{minor}"
    return "cpu"


def runtime_versions() -> dict:
    """What an entry's plans were written by (checked at load)."""
    return {"torch": torch.__version__,
            "cuda": str(torch.version.cuda)}


def aot_key(tag: str, cfg_hash: str, parts) -> str:
    """Content key of one plan: tag + config hash + the engine's key
    parts + backend + layout version, digested."""
    raw = "|".join((tag, cfg_hash, repr(tuple(parts)),
                    backend_fingerprint(), _LAYOUT_VERSION))
    return f"{tag}-{hashlib.blake2b(raw.encode(), digest_size=16).hexdigest()}"


def _fallback(reason: str, key: str = ""):
    """Record one store fallback; the caller then builds normally."""
    if telemetry.is_enabled():
        telemetry.event("compile_cache_fallback", reason=reason,
                        key=key, layer="aot")
        telemetry.counter_inc("amgx_compile_cache_fallbacks_total",
                              reason=reason)


# ------------------------------------------------------ plan <-> arrays
def _plan_classes() -> dict:
    from ..amg.device_setup.engine import _AggPlan
    from ..ops.spgemm import GalerkinPlan, Schedule
    return {c.__name__: c for c in (GalerkinPlan, Schedule, _AggPlan)}


def encode_plan(plan) -> tuple:
    """``(arrays, spec)`` of a plan dataclass: every numpy array and
    tensor as an array (``f.<path>``), the rest as JSON in ``spec``;
    per-device upload caches (``_dev``) are left out."""
    arrays: dict = {}

    def enc(obj, path):
        if dataclasses.is_dataclass(obj):
            return {"k": "dc", "cls": type(obj).__name__,
                    "f": {f.name: enc(getattr(obj, f.name),
                                      f"{path}.{f.name}")
                          for f in dataclasses.fields(obj)
                          if f.name != "_dev"}}
        if isinstance(obj, torch.Tensor):
            arrays[path] = obj.detach().cpu().numpy()
            return {"k": "t"}
        if isinstance(obj, np.ndarray):
            arrays[path] = obj
            return {"k": "np"}
        if obj is None:
            return {"k": "none"}
        if isinstance(obj, tuple):
            return {"k": "tuple", "v": [int(v) for v in obj]}
        if isinstance(obj, (bool, int, np.integer)):
            return {"k": "int", "v": int(obj)}
        raise TypeError(f"plan field {path} of type {type(obj).__name__} "
                        "cannot be stored")

    return arrays, enc(plan, "f")


def decode_plan(arrays, spec, device):
    """The plan of :func:`encode_plan`, its tensors on ``device``."""
    classes = _plan_classes()
    dev = torch.device(device)

    def dec(s, path):
        k = s["k"]
        if k == "dc":
            cls = classes[s["cls"]]
            return cls(**{n: dec(v, f"{path}.{n}")
                          for n, v in s["f"].items()})
        if k == "t":
            return torch.from_numpy(np.array(arrays[path])).to(dev)
        if k == "np":
            return np.array(arrays[path])
        if k == "none":
            return None
        if k == "tuple":
            return tuple(int(v) for v in s["v"])
        if k == "int":
            return int(s["v"])
        raise ValueError(f"unknown field kind {k!r} at {path}")

    return dec(spec, "f")


class AOTStore:
    """One directory of stored plans plus an in-memory cache of those
    this process loaded or saved."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._mem: dict = {}
        #: stored size of each resident plan — what the memory ledger's
        #: ``amgx/aot/cache`` host-byte owner reports
        self._mem_nbytes: dict = {}
        self._ml_tok = None
        self.loads = 0
        self.saves = 0
        self.misses = 0
        self.fallbacks = 0
        #: (key, reason) of the newest fallback — first stop when
        #: debugging "why did this process build anyway"
        self.last_fallback = None
        #: incremental footprint (seeded by one scan at first use)
        self._disk = None

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + _SUFFIX)

    def _note_fallback(self, key: str, reason: str, event: str):
        with self._lock:
            self.fallbacks += 1
            self.last_fallback = (key, reason)
        _fallback(event, key)

    # ------------------------------------------------------------ lookup
    def load(self, key: str, device="cpu"):
        """The plan stored under ``key`` with its tensors on ``device``,
        or None (a miss, or a fallback: a version-mismatched or corrupt
        entry emits ``compile_cache_fallback`` and the caller builds)."""
        with self._lock:
            hit = self._mem.get(key)
        if hit is not None and hit[0] == torch.device(device):
            # an in-process repeat: not cache traffic
            return hit[1]
        path = self._path(key)
        if not os.path.exists(path):
            with self._lock:
                self.misses += 1
            self._count("miss")
            return None
        from ..utils import faultinject
        if faultinject.should_fire("aot_corrupt"):
            # chaos harness: the corruption fallback without destroying
            # the healthy entry on disk
            self._note_fallback(key, "corrupt:injected", "corrupt:injected")
            return None
        try:
            from ..utils.retry import retry_call

            def _read():
                with open(path, "rb") as f:
                    return f.read()

            # transient I/O on a possibly networked filesystem gets a
            # short bounded retry; a missing file is not transient
            raw = retry_call(
                _read, max_attempts=3, base_delay_s=0.02,
                retryable=lambda e: isinstance(e, OSError)
                and not isinstance(e, FileNotFoundError),
                label="aot_load")
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                meta = json.loads(str(z["__meta__"]))
                arrays = {k: z[k] for k in z.files if k != "__meta__"}
            spec = meta["spec"]
        except Exception as e:      # truncated / unreadable entry
            self._note_fallback(key, f"corrupt:{type(e).__name__}: {e}",
                                f"corrupt:{type(e).__name__}")
            self._unlink(path)
            return None
        if meta.get("versions") != runtime_versions():
            self._note_fallback(key, "version", "version")
            return None
        try:
            plan = decode_plan(arrays, spec, device)
        except Exception as e:      # a field the layout lacks
            self._note_fallback(key, f"corrupt:{type(e).__name__}: {e}",
                                f"corrupt:{type(e).__name__}")
            self._unlink(path)
            return None
        with self._lock:
            self._mem[key] = (torch.device(device), plan)
            self._mem_nbytes[key] = len(raw)
            self.loads += 1
        self._ml_account()
        self._count("hit")
        return plan

    def _unlink(self, path: str):
        """Delete a bad entry (never trip on it again)."""
        try:
            sz = os.stat(path).st_size
            os.unlink(path)
            with self._lock:
                if self._disk is not None:
                    self._disk["entries"] -= 1
                    self._disk["bytes"] -= sz
        except OSError:
            pass

    def remember(self, key: str, plan, device="cpu"):
        """In-memory registration of a plan that could not be stored."""
        with self._lock:
            self._mem[key] = (torch.device(device), plan)

    def save(self, key: str, plan, meta: Optional[dict] = None,
             device="cpu") -> bool:
        """Store ``plan`` under ``key`` (atomic tmp + rename); also keeps
        it in memory so the saving process reuses it."""
        arrays, spec = encode_plan(plan)
        m = dict(meta or (), created=time.time(), key=key,
                 backend=backend_fingerprint(), versions=runtime_versions(),
                 spec=spec)
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.array(json.dumps(m)), **arrays)
        data = buf.getvalue()
        self.disk_stats()       # seed the incremental accounting once
        path = self._path(key)
        try:
            old_bytes = os.stat(path).st_size
            existed = True
        except OSError:
            old_bytes, existed = 0, False
        try:
            fsio.atomic_write(path, data)
        except OSError:
            return False
        self._account_save(len(data), old_bytes, existed)
        with self._lock:
            self._mem[key] = (torch.device(device), plan)
            self._mem_nbytes[key] = len(data)
            self.saves += 1
        self._ml_account()
        self._gauges()
        return True

    def _ml_account(self):
        """Re-register the in-memory plans in the memory ledger
        (host-byte owner ``amgx/aot/cache``)."""
        ml = telemetry.memledger
        if not ml.is_enabled():
            return
        with self._lock:
            nb = sum(self._mem_nbytes.values())
            tok, self._ml_tok = self._ml_tok, None
        ml.release(tok)
        if nb > 0:
            t = ml.register_bytes(ml.owner_name("aot", "cache"), nb)
            with self._lock:
                self._ml_tok = t

    # ------------------------------------------------------------- stats
    def _count(self, result: str):
        if telemetry.is_enabled():
            telemetry.counter_inc(
                "amgx_compile_cache_hits_total" if result == "hit"
                else "amgx_compile_cache_misses_total", layer="aot")

    def disk_stats(self, refresh: bool = False) -> dict:
        """Entries/bytes of the store directory: one real scan, then
        maintained by save(); ``refresh=True`` rescans."""
        with self._lock:
            if self._disk is not None and not refresh:
                return dict(self._disk)
        entries = 0
        size = 0
        try:
            with os.scandir(self.root) as it:
                for e in it:
                    if e.name.endswith(_SUFFIX):
                        entries += 1
                        size += e.stat().st_size
        except OSError:
            pass
        with self._lock:
            self._disk = {"entries": entries, "bytes": size}
            return dict(self._disk)

    def _account_save(self, nbytes: int, old_bytes: int, existed: bool):
        with self._lock:
            if self._disk is None:
                return
            if not existed:
                self._disk["entries"] += 1
            self._disk["bytes"] += nbytes - old_bytes

    def _gauges(self):
        if telemetry.is_enabled():
            d = self.disk_stats()
            telemetry.gauge_set("amgx_aot_store_bytes", d["bytes"])
            telemetry.gauge_set("amgx_aot_store_entries", d["entries"])

    def stats(self) -> dict:
        with self._lock:
            st = {"root": self.root, "loads": int(self.loads),
                  "saves": int(self.saves), "misses": int(self.misses),
                  "fallbacks": int(self.fallbacks),
                  "resident": len(self._mem)}
        st.update(self.disk_stats())
        return st


# ------------------------------------------------------- process store
_STORE: Optional[AOTStore] = None
_STORE_LOCK = threading.Lock()
_env_checked = False


def configure(root: Optional[str]) -> Optional[AOTStore]:
    """Point the process-wide store at ``root`` (the ``aot_store_dir``
    knob).  Empty/None leaves the current store; a differing root
    replaces it."""
    global _STORE
    if not root:
        return _STORE
    with _STORE_LOCK:
        if _STORE is None or _STORE.root != os.path.abspath(root):
            _STORE = AOTStore(root)
        return _STORE


def get_store() -> Optional[AOTStore]:
    """The process-wide store, or None when nothing configured it (the
    ``AMGX_TPU_AOT_STORE`` environment variable seeds it)."""
    global _env_checked
    if _STORE is None and not _env_checked:
        _env_checked = True
        root = os.environ.get(ENV_STORE, "")
        if root not in ("", "0"):
            return configure(root)
    return _STORE


def reset_store():
    """Forget the process store (test isolation; files stay on disk)."""
    global _STORE, _env_checked
    with _STORE_LOCK:
        if _STORE is not None:
            telemetry.memledger.release(_STORE._ml_tok)
        _STORE = None
        _env_checked = False


def store_stats() -> Optional[dict]:
    """Stats of the live store, or None."""
    return _STORE.stats() if _STORE is not None else None


def stored_plan(tag: str, parts, build: Callable, device="cpu"):
    """The plan of ``(tag, parts)``: loaded from the store when it holds
    a compatible entry, else ``build()`` and stored (a ``None`` build —
    the engine's budget decline — is not stored).  Without a store this
    is ``build()``."""
    store = get_store()
    if store is None:
        return build()
    try:
        key = aot_key(tag, "", parts)
    except Exception as e:          # an exotic key part — never fatal
        _fallback(f"key:{type(e).__name__}")
        return build()
    plan = store.load(key, device)
    if plan is not None:
        return plan
    plan = build()
    if plan is None:
        return None
    try:
        if not store.save(key, plan, {"tag": tag}, device=device):
            # a full or read-only store filesystem: keep it in process
            _fallback("save-failed", key)
            store.remember(key, plan, device)
    except Exception as e:          # a plan field the layout lacks
        _fallback(f"serialize:{type(e).__name__}", key)
        store.remember(key, plan, device)
    return plan
