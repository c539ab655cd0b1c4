"""Pattern-keyed LRU setup cache with byte accounting (port of
``amgx_tpu/serve/cache.py``).

AMG setup is the expensive phase (coarsening, packing, graph captures);
the cache bounds how many prepared hierarchies stay resident.  Entries
are :class:`~amgx_tpu_torch.serve.session.SolverSession`s keyed by
:class:`~amgx_tpu_torch.serve.session.SessionKey`; the budget is DEVICE bytes
(``utils.memory.device_tree_bytes`` over each session's solver tree,
each storage once), not entry count — one 256³ hierarchy outweighs a thousand toy
sessions.  Least-recently-used sessions are dropped until the resident
total fits; an in-flight session object stays alive through its own
reference until its batch completes, eviction only forgets it.

Telemetry: ``amgx_serve_cache_{hits,misses,evictions}_total`` counters
and the ``amgx_serve_cache_bytes`` gauge.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional, Tuple

from .. import telemetry
from ..config import AMGConfig
from ..core.matrix import Matrix
from .session import SessionKey, SolverSession, session_key


#: process totals across every SetupCache instance — what the runstate
#: file (telemetry/runstate.py) folds so cache efficacy survives
#: restarts (per-instance counters die with their service).  Guarded by
#: a module lock: instances increment under their OWN locks, so two
#: services' read-modify-writes would otherwise race.
_TOTALS = {"hits": 0, "misses": 0, "evictions": 0}
_TOTALS_LOCK = threading.Lock()


def _totals_inc(key: str):
    with _TOTALS_LOCK:
        _TOTALS[key] += 1


def cache_totals() -> dict:
    with _TOTALS_LOCK:
        return dict(_TOTALS)


class SetupCache:
    def __init__(self, max_bytes: int = 1 << 30, placement=None,
                 lane=None):
        self.max_bytes = int(max_bytes)
        #: card sessions created by this cache pin to (multi-lane
        #: serving: each lane's cache slice builds lane-resident
        #: hierarchies); None = the matrix's own device
        self.placement = placement
        #: lane index this cache serves (memory-ledger owner label;
        #: standalone caches show as lane "x")
        self.lane = lane
        self._lock = threading.Lock()
        self._sessions: "collections.OrderedDict[SessionKey, SolverSession]" \
            = collections.OrderedDict()
        #: memory-ledger tokens per resident session (amgx/serve/…)
        self._ml_tokens: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -------------------------------------------------------------- lookup
    def get_or_create(self, cfg: AMGConfig, matrix: Matrix,
                      key: Optional[SessionKey] = None
                      ) -> Tuple[SolverSession, bool]:
        """The session for (cfg, matrix-pattern); creates one on miss.
        Returns (session, created).  Pass a precomputed ``key`` to skip
        re-hashing the config (the service does)."""
        if key is None:
            key = session_key(cfg, matrix)
        with self._lock:
            s = self._sessions.get(key)
            if s is not None:
                self._sessions.move_to_end(key)
                self.hits += 1
                _totals_inc("hits")
                telemetry.counter_inc("amgx_serve_cache_hits_total")
                return s, False
            self.misses += 1
            _totals_inc("misses")
            telemetry.counter_inc("amgx_serve_cache_misses_total")
            s = SolverSession(key, cfg, placement=self.placement)
            self._sessions[key] = s
            return s, True

    def get(self, key: SessionKey) -> Optional[SolverSession]:
        with self._lock:
            return self._sessions.get(key)

    # ---------------------------------------------------------- accounting
    def _ml_name(self, session: SolverSession) -> str:
        ml = telemetry.memledger
        lane = "x" if self.lane is None else self.lane
        return ml.owner_name(
            "serve", f"lane{lane}_{session.key.pattern[:12]}")

    def _ml_register(self, session: SolverSession):
        """Register the session's resident device tree in the memory
        ledger (aggregate owner ``amgx/serve/…`` — buffers a specific
        owner like ``amgx/hierarchy/…`` already claims stay charged
        there).  Never raises: the ledger must not break serving."""
        ml = telemetry.memledger
        if not ml.is_enabled():
            return None
        try:
            if session.solver.Ad is None:
                return None
            return ml.register(self._ml_name(session), session.solver)
        except Exception:
            return None

    def account(self, session: SolverSession) -> int:
        """Refresh ``session``'s byte price, then evict LRU sessions
        until the resident total fits the budget (the session just used
        is never evicted — it is the MRU by construction).  Returns the
        resident total after eviction."""
        size = session.device_bytes()
        tok = self._ml_register(session)
        ml = telemetry.memledger
        with self._lock:
            ml.release(self._ml_tokens.pop(session.key, None))
            if tok is not None:
                self._ml_tokens[session.key] = tok
            session.bytes = size
            if session.key in self._sessions:
                self._sessions.move_to_end(session.key)
            total = sum(s.bytes for s in self._sessions.values())
            while total > self.max_bytes and len(self._sessions) > 1:
                key, victim = next(iter(self._sessions.items()))
                if victim is session:
                    break
                del self._sessions[key]
                ml.release(self._ml_tokens.pop(key, None))
                total -= victim.bytes
                self.evictions += 1
                _totals_inc("evictions")
                telemetry.counter_inc("amgx_serve_cache_evictions_total")
            telemetry.gauge_set("amgx_serve_cache_bytes", total)
            return total

    # ------------------------------------------------------------- queries
    def resident_bytes(self) -> int:
        with self._lock:
            return sum(s.bytes for s in self._sessions.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def clear(self):
        with self._lock:
            self._sessions.clear()
            for tok in self._ml_tokens.values():
                telemetry.memledger.release(tok)
            self._ml_tokens.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "resident_bytes": sum(s.bytes
                                      for s in self._sessions.values()),
                "max_bytes": self.max_bytes,
                "by_session": [s.stats()
                               for s in self._sessions.values()],
            }
