"""Fault-injection harness: named failure points with triggers (port of
``amgx_tpu/utils/faultinject.py``).

Chaos engineering for the solve stack (the reference proves its failure
paths with signal handlers and error-code plumbing, ``amg_signal.cu``;
here every failure path is *provable on demand*): a process-global plan
of named **injection points**, armed by the ``fault_inject`` config
knob (or :func:`configure` directly), each with a **count** and/or
**probability** trigger.  Every firing is counted on its trigger
(:func:`stats`).

Injection points (wired at the existing seams):

===============  ==========================================================
``values_nan``   in the solve loop: NaN-poisons the iteration
                 state at iteration ``iter`` (default 1) — the
                 ``nan_poison`` taxonomy kind
``krylov_zero``  in the solve loop: zeroes the Krylov scalars
                 (CG's ``rho``) at iteration ``iter`` — the
                 ``krylov_breakdown`` kind.  Bites CG-family solvers
                 (their recursion carries rho); solvers that recompute
                 it each iteration (BiCGStab) are immune, and the
                 firing is only recorded when the breakdown was
                 actually provoked
``setup_error``  raises from ``Solver.setup`` (``setup_error`` kind)
``upload_error`` raises from the device pack upload (``device_error``)
``oom``          raises ``RC.NO_MEMORY`` from the pack phase
``worker_death`` a worker-pool task dies (``utils/thread_manager.py``)
``aot_corrupt``  the warm-start store treats the next entry as corrupt
``halo_exchange`` raises from the distributed vector shard/halo seam
===============  ==========================================================

Spec grammar (the ``fault_inject`` knob)::

    point[:key:val]*  [ point2[:key:val]* ...]
    # config-string-safe form (an AMGConfig entry allows exactly one
    # '=' and splits on commas, so keys pair with values by ':'
    # alternation and points separate on whitespace):
    #   "fault_inject=values_nan:iter:3:count:1 worker_death:count:2"
    # the programmatic API additionally accepts the '='/',' form:
    #   configure("values_nan:iter=3:count=1, upload_error:prob=0.5")

Triggers: ``count:N`` fires the next N times (decrementing; the
default is fire-always), ``prob:P`` fires with probability P per
opportunity (``seed`` makes it deterministic), and point-specific
params ride alongside (``iter`` for the solve-loop points).

The port's seams: ``setup_error`` in ``Solver.setup``, ``upload_error``
and ``oom`` at the pack phase, ``values_nan`` and ``krylov_zero`` in the
eager Krylov loop (``Solver._solve_loop``) at iteration ``iter``: the
poison hits the Krylov state, never a tensor an AMG's CUDA graph
captured.  ``halo_exchange`` raises from
:func:`~..distributed.matrix.shard_vector`, where a distributed solve
places its right-hand side and guess.  ``worker_death`` fires in
``ThreadManager``'s task guard (a serving lane's batch task dies before
its body runs), ``aot_corrupt`` in ``AOTStore.load`` (the next stored
plan reads as corrupt: a fallback event and a rebuild).

**Zero overhead when off**: the plan is a single module global that is
``None`` until armed — every seam's guard is one ``is None`` check.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Tuple

#: the known injection-point vocabulary (a typo'd spec must fail loud,
#: not silently never fire)
POINTS = ("values_nan", "krylov_zero", "setup_error", "upload_error",
          "oom", "worker_death", "aot_corrupt", "halo_exchange")

#: points whose injection mutates the iteration state of the solve loop
#: at a target iteration rather than raising at a seam
TRACED_POINTS = ("values_nan", "krylov_zero")

class InjectedFault(Exception):
    """Raised by an armed seam-style injection point."""


class WorkerDeathError(InjectedFault):
    """The ``worker_death`` point's payload: a worker-pool task dying
    mid-batch (the pool must survive; in-flight requests must fail
    cleanly, not hang)."""


class _Trigger:
    __slots__ = ("point", "count", "prob", "params", "fired", "_rng")

    def __init__(self, point: str, count: Optional[int] = None,
                 prob: Optional[float] = None,
                 seed: Optional[int] = None, **params):
        self.point = point
        self.count = count          # remaining firings; None = always
        self.prob = prob
        self.params = params        # point-specific (e.g. iter=3)
        self.fired = 0
        self._rng = random.Random(seed)

    def armed(self) -> bool:
        return self.count is None or self.count > 0


_PLAN: Optional[Dict[str, _Trigger]] = None
_lock = threading.Lock()


def parse_spec(spec: str) -> Dict[str, _Trigger]:
    """Parse the ``fault_inject`` grammar into triggers; raises
    ``ValueError`` on an unknown point or malformed entry.  Params
    accept ``key:val`` alternation (the config-string-safe form — an
    AMGConfig entry allows exactly one '=' and splits on commas) and
    ``key=val``; points separate on commas or whitespace."""
    import re
    plan: Dict[str, _Trigger] = {}
    for token in re.split(r"[,\s]+", str(spec)):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":")
        point = parts[0].strip()
        if point not in POINTS:
            raise ValueError(
                f"unknown fault-injection point {point!r}; known: "
                f"{POINTS}")
        kw: dict = {}
        rest = parts[1:]
        i = 0
        while i < len(rest):
            p = rest[i].strip()
            if "=" in p:
                k, v = p.split("=", 1)
                i += 1
            elif i + 1 < len(rest):
                k, v = p, rest[i + 1].strip()
                i += 2
            else:
                raise ValueError(
                    f"malformed fault-injection param {p!r} in "
                    f"{token!r} (want key:value or key=value)")
            k = k.strip()
            if k == "prob":
                kw[k] = float(v)
            else:
                kw[k] = int(float(v))
        if point in TRACED_POINTS and "prob" in kw:
            # the JAX package compiles these points into its loop, where
            # a probability coin cannot gate them; the port keeps its
            # grammar
            raise ValueError(
                f"prob triggers are not supported for solve-loop point "
                f"{point!r} (the injection is compiled into the solve "
                "loop); use count")
        plan[point] = _Trigger(point, **kw)
    return plan


def configure(spec: "str | dict | None"):
    """Arm the process-global plan (replacing any previous one).  An
    empty/None spec disarms — same as :func:`reset`."""
    global _PLAN, _KNOB_SPEC
    _KNOB_SPEC = None           # a programmatic (re)arm owns the plan
    if not spec:
        _PLAN = None
        return
    if isinstance(spec, str):
        _PLAN = parse_spec(spec)
        return
    plan = dict(spec)
    bad = [k for k in plan if k not in POINTS]
    if bad:
        parse_spec(" ".join(bad))       # raises for the first one
    _PLAN = {k: (v if isinstance(v, _Trigger) else _Trigger(k, **v))
             for k, v in plan.items()}


#: the spec string the ``fault_inject`` KNOB last armed — knob arming
#: is idempotent per spec (see :func:`configure_knob`)
_KNOB_SPEC: Optional[str] = None


def configure_knob(spec: str):
    """The ``fault_inject`` config knob's arming path: idempotent per
    spec string.  Solvers are constructed freely from the same config
    (nested solvers read it; the recovery ladder's conservative rung
    builds a twin) — re-arming on
    each construction would reset consumed counts and turn
    'fire exactly once' into fire-once-per-solver.  A CHANGED spec
    re-arms; :func:`reset`/:func:`configure` clear the memo."""
    global _KNOB_SPEC
    if not spec or spec == _KNOB_SPEC:
        return
    configure(spec)
    _KNOB_SPEC = spec


def reset():
    """Disarm every injection point (and the knob-spec memo)."""
    global _PLAN, _KNOB_SPEC
    _PLAN = None
    _KNOB_SPEC = None


def active() -> bool:
    return _PLAN is not None


def armed(point: str) -> bool:
    """Is ``point`` in the plan with firings remaining?  (Advisory —
    :func:`should_fire` makes the atomic decision.)"""
    plan = _PLAN
    if plan is None:
        return False
    t = plan.get(point)
    return t is not None and t.armed()


def should_fire(point: str, consume: bool = True, **ctx) -> bool:
    """Atomically evaluate ``point``'s trigger; a firing is counted and
    (for count triggers) consumed."""
    plan = _PLAN
    if plan is None:
        return False
    t = plan.get(point)
    if t is None:
        return False
    with _lock:
        if not t.armed():
            return False
        if t.prob is not None and t._rng.random() >= t.prob:
            return False
        if consume and t.count is not None:
            t.count -= 1
        t.fired += 1
    return True


def fired(point: str, **ctx) -> bool:
    """Consume + count one firing whose *decision* was made elsewhere
    (the solve-loop points: the loop applies the injection, the solve
    records it once it provoked a breakdown)."""
    return should_fire(point, consume=True, **ctx)


def maybe_raise(point: str, exc: Optional[BaseException] = None):
    """Raise ``exc`` (default :class:`InjectedFault`) when ``point``
    fires; the fast path is one global ``is None`` check."""
    if _PLAN is None:
        return
    if should_fire(point):
        raise exc if exc is not None \
            else InjectedFault(f"injected fault at point {point!r}")


def param(point: str, key: str, default=None):
    plan = _PLAN
    if plan is None or point not in plan:
        return default
    return plan[point].params.get(key, default)


def trace_mode() -> Optional[Tuple[str, int]]:
    """The armed solve-loop injection as ``(mode, iteration)``, or None
    (consulted once per solve)."""
    plan = _PLAN
    if plan is None:
        return None
    for mode in TRACED_POINTS:
        t = plan.get(mode)
        if t is not None and t.armed():
            return mode, int(t.params.get("iter", 1))
    return None


def stats() -> dict:
    """{point: {"fired": n, "remaining": count-or-None}} of the current
    plan ({} when disarmed)."""
    plan = _PLAN
    if plan is None:
        return {}
    return {p: {"fired": t.fired, "remaining": t.count}
            for p, t in plan.items()}
