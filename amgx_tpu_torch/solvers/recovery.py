"""The automatic recovery ladder: bounded, audited escalation (port of
``amgx_tpu/solvers/recovery.py``).

When a monitored solve terminates in failure (breakdown, divergence,
stagnation — see :class:`~amgx_tpu.errors.FailureKind`) and the
``recovery_policy`` knob is ``AUTO``, the solve walks a **bounded
ladder** of increasingly expensive repairs instead of handing the
caller a dead result:

0. **krylov_classic** — a communication-avoiding (CA/PIPELINED)
   recurrence that broke down falls back to the CLASSIC reduction
   layout first: same operator and hierarchy, only the loop changes;
1. **restart** — re-run the Krylov loop from the last finite iterate
   (a fresh Krylov space sheds the poisoned/collapsed basis; it
   replays the AMG's CUDA graphs, capturing none);
2. **promote** — one precision rung up (the promotion plan,
   triggered by *breakdown* rather than only tolerance floors: the
   narrow pack re-runs under the defect-correction outer loop bounded
   by the uploaded host matrix);
3. **conservative** — rebuild with a conservative smoother config
   (a Chebyshev smoother with bad spectrum bounds amplifies — swap to
   Jacobi and set up a twin solver, which captures its own AMG graph;
   the user's solver is untouched);
4. **resetup** — full setup from the original operator (the hierarchy
   itself may be poisoned); the next application captures a new graph.

The outcome is audited in ``SolveResult.recovery`` (the JAX package's
dict) and each attempt in the solver's ``recovery_log`` (the fields of
the JAX package's ``recovery_attempt`` event; the port's telemetry is a
later slice).  The ladder is *bounded* by ``recovery_max_attempts``
and never recurses (attempt solves run with ``_in_recovery`` set).

Off (``recovery_policy=NONE``, the default) this module is never
imported by the solve path.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import telemetry
from ..errors import FailureInfo, FailureKind, SolveStatus

#: ladder rungs, cheapest first — the vocabulary of the audit's
#: ``action``.  krylov_classic comes before restart: a breakdown in a
#: communication-avoiding recurrence may be an artifact of the
#: reordered scalar recurrences rather than the operator — re-running
#: with the CLASSIC reduction layout reuses every setup product and is
#: cheaper than burning a restart rung on a possibly-poisoned basis
ACTIONS = ("krylov_classic", "restart", "promote", "conservative",
           "resetup")

#: failure kinds the krylov_classic rung can plausibly repair — the
#: recurrence-sensitive breakdowns; a stagnated or diverged solve is
#: not a reduction-layout problem
_KRYLOV_KINDS = (FailureKind.KRYLOV_BREAKDOWN,
                 FailureKind.INDEFINITE_OPERATOR,
                 FailureKind.NAN_POISON)

#: smoother knobs swapped by the conservative rung (any non-Jacobi
#: smoother — Chebyshev with a bad spectrum estimate, an aggressive
#: GS/DILU — falls back to the unconditionally-safe damped Jacobi)
_SMOOTHER_KNOBS = ("smoother", "fine_smoother", "coarse_smoother")
_SAFE_SMOOTHERS = ("BLOCK_JACOBI", "JACOBI_L1", "CF_JACOBI")


class _Skip(Exception):
    """A rung that cannot apply to this solver/config (no wider rung to
    promote to, already-conservative smoother) — audited as outcome
    ``skipped``, burns no attempt budget.  ``audit=False`` marks a rung
    that is *structurally absent* for this solver (a CLASSIC-mode solve
    has no CA fallback rung): it skips silently, so the rung 0
    krylov_classic check does not prepend a noise event to every
    recovery of a default-config solver."""

    def __init__(self, msg: str, audit: bool = True):
        super().__init__(msg)
        self.audit = audit


def _failure_kind(result) -> FailureKind:
    if result.failure is not None:
        return result.failure.kind
    nrm = result.residual_norm
    if nrm is not None and not np.all(np.isfinite(np.asarray(nrm))):
        return FailureKind.DIVERGENCE
    return FailureKind.STAGNATION


def _finite_start(result, x0):
    """The restart iterate: the failed solve's x when every entry is
    finite (a stagnated/indefinite exit keeps its progress), else the
    caller's original guess."""
    x = result.x
    if isinstance(x, torch.Tensor):
        if x.numel() and bool(torch.isfinite(x).all()):
            return x, False
        return x0, True
    x = np.asarray(x)
    if x.size and np.all(np.isfinite(x)):
        return x, False
    return x0, True


def _solve_again(solver, b, x0, zero_initial_guess):
    return solver.solve(b, x0=x0, zero_initial_guess=zero_initial_guess)


def _act_krylov_classic(solver, b, x0, zero_initial_guess, last):
    """CA/PIPELINED → CLASSIC fallback: re-run with the two-reduction
    classic recurrence (same operator, same hierarchy).  Sticky on success: a recurrence that broke
    once is not re-trusted; reverted on failure so an unrelated
    breakdown does not permanently slow the solver down."""
    mode = solver._comm_mode() if hasattr(solver, "_comm_mode") \
        else "CLASSIC"
    if mode == "CLASSIC":
        raise _Skip("solver already runs the CLASSIC reduction layout",
                    audit=False)
    if _failure_kind(last) not in _KRYLOV_KINDS:
        raise _Skip("failure kind is not a recurrence breakdown")
    solver._force_krylov_classic = True
    try:
        res = _solve_again(solver, b, x0, zero_initial_guess)
    except Exception:
        solver._force_krylov_classic = False
        raise
    if res is None or res.status != SolveStatus.SUCCESS:
        solver._force_krylov_classic = False
    return res


def _act_restart(solver, b, x0, zero_initial_guess, last):
    x_start, fell_back = _finite_start(last, x0)
    if fell_back:
        return _solve_again(solver, b, x0, zero_initial_guess)
    # under a RELATIVE_* criterion the restarted solve's baseline is
    # the (already reduced) residual at the restart iterate — rescale
    # the tolerance so the restart chases the ORIGINAL target instead
    # of eight more orders from wherever the first leg stopped.
    tol = solver.tolerance
    scaled = None
    if solver.convergence.startswith("RELATIVE") \
            and last.residual_history is not None \
            and len(last.residual_history) \
            and last.residual_norm is not None:
        ini = float(np.max(np.atleast_1d(last.residual_history[0])))
        cur = float(np.max(np.atleast_1d(last.residual_norm)))
        if np.isfinite(ini) and np.isfinite(cur) and 0 < cur and 0 < ini:
            scaled = min(tol * ini / cur, 0.5)
    try:
        if scaled is not None:
            solver.tolerance = scaled
        return solver.solve(b, x0=x_start, zero_initial_guess=False)
    finally:
        solver.tolerance = tol


def _act_promote(solver, b, x0, zero_initial_guess, last):
    base_refine, _w, _s = solver._promotion_plan()
    if base_refine:
        # the failed solve ALREADY ran under the promotion rung (deep
        # tolerance on a narrow pack) — forcing it again would re-run
        # the identical refined solve and burn an attempt for nothing
        raise _Skip("solve already ran at the promoted rung")
    solver._force_promotion = True
    try:
        refine, _wide, _structural = solver._promotion_plan()
        if not refine:
            raise _Skip("no wider promotion rung available "
                        "(host matrix not wider than the device pack, "
                        "or structurally unrefinable)")
        return _solve_again(solver, b, x0, zero_initial_guess)
    finally:
        solver._force_promotion = False


def _setup_source(solver):
    """The operator the rebuild rungs re-setup from: the pre-scaling
    stash when present; the solver's working matrix only when it is
    the caller's original (re-running setup on a scaled/reordered COPY
    would scale twice — skip instead)."""
    A = getattr(solver, "_setup_input", None)
    if A is not None:
        return A
    if solver.scaler is not None \
            or getattr(solver, "_reorder", None) is not None:
        raise _Skip("original operator unavailable (solver holds a "
                    "scaled/reordered copy only)")
    return solver.A if solver.A is not None else solver.Ad


def _act_conservative(solver, b, x0, zero_initial_guess, last):
    cfg = solver.cfg.clone()
    swapped = []
    for (scope, name), (value, new_scope) in list(cfg._params.items()):
        if name in _SMOOTHER_KNOBS and value not in _SAFE_SMOOTHERS:
            # keep the entry's sub-scope binding: the Jacobi twin reads
            # its params from the same scope the old smoother did (and
            # ignores the Chebyshev-specific ones)
            cfg._params[(scope, name)] = ("BLOCK_JACOBI", new_scope)
            swapped.append(f"{scope}:{name}={value}")
    if not swapped:
        raise _Skip("smoother stack is already conservative")
    from .base import SolverFactory
    A = _setup_source(solver)
    twin = SolverFactory.create(solver.config_name, cfg, solver.scope)
    twin._toplevel = getattr(solver, "_toplevel", False)
    twin._in_recovery = True
    twin.setup(A)
    return twin.solve(b, x0=x0, zero_initial_guess=zero_initial_guess)


def _act_resetup(solver, b, x0, zero_initial_guess, last):
    solver.setup(_setup_source(solver))
    return _solve_again(solver, b, x0, zero_initial_guess)


_ACTION_FN = {"krylov_classic": _act_krylov_classic,
              "restart": _act_restart, "promote": _act_promote,
              "conservative": _act_conservative,
              "resetup": _act_resetup}


def _audit(log: list, kind: FailureKind, action: str, attempt: int,
           outcome: str, wall_s: float, detail: str = "", solver=None,
           oom: bool = False):
    """One rung's record (the ``recovery_attempt`` event's fields), also
    counted (``amgx_recovery_total``) and, with telemetry on, emitted as
    the event and flushed to the solver's ``telemetry_path``."""
    entry = {"kind": kind.value, "action": action, "attempt": int(attempt),
             "outcome": outcome, "wall_s": wall_s}
    if detail:
        entry["detail"] = detail[:200]
    log.append(entry)
    telemetry.counter_inc("amgx_recovery_total", kind=kind.value,
                          action=action, outcome=outcome)
    if telemetry.is_enabled():
        extra = {"detail": detail[:200]} if detail else {}
        if oom:
            # this rung died on a device OOM: its oom_postmortem event
            # (in_recovery=true) holds the resident ledger
            extra["oom"] = True
        telemetry.event("recovery_attempt", kind=kind.value,
                        action=action, attempt=int(attempt),
                        outcome=outcome,
                        solver=getattr(solver, "config_name", "?"),
                        wall_s=round(wall_s, 6), **extra)
        if getattr(solver, "telemetry_path", ""):
            telemetry.flush_jsonl(solver.telemetry_path)


def maybe_recover(solver, b, x0, zero_initial_guess: bool, result):
    """Walk the ladder for a failed ``result``; returns the recovered
    result (``.recovery`` records the audit) or the best failing one
    (``.recovery["outcome"] == "exhausted"``).  Never raises: a rung
    that errors is audited and the ladder escalates past it."""
    kind = _failure_kind(result)
    budget = max(0, int(solver.recovery_max_attempts))
    if budget == 0:
        return result
    solver._in_recovery = True
    attempt = 0
    last = result
    last_action = None
    log: list = []
    solver.recovery_log = log
    try:
        for action in ACTIONS:
            if attempt >= budget:
                break
            t0 = time.perf_counter()
            try:
                cand = _ACTION_FN[action](solver, b, x0,
                                          zero_initial_guess, last)
            except _Skip as sk:
                # an inapplicable rung burns no budget — audit and
                # escalate (unless the rung is structurally absent
                # for this solver, which skips silently)
                if getattr(sk, "audit", True):
                    _audit(log, kind, action, attempt, "skipped",
                           time.perf_counter() - t0, detail=str(sk),
                           solver=solver)
                continue
            except Exception as e:  # noqa: BLE001 — the ladder must
                # never raise past the solve that invoked it; the
                # failure is audited and the next rung tries
                attempt += 1
                _audit(log, kind, action, attempt, "error",
                       time.perf_counter() - t0,
                       detail=f"{type(e).__name__}: {e}", solver=solver,
                       oom=telemetry.memledger.is_oom_error(e))
                last_action = action
                continue
            attempt += 1
            last_action = action
            ok = cand is not None and cand.status == SolveStatus.SUCCESS
            _audit(log, kind, action, attempt,
                   "recovered" if ok else "failed",
                   time.perf_counter() - t0, solver=solver)
            if cand is not None:
                last = cand
            if ok:
                cand.recovery = {"kind": kind.value, "action": action,
                                 "attempts": attempt,
                                 "outcome": "recovered"}
                return cand
        # ladder exhausted: hand back the best failing result with the
        # audit attached (and one terminal counter sample)
        telemetry.counter_inc("amgx_recovery_total", kind=kind.value,
                              action="ladder", outcome="exhausted")
        last.recovery = {"kind": kind.value, "action": last_action,
                         "attempts": attempt, "outcome": "exhausted"}
        if last.failure is None:
            last.failure = result.failure or FailureInfo(kind=kind)
        return last
    finally:
        solver._in_recovery = False
