"""Generic retry with jittered exponential backoff (port of
``amgx_tpu/utils/retry.py``).

One policy object + one driver for every transient-failure site: the
warm-start store's entry reads on a possibly networked filesystem and
the observability endpoint's port bind.
Centralising it means every retry is bounded, jittered (no synchronized
thundering herds from N lanes retrying in lockstep) and counted
(``amgx_retries_total{label}``).

The **retryable predicate** is the contract: only failures the caller
recognises as transient burn an attempt — anything else re-raises
immediately, exactly like an unguarded call.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional


@dataclasses.dataclass
class RetryPolicy:
    """Bounded, jittered exponential backoff.

    ``max_attempts`` counts the FIRST call too (1 = no retry); delay
    before attempt k (k >= 2) is
    ``min(base_delay_s * multiplier**(k-2), max_delay_s)`` scaled by a
    uniform ``[1-jitter, 1+jitter]`` factor."""

    max_attempts: int = 3
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1
    #: exception filter: True = transient, retry; False = re-raise now
    retryable: Callable[[BaseException], bool] = \
        lambda exc: isinstance(exc, OSError)

    def delay_s(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Backoff before attempt ``attempt`` (2-based; attempt 1 never
        waits)."""
        base = min(self.base_delay_s
                   * self.multiplier ** max(attempt - 2, 0),
                   self.max_delay_s)
        if self.jitter <= 0:
            return base
        r = (rng or random).uniform(1.0 - self.jitter, 1.0 + self.jitter)
        return base * r


def retry_call(fn: Callable, *, policy: Optional[RetryPolicy] = None,
               max_attempts: Optional[int] = None,
               base_delay_s: Optional[float] = None,
               retryable: Optional[Callable[[BaseException], bool]] = None,
               on_retry: Optional[Callable[[BaseException, int], None]]
               = None,
               label: str = "",
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None):
    """Call ``fn()`` under ``policy``; returns its result.

    A non-retryable failure (or the last attempt's) re-raises the
    original exception.  ``on_retry(exc, next_attempt)`` fires before
    each backoff sleep — the caller's logging hook.  Each retry counts
    into ``amgx_retries_total{label}`` when telemetry is enabled."""
    pol = policy or RetryPolicy()
    if max_attempts is not None:
        pol = dataclasses.replace(pol, max_attempts=int(max_attempts))
    if base_delay_s is not None:
        pol = dataclasses.replace(pol, base_delay_s=float(base_delay_s))
    if retryable is not None:
        pol = dataclasses.replace(pol, retryable=retryable)
    attempts = max(1, int(pol.max_attempts))
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — predicate-filtered
            if attempt >= attempts or not pol.retryable(exc):
                raise
            try:
                from ..telemetry import metrics, recorder
                if recorder.is_enabled():
                    metrics.counter_inc("amgx_retries_total",
                                        label=label or "unlabeled")
            except Exception:
                pass    # observability must never mask the retry
            if on_retry is not None:
                on_retry(exc, attempt + 1)
            sleep(pol.delay_s(attempt + 1, rng))
    raise AssertionError("unreachable")  # pragma: no cover
