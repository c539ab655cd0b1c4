"""Structured solver telemetry (port of ``amgx_tpu/telemetry/``).

One structured layer over what the reference scattered across the CPU
profiler tree (``amgx_timer.h``), per-level ``levelProfile`` timers and
the grid-stats table:

* **spans/events** (:mod:`.recorder`): ``span(name, **attrs)`` phase
  markers (which also aggregate into the legacy profiler tree,
  ``utils/profiler.py``, with optional ``torch.profiler.record_function``
  / NVTX forwarding) and ``event(name, **attrs)`` point records,
  appended to a bounded ring buffer;
* **metrics** (:mod:`.metrics`): counters/gauges/histograms under the
  JAX package's stable, versioned names (``METRICS``);
* **exporters** (:mod:`.export`): JSONL traces (``dump_jsonl`` /
  incremental ``flush_jsonl``), a Prometheus text snapshot, the schema
  validator, the multi-process session merger;
* **analysis**: :mod:`.costmodel` (bytes/operations per apply of the
  port's packs), :mod:`.tracefile` (Chrome-trace export of a JSONL
  trace), :mod:`.doctor` (``python -m amgx_tpu_torch.telemetry.doctor
  trace.jsonl``, ``--diff`` for two traces);
* **convergence forensics** (:mod:`.forensics`): per-level cycle
  anatomy (residual norms at the four cut points of every cycle, held
  on the card in a buffer the graph writes and read once per solve),
  hierarchy quality probes, asymptotic-rate estimates — the
  ``forensics`` knob;
* **device-time attribution**: :mod:`.scopes` (the ``amgx/<area>/<name>``
  ranges every instrumented launch site opens), :mod:`.proftrace`
  (``torch.profiler`` chrome-trace parsing and the kernel → range
  join, through the capture-time scope map inside CUDA graph replays),
  :mod:`.deviceprof` (measured device seconds per level, pack, smoother
  and Krylov stage, emitted as ``device_anatomy``);
* **device-memory ledger** (:mod:`.memledger`): ownership attribution
  of registered tensors against ``torch.cuda.memory_stats()``, honesty
  invariant ``accounted + unaccounted ≡ bytes_in_use``, OOM
  post-mortems — the ``memledger`` knob;
* **setup profile** (:mod:`.setup_profile`): per-level × per-phase setup
  attribution with kernel-build / graph-capture / transfer splits — the
  ``setup_profile`` knob.

* **live serving observability**: :mod:`.slo` (time-windowed latency
  percentiles, SLO attainment and burn rate, overload detection) and
  :mod:`.httpd` (the in-process ``/metrics`` ``/healthz`` ``/statusz``
  ``/debug/*`` endpoint of the ``metrics_port`` knob);
* **mesh flight recorder**: :mod:`.meshtrace` (clock-aligned
  cross-session rendezvous join; a one-card trace is one rank) and
  :mod:`.overlap` (measured interior/halo overlap from a
  ``torch.profiler`` trace).

Everything is **off by default** and costs one attribute check per
instrument; enable globally with :func:`enable`, per config with the
``telemetry=1`` knob (plus ``telemetry_path`` / ``telemetry_ring_size``),
or scoped with :func:`capture` in tests.
"""
from __future__ import annotations

from . import (costmodel, deviceprof, export, forensics, memledger,
               meshtrace, metrics, overlap, proftrace, recorder,
               runstate, scopes, setup_profile, slo, tracefile)
from .export import (aggregate_sessions, dump_jsonl, flush_jsonl,
                     prometheus_text, read_sessions, validate_jsonl,
                     validate_record)
from .metrics import (METRICS, counter_inc, gauge_set, hist_observe,
                      registry)
from .recorder import (SCHEMA_VERSION, Capture, capture, clear, disable,
                       dropped_count, enable, event, is_enabled, records,
                       span)
from .tracefile import (chrome_trace, validate_chrome_trace,
                        write_chrome_trace)

__all__ = [
    "SCHEMA_VERSION", "METRICS", "Capture",
    "enable", "disable", "is_enabled", "capture", "clear", "records",
    "span", "event", "dropped_count",
    "counter_inc", "gauge_set", "hist_observe", "registry",
    "dump_jsonl", "flush_jsonl", "prometheus_text",
    "validate_record", "validate_jsonl",
    "read_sessions", "aggregate_sessions",
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "costmodel", "forensics", "setup_profile", "runstate",
    "slo", "httpd",
    "proftrace", "scopes", "deviceprof", "overlap", "memledger",
    "meshtrace",
    "reset",
]


def __getattr__(name):
    # httpd is bound lazily: it pulls the stdlib http.server chain,
    # which a process without an endpoint never needs
    if name == "httpd":
        # importlib, not `from . import`: the fromlist resolution calls
        # getattr on this package and would re-enter this hook forever
        import importlib
        mod = importlib.import_module(".httpd", __name__)
        globals()["httpd"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset():
    """Drop buffered records, zero the metrics registry and the
    ring-overflow counter (test/bench isolation helper; recording stays
    in whatever on/off state it was)."""
    recorder.clear()
    recorder.reset_dropped()
    metrics.registry().reset()
    setup_profile.reset()
    memledger.reset()
