"""In-process observability endpoint (stdlib, no dependencies; port of
``amgx_tpu/telemetry/httpd.py``).

A :class:`ThreadingHTTPServer` that exposes the live process the way a
production solve service must be inspectable — **without restarting
it**.  Off by default; the serving layer starts one when the
``metrics_port`` knob is set (``SolveService.start_endpoint``), and
anything else can run one via :func:`serve_httpd`.  Binds loopback
only: this is an operator surface, not a public API.

Routes:

* ``GET /metrics`` — the Prometheus text snapshot
  (:func:`amgx_tpu_torch.telemetry.export.prometheus_text`), scrapeable by
  any textfile/HTTP collector;
* ``GET /healthz`` — liveness JSON: aggregate queue depth/capacity,
  in-flight batches, accepting flag, the SLO overload trip wire, and —
  for a multi-lane service — a ``lanes`` array with every executor
  lane's own queue/SLO/saturation state plus ``saturated_lanes``.
  Returns **503 when overloaded (which for a multi-lane service means
  EVERY lane is saturated — with a healthy lane left the router can
  still steal/replicate, so the instance keeps working capacity),
  drained (not accepting), or the health computation itself failed**
  (the load-balancer eviction contract) and 200 otherwise; a partial
  saturation stays 200 with the saturated subset named in the body so
  an LB — or ``SolveService.drain_lane`` — can drain one card;
* ``GET /statusz`` — the solve doctor's machine-readable diagnosis of
  the current telemetry ring (``doctor.diagnose`` over a snapshot) —
  "what would the doctor say right now";
* ``GET /debug/trace?seconds=N`` — drain the event ring to JSONL
  (records of the last N seconds; everything without ``seconds``),
  exactly the file every offline tool (doctor, Perfetto exporter)
  already reads;
* ``GET /debug/profile?seconds=N`` — a ``torch.profiler`` capture of
  the live process for N seconds (clamped to [0.05, 60]), written with
  ``export_chrome_trace`` into a fresh directory; responds with the
  directory, the trace file and the parsed device anatomy (the
  ``amgx/...`` scopes joined to the kernels, CUDA graph replays
  included).  The profiler starts and stops between two pieces of the
  cards' work (a serving session's setup or solves: at most one
  micro-batch's wait).  One capture at a time — concurrent requests get
  409.
* ``GET /debug/memory`` — the device-memory ledger's live view
  (:mod:`amgx_tpu_torch.telemetry.memledger`): a fresh ownership snapshot,
  top owners and the recent headroom history.
* ``GET /debug/mesh`` — the mesh flight recorder's view of the
  current telemetry ring (:mod:`amgx_tpu_torch.telemetry.meshtrace`):
  clock-aligned rendezvous join, per-rank wait/straggler table and
  desync detection; an honest ``measured=false`` stub on a
  single-rank process.

Handlers never touch solver internals beyond the read-only stats
surface, so a scrape cannot perturb a solve beyond the GIL.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import recorder
from .export import (_json_line, _meta_record, _sanitize,
                     prometheus_text)

#: /debug/profile capture bounds (seconds) — an unbounded capture
#: would let one request hold the profiler lock forever
PROFILE_MIN_S = 0.05
PROFILE_MAX_S = 60.0

#: one profiler capture at a time, process-wide (the profiler is a
#: process singleton)
_profile_lock = threading.Lock()


class _Handler(BaseHTTPRequestHandler):
    # ``self.server.owner`` is the ObservabilityHTTPD that started the
    # ThreadingHTTPServer — the handle /healthz reads state through

    # silence the default per-request stderr line — a scraped service
    # would log every 15 s forever
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._reply(code, json.dumps(_sanitize(obj), indent=2,
                                     default=str,
                                     allow_nan=False).encode(),
                    "application/json")

    def do_GET(self):  # noqa: N802 — stdlib contract
        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            route = {
                "/metrics": self._metrics,
                "/healthz": self._healthz,
                "/statusz": self._statusz,
                "/debug/trace": self._debug_trace,
                "/debug/profile": self._debug_profile,
                "/debug/deviceprof": self._debug_deviceprof,
                "/debug/memory": self._debug_memory,
                "/debug/mesh": self._debug_mesh,
            }.get(url.path)
            if route is None:
                self._json(404, {"error": f"no route {url.path}",
                                 "routes": ["/metrics", "/healthz",
                                            "/statusz", "/debug/trace",
                                            "/debug/profile",
                                            "/debug/deviceprof",
                                            "/debug/memory",
                                            "/debug/mesh"]})
                return
            route(q)
        except BrokenPipeError:
            pass                     # client went away mid-response
        except Exception as e:       # noqa: BLE001 — endpoint must live
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except Exception:
                pass

    # -------------------------------------------------------------- routes
    def _metrics(self, q):
        # refresh the amgx_slo_* gauges before rendering: a scrape-only
        # consumer (no stats()/healthz poller) would otherwise read
        # whatever the last poll happened to leave behind
        self.server.owner.health()
        self._reply(200, prometheus_text().encode(),
                    "text/plain; version=0.0.4")

    def _healthz(self, q):
        h = self.server.owner.health()
        # the LB eviction contract: 503 for overload, but ALSO for a
        # drained service (accepting=false rejects 100% of submissions
        # long before the shed rate trips the wire) and for a health
        # computation that itself failed
        unhealthy = (h.get("overloaded") or not h.get("ok", True)
                     or not h.get("accepting", True))
        self._reply(503 if unhealthy else 200,
                    json.dumps(_sanitize(h), allow_nan=False).encode(),
                    "application/json")

    def _statusz(self, q):
        # the doctor is a trace-file consumer — hand it a snapshot of
        # the ring through a temp file so /statusz and the offline
        # report can never drift apart
        from . import doctor
        from .export import dump_jsonl
        fd, path = tempfile.mkstemp(suffix=".jsonl",
                                    prefix="amgx_statusz_")
        os.close(fd)
        try:
            dump_jsonl(path)
            self._json(200, doctor.diagnose([path]))
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _debug_trace(self, q):
        recs = recorder.records()
        seconds = _qfloat(q, "seconds")
        if seconds is not None:
            cut = time.perf_counter() - max(seconds, 0.0)
            recs = [r for r in recs if r.get("t", 0.0) >= cut]
        lines = [_json_line(_meta_record())]
        lines.extend(_json_line(r) for r in recs)
        self._reply(200, ("\n".join(lines) + "\n").encode(),
                    "application/x-ndjson")

    def _debug_profile(self, q):
        out = self._capture_profile(q)
        self._json(out.pop("_code", 200), out)

    def _debug_deviceprof(self, q):
        # the device anatomy riding the same one-shot capture: profile,
        # correlate, return JUST the anatomy (plus the trace dir so a
        # deeper offline look stays possible)
        out = self._capture_profile(q)
        code = out.pop("_code", 200)
        if code != 200:
            self._json(code, out)
            return
        self._json(200, {"dir": out["dir"], "seconds": out["seconds"],
                         "device_anatomy": out.get("device_anatomy")})

    def _debug_memory(self, q):
        # the memory ledger's live view: a fresh snapshot (not the last
        # sampled one) plus the recent headroom history — works with
        # the ledger knob off too, just with no registered owners
        from . import memledger
        snap = memledger.snapshot()
        self._json(200, {
            "enabled": memledger.is_enabled(),
            "snapshot": snap,
            "top_owners": memledger.top_owners(snap),
            "headroom_history": memledger.headroom_history(),
        })

    def _debug_mesh(self, q):
        # the mesh flight recorder is a trace-file consumer like the
        # doctor — hand it a ring snapshot through a temp file so the
        # live view and the offline one can never drift apart.  A
        # single-process ring is one rank: the reply is then the
        # honest measured=false stub, not an error
        from . import meshtrace
        from .export import dump_jsonl
        fd, path = tempfile.mkstemp(suffix=".jsonl",
                                    prefix="amgx_mesh_")
        os.close(fd)
        try:
            dump_jsonl(path)
            self._json(200, meshtrace.analyze(path))
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _capture_profile(self, q) -> dict:
        """One-shot profiler capture + parsed summaries.  Returns the
        reply dict (``_code`` carries a non-200 status)."""
        seconds = _qfloat(q, "seconds")
        if seconds is None:          # absent/unparsable — NOT ?seconds=0,
            seconds = 1.0            # which clamps to PROFILE_MIN_S below
        seconds = min(max(seconds, PROFILE_MIN_S), PROFILE_MAX_S)
        if not _profile_lock.acquire(blocking=False):
            return {"_code": 409,
                    "error": "a profiler capture is already "
                             "running; retry when it ends"}
        try:
            import torch
            out_dir = tempfile.mkdtemp(prefix="amgx_profile_")
            trace_path = os.path.join(out_dir, "trace.json")
            t0 = time.perf_counter()
            acts = [torch.profiler.ProfilerActivity.CPU]
            cuda = torch.cuda.is_available() and \
                torch.cuda.is_initialized()
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            # the profiler starts and stops between two pieces of the
            # cards' work (_card_locks): stopping it while another
            # thread launches a CUDA graph deadlocks (the launch holds
            # the GIL and waits in the profiler's launch callback for
            # the lock the stopping profiler holds while it waits for
            # the GIL)
            with _card_locks():
                prof.start()
            try:
                # the capture window: device work submitted by OTHER
                # threads during this sleep lands in the trace — that
                # is the whole point of profiling the live process
                time.sleep(seconds)
            finally:
                with _card_locks():
                    prof.stop()
            prof.export_chrome_trace(trace_path)
            out = {"dir": out_dir, "trace": trace_path,
                   "seconds": round(seconds, 3),
                   "wall_s": round(time.perf_counter() - t0, 3)}
            # inline parsed views of the capture (best-effort: a trace
            # with no device ops yields the measured=False stub, and a
            # parse failure must never take the endpoint down)
            try:
                from . import deviceprof, overlap
                trace = overlap.find_trace_file(out_dir)
                out["device_anatomy"] = deviceprof.capture_anatomy(
                    trace if trace is not None else {"traceEvents": []})
                out["overlap"] = overlap.measure(
                    trace if trace is not None else {"traceEvents": []})
            except Exception as e:   # noqa: BLE001 — summary is extra
                out["parse_error"] = f"{type(e).__name__}: {e}"
            return out
        finally:
            _profile_lock.release()


def _prime_profiler():
    """Run the profiler's one-time initialisation on this thread.  It
    must run on the thread that imported torch (kineto refuses it
    elsewhere — "External init callback must run in same thread as
    registerClient" — and then records no device activity), while a
    ``/debug/profile`` capture runs on a handler thread; the endpoint's
    start, on the application's thread, initialises it first."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with _profile_lock, _card_locks():
        with torch.profiler.profile(activities=acts):
            pass


def _card_locks():
    """Every visible card's lock (``device.device_lock``) and the graph
    capture lock, held together: no thread of this process runs work
    on a card meanwhile (a serving session holds its card's lock for
    its setup and solves).  Without a card, the capture lock alone."""
    import contextlib

    import torch

    from ..utils.cuda_graph import CAPTURE_LOCK
    stack = contextlib.ExitStack()
    if torch.cuda.is_available():
        from ..device import device_lock
        for i in range(torch.cuda.device_count()):
            stack.enter_context(device_lock(torch.device("cuda", i)))
    stack.enter_context(CAPTURE_LOCK)
    return stack


def _qfloat(q: dict, key: str) -> Optional[float]:
    vals = q.get(key)
    if not vals:
        return None
    try:
        return float(vals[0])
    except (TypeError, ValueError):
        return None


class ObservabilityHTTPD:
    """Owns one :class:`ThreadingHTTPServer` on a daemon thread.

    ``service``: the :class:`~amgx_tpu_torch.serve.SolveService` whose
    queue/SLO state ``/healthz`` reports; None serves process-level
    liveness only (useful for non-serving processes that still want
    ``/metrics``)."""

    def __init__(self, service=None):
        self.service = service
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t_start = time.monotonic()

    # ---------------------------------------------------------- lifecycle
    def start(self, port: int, host: str = "127.0.0.1"
              ) -> "ObservabilityHTTPD":
        """Bind and serve on a daemon thread (port 0 → ephemeral; read
        the real port from :attr:`port`).  Idempotent."""
        if self._server is not None:
            return self
        # a just-released port can linger in TIME_WAIT for a beat after
        # a restart — give the bind a short bounded retry
        # (utils/retry.py) instead of failing the endpoint start
        import errno

        from ..utils.retry import retry_call
        srv = retry_call(
            lambda: ThreadingHTTPServer((host, int(port)), _Handler),
            max_attempts=3, base_delay_s=0.05,
            retryable=lambda e: isinstance(e, OSError)
            and getattr(e, "errno", None) == errno.EADDRINUSE,
            label="httpd_bind")
        srv.daemon_threads = True
        srv.owner = self
        _prime_profiler()
        self._server = srv
        self._t_start = time.monotonic()
        self._thread = threading.Thread(target=srv.serve_forever,
                                        name="amgx-telemetry-httpd",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    @property
    def port(self) -> Optional[int]:
        return self._server.server_address[1] if self._server else None

    @property
    def url(self) -> Optional[str]:
        if self._server is None:
            return None
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    # ------------------------------------------------------------- health
    def health(self) -> dict:
        """The /healthz payload: endpoint uptime plus, when a service
        is attached, its queue/in-flight/SLO-overload state."""
        out = {"ok": True,
               "uptime_s": round(time.monotonic() - self._t_start, 3),
               "overloaded": False}
        svc = self.service
        if svc is not None:
            try:
                out.update(svc.health())
            except Exception as e:  # noqa: BLE001 — health must answer
                out.update(ok=False, error=f"{type(e).__name__}: {e}")
        return out


def serve_httpd(port: int, host: str = "127.0.0.1",
                service=None) -> ObservabilityHTTPD:
    """Start a standalone endpoint (port 0 → ephemeral).  The serving
    layer calls this through ``SolveService.start_endpoint``; scripts
    and tests can call it directly."""
    return ObservabilityHTTPD(service).start(port, host)
