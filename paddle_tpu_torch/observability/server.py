"""ObservabilityServer — live /metrics, /healthz, /statusz, /trace over
stdlib http.server; the port's copy of
``paddle_tpu/observability/server.py``.

A ``ThreadingHTTPServer`` on a daemon thread, JSON bodies, port 0 =
pick-a-port.  Routes:

* ``/metrics``  — Prometheus text exposition of the shared registry
  (executor caches, the persistent compile cache, scheduler
  queue/latency, page pool, engine buckets, the gateway);
* ``/healthz``  — ``{"ok": true, "uptime_s": ...}``, answered without
  touching any attached source, so a wedged scheduler cannot make the
  process look dead to probes;
* ``/statusz``  — JSON rollup of every attached source: scheduler /
  engine / executor / gateway state by name;
* ``/trace``    — the tracer's Chrome-trace JSON (load in
  chrome://tracing or Perfetto; ``tools/obs trace -o f.json`` dumps it).

``attach(name, source)`` takes a zero-arg callable or any object with
the repo's stats idioms (``stats`` / ``cache_stats`` / ``health_stats``
/ ``counts`` / ``status`` — duck-typed, so the scheduler, an
InferenceEngine, an Executor or a Gateway attach in one line).  A source
that raises reports ``{"error": ...}`` under its name instead of failing
the whole rollup.  Host-only: nothing here touches the device.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from ..utils.sync import RANK_OBS_SOURCES, OrderedLock
from .metrics import MetricsRegistry, registry as _global_registry
from .tracing import Tracer, tracer as _global_tracer

__all__ = ["ObservabilityServer", "resolve_source"]

_STAT_METHODS = ("stats", "cache_stats", "health_stats", "counts",
                 "status")


def resolve_source(obj) -> Callable[[], object]:
    """A zero-arg JSON-able view of ``obj``: callables pass through;
    objects with the repo's stats idioms get every matching method
    merged under its name (an Executor reports both cache_stats and
    health_stats; a scheduler reports stats)."""
    if callable(obj):
        return obj
    methods = [m for m in _STAT_METHODS
               if callable(getattr(obj, m, None))]
    if not methods:
        raise TypeError(
            f"cannot attach {type(obj).__name__}: not callable and has "
            f"none of {_STAT_METHODS}")
    if len(methods) == 1:
        return getattr(obj, methods[0])

    def merged():
        return {m: getattr(obj, m)() for m in methods}
    return merged


def _json_default(o):
    """statusz sources return repo-internal values (numpy scalars,
    tuples as dict keys are already gone by here) — stringify the rest
    rather than 500 the scrape."""
    try:
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:
        pass
    return str(o)


def _jsonable(obj):
    """Keys must be strings for JSON (engine bucket dicts key on shape
    tuples); normalize recursively."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class _Handler(BaseHTTPRequestHandler):
    server_ref: "ObservabilityServer" = None    # set by ObservabilityServer

    def log_message(self, *a):   # quiet
        pass

    def _send(self, body: bytes, content_type: str, code: int = 200):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200):
        body = json.dumps(_jsonable(obj), default=_json_default).encode()
        self._send(body, "application/json", code)

    def do_GET(self):
        srv = self.server_ref
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                return self._send(
                    srv.registry.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
            if path == "/healthz":
                # never touches attached sources: liveness must not
                # block behind a wedged scheduler lock
                return self._send_json(
                    {"ok": True,
                     "uptime_s": round(time.monotonic() - srv.started_at,
                                       3)})
            if path == "/statusz":
                return self._send_json(srv.statusz())
            if path == "/trace":
                return self._send_json(srv.tracer.chrome_trace())
            return self._send_json(
                {"error": f"unknown route {path}",
                 "routes": ["/metrics", "/healthz", "/statusz",
                            "/trace"]}, 404)
        except Exception as e:      # a broken source must be diagnosable
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, 500)


class ObservabilityServer:
    """Serve the metrics registry + tracer + attached status sources on
    a background thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry or _global_registry()
        self.tracer = tracer or _global_tracer()
        self.started_at = time.monotonic()
        self._sources: Dict[str, Callable[[], object]] = {}
        self._sources_lock = OrderedLock("obs.server.sources",
                                         RANK_OBS_SOURCES)
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"{h}:{p}"

    # -- sources -------------------------------------------------------------
    def attach(self, name: str, source) -> "ObservabilityServer":
        """Register a /statusz section; returns self for chaining
        (``ObservabilityServer().attach("scheduler", sched).start()``)."""
        fn = resolve_source(source)
        with self._sources_lock:
            self._sources[str(name)] = fn
        return self

    def detach(self, name: str) -> None:
        with self._sources_lock:
            self._sources.pop(str(name), None)

    def statusz(self) -> Dict[str, object]:
        with self._sources_lock:
            sources = dict(self._sources)
        out: Dict[str, object] = {
            "uptime_s": round(time.monotonic() - self.started_at, 3),
            "sources": sorted(sources),
        }
        for name, fn in sources.items():
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> str:
        if self._thread is not None:
            raise RuntimeError("start() already running")
        if self._closed:
            # stop() closed the listening socket; serve_forever on it
            # would die silently in the daemon thread while the caller
            # holds a dead address — construct a fresh server instead
            raise RuntimeError(
                "start() after stop(): the socket is closed; build a "
                "new ObservabilityServer")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="observability-server")
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._closed = True
        if self._thread is None:
            # never started: shutdown() would wait forever on an event
            # only serve_forever() sets — just release the socket
            self._httpd.server_close()
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None
