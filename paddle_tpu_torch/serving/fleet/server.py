"""FleetRouterServer — the fleet's HTTP front door; the port of
``paddle_tpu/serving/fleet/server.py``.

Same ThreadingHTTPServer shape as ``gateway/server.py``, speaking the
same ``/v1/generate`` wire format — a client pointed at the router
instead of a replica needs no changes.  Routes:

* ``POST /v1/generate`` — blocking generate, routed by prefix affinity
  with health-checked failover.  ``"stream": true`` is refused with a
  400 naming the reason: a mid-stream failover cannot be exactly-once
  without token offsets, so streaming clients talk to a replica
  directly (its address is in /statusz).
* ``POST /v1/fleet`` — operator verbs: ``{"action": "drain"|"kill"|
  "restore", "replica": name}`` (the ``tools.fleet`` CLI's backend).
* ``GET /healthz`` — router liveness; ``GET /readyz`` — 503 until at
  least one replica is in rotation; ``GET /statusz`` — rotation states,
  proxy/migration counters; ``GET /v1/models`` — proxied from a ready
  replica (the fleet serves one homogeneous model set).

Replica-origin HTTP errors pass through with their original status and
body — the router adds routing, not opinions about request validity."""

from __future__ import annotations

import json
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .router import FleetRouter, NoReadyReplica

__all__ = ["FleetRouterServer"]


class _Handler(BaseHTTPRequestHandler):
    server_ref: "FleetRouterServer" = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):   # quiet
        pass

    def _send_json(self, obj, code: int = 200,
                   retry_after: Optional[float] = None) -> None:
        body = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if retry_after is not None:
            self.send_header("Retry-After", str(int(retry_after)))
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            return {}
        return json.loads(self.rfile.read(n).decode() or "{}")

    def _forward_http_error(self, e: urllib.error.HTTPError) -> None:
        try:
            payload = e.read()
        except Exception:
            payload = b"{}"
        self.send_response(e.code)
        self.send_header("Content-Type", "application/json")
        retry = e.headers.get("Retry-After") if e.headers else None
        if retry:
            self.send_header("Retry-After", retry)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        rt = self.server_ref.router
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/healthz":
                return self._send_json({"ok": True})
            if path == "/readyz":
                ready = rt.stats()["ready"] > 0
                return self._send_json({"ready": ready},
                                       200 if ready else 503)
            if path == "/statusz":
                return self._send_json(rt.stats())
            if path == "/v1/models":
                # the fleet is homogeneous: any ready replica's model
                # table speaks for all of them
                for rep in rt.stats()["replicas"]:
                    if rep["state"] != "ready":
                        continue
                    try:
                        return self._send_json(rt._get(
                            rep["address"], "/v1/models",
                            rt.probe_timeout))
                    except (urllib.error.URLError, OSError, ValueError):
                        continue
                return self._send_json(
                    {"error": "no ready replica"}, 503)
            return self._send_json(
                {"error": f"unknown route {path}",
                 "routes": ["/v1/generate", "/v1/fleet", "/v1/models",
                            "/healthz", "/readyz", "/statusz"]}, 404)
        except Exception as e:
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self):
        rt = self.server_ref.router
        path = self.path.split("?", 1)[0].rstrip("/")
        try:
            body = self._read_json()
        except Exception as e:
            return self._send_json({"error": f"bad JSON body: {e}"}, 400)
        try:
            if path == "/v1/generate":
                if body.get("stream"):
                    raise ValueError(
                        "fleet: streaming is served replica-direct "
                        "(failover mid-stream cannot be exactly-once); "
                        "pick a replica address from /statusz")
                prompt = body.get("prompt")
                if not isinstance(prompt, list) or not prompt:
                    raise ValueError("generate: 'prompt' must be a "
                                     "non-empty list of token ids")
                return self._send_json(rt.proxy(body))
            if path == "/v1/fleet":
                return self._fleet(body)
            return self._send_json({"error": f"unknown route {path}"},
                                   404)
        except NoReadyReplica as e:
            return self._send_json(
                {"error": str(e), "reason": "no_ready_replica"}, 503,
                retry_after=getattr(e, "retry_after", 2.0))
        except urllib.error.HTTPError as e:
            return self._forward_http_error(e)
        except urllib.error.URLError as e:
            return self._send_json(
                {"error": f"replica unreachable: {e}",
                 "reason": "bad_upstream"}, 502)
        except KeyError as e:
            return self._send_json({"error": str(e),
                                    "reason": "unknown_replica"}, 404)
        except (TypeError, ValueError) as e:
            return self._send_json({"error": str(e)}, 400)
        except Exception as e:
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, 500)

    def _fleet(self, body: dict):
        rt = self.server_ref.router
        action = body.get("action")
        name = body.get("replica")
        if action == "drain":
            return self._send_json(
                {"replica": name,
                 **rt.drain(name, timeout=float(body.get("timeout",
                                                         30.0)))})
        if action == "kill":
            return self._send_json(rt.kill(name))
        if action == "restore":
            return self._send_json(rt.restore(name))
        raise ValueError(f"fleet: unknown action {action!r} "
                         "(drain/kill/restore)")


class FleetRouterServer:
    """Serve a ``FleetRouter`` over HTTP on a background thread (also
    starts the router's health loop)."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        handler = type("BoundHandler", (_Handler,), {"server_ref": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"{h}:{p}"

    def start(self) -> str:
        if self._thread is not None:
            raise RuntimeError("start() already running")
        if self._closed:
            raise RuntimeError("start() after stop(): build a new "
                               "FleetRouterServer")
        if self.router._thread is None:
            self.router.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fleet-server")
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.router.stop()
