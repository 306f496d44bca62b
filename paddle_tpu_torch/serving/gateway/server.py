"""GatewayServer — the HTTP front door; the port's copy of
``paddle_tpu/serving/gateway/server.py``.

Same serving shape as ``observability/server.py``: stdlib ``ThreadingHTTPServer`` on a daemon thread,
JSON bodies, port 0 = pick-a-port.  Routes:

* ``POST /v1/generate`` — body ``{"model", "prompt": [ids], "tenant",
  "max_new", "stream", "draft_model", "constraint", "speculate",
  "session"}``
  (draft/constraint/speculate are the speculative/constrained
  decode options; they 400 unless the model group has a draft attached.
  ``session`` names a tiered-KV conversation: the lane's KV
  suspends to host/disk at retire and resumes on the next call with the
  same id — the blocking response echoes ``session`` + ``resumed``).
  Blocking by default (one JSON response with
  the full token list); ``"stream": true`` switches to chunked
  transfer, one JSON line per token as the decode step retires it, with
  a final ``{"done": ...}`` line.  A client that disconnects mid-stream
  cancels the request — its lane and pages free at the next step
  boundary.
* ``GET /v1/models`` — registry rollup (loaded versions, aliases, HBM
  budget); ``POST /v1/models`` with ``{"action": "load"|"swap"|
  "unload", "model", "version", ...}`` drives the lifecycle — the
  ``tools.gateway`` CLI is a thin client of this route.
* ``GET /healthz`` — liveness only, never touches the scheduler;
  ``GET /readyz`` — readiness:
  503 while a swap warms a compile or a drain is in progress, the
  fleet router's rotation signal; ``GET /statusz`` — the gateway's
  full stats rollup (registry, router, scheduler, tenant latencies).
* ``POST /v1/admin`` — ``{"action": "drain"}`` starts a background
  drain (submits 503 immediately, /readyz reports ``drained`` when the
  journal tail is stable); ``{"action": "compact_journal"}`` compacts.

Error mapping: ``RateLimited`` → 429, unknown model → 404,
``PoolCapacityError`` → 413, bad request → 400 — each with a JSON body
naming the error, so a tenant can tell "slow down" from "gone"."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..paging import PoolCapacityError
from ..scheduler import SchedulerShutdown
from .gateway import Gateway, GatewayDraining
from .router import RateLimited

__all__ = ["GatewayServer"]


class _Handler(BaseHTTPRequestHandler):
    server_ref: "GatewayServer" = None      # bound per-server subclass
    protocol_version = "HTTP/1.1"           # keep-alive + chunked

    def log_message(self, *a):   # quiet
        pass

    # -- plumbing ------------------------------------------------------------
    def _send_json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n <= 0:
            return {}
        return json.loads(self.rfile.read(n).decode() or "{}")

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

    # -- routes --------------------------------------------------------------
    def do_GET(self):
        gw = self.server_ref.gateway
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/healthz":
                # liveness ONLY: a
                # draining or warming gateway is still alive
                return self._send_json({"ok": True})
            if path == "/readyz":
                # readiness is the rotation signal: 503
                # while a swap warms a compile or a drain is running —
                # the fleet router pulls the replica, nothing routes
                # new work at a gateway that would refuse or stall it
                state = gw.ready()
                return self._send_json(state,
                                       200 if state["ready"] else 503)
            if path == "/statusz":
                return self._send_json(gw.stats())
            if path == "/v1/models":
                return self._send_json(
                    {"models": gw.models(),
                     "aliases": gw.registry.stats()["aliases"]})
            return self._send_json(
                {"error": f"unknown route {path}",
                 "routes": ["/v1/generate", "/v1/models", "/v1/admin",
                            "/healthz", "/readyz", "/statusz"]}, 404)
        except Exception as e:
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self):
        path = self.path.split("?", 1)[0].rstrip("/")
        try:
            body = self._read_json()
        except Exception as e:
            return self._send_json({"error": f"bad JSON body: {e}"}, 400)
        try:
            if path == "/v1/generate":
                return self._generate(body)
            if path == "/v1/models":
                return self._models(body)
            if path == "/v1/admin":
                return self._admin(body)
            return self._send_json({"error": f"unknown route {path}"},
                                   404)
        except (GatewayDraining, SchedulerShutdown) as e:
            # 503 + Retry-After: "come back elsewhere/later",
            # not an error in the request itself.  SchedulerShutdown
            # lands here when a drain failed this request while QUEUED:
            # its journal entry stays open (the gateway skips the done
            # record), so the fleet router either retries it itself
            # (claiming the tag) or migrates it at the next sweep.
            payload = json.dumps({"error": str(e),
                                  "reason": "draining"}).encode()
            self.send_response(503)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After",
                             str(int(getattr(e, "retry_after", 2.0))))
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return None
        except RateLimited as e:
            return self._send_json({"error": str(e),
                                    "reason": "rate_limit"}, 429)
        except PoolCapacityError as e:
            return self._send_json({"error": str(e),
                                    "reason": "pool_capacity"}, 413)
        except KeyError as e:
            return self._send_json({"error": str(e),
                                    "reason": "unknown_model"}, 404)
        except (TypeError, ValueError) as e:
            return self._send_json({"error": str(e)}, 400)
        except Exception as e:      # diagnosable, never a bare 500 page
            return self._send_json(
                {"error": f"{type(e).__name__}: {e}"}, 500)

    def _generate(self, body: dict):
        gw = self.server_ref.gateway
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise ValueError("generate: 'prompt' must be a non-empty "
                             "list of token ids")
        model = str(body.get("model", "default"))
        tenant = str(body.get("tenant", "default"))
        max_new = body.get("max_new")
        # speculative/constrained decode options: validated
        # at submit — a wrong draft name or malformed grammar is a 400
        # here, never a serve-loop failure
        draft_model = body.get("draft_model")
        constraint = body.get("constraint")
        speculate = body.get("speculate")
        if speculate is not None:
            speculate = bool(speculate)
        tag = body.get("tag")
        if tag is not None:
            tag = str(tag)
        # tiered-KV session id: same id across calls =
        # suspend at retire / resume at admission; the blocking
        # response echoes it back with a "resumed" flag
        session = body.get("session")
        if session is not None:
            session = str(session)
        if not body.get("stream", False):
            out = gw.generate(model, prompt, tenant=tenant,
                              max_new=max_new,
                              timeout=self.server_ref.request_timeout,
                              draft_model=draft_model,
                              constraint=constraint, speculate=speculate,
                              tag=tag, session=session)
            return self._send_json(out)
        # chunked streaming: one JSON line per token, then a done line.
        # BrokenPipe (client went away) cancels the request so the lane
        # and its pages stop burning on an audience of zero.
        stream = gw.submit_stream(model, prompt, tenant=tenant,
                                  max_new=max_new,
                                  timeout=self.server_ref.request_timeout,
                                  draft_model=draft_model,
                                  constraint=constraint,
                                  speculate=speculate, session=session)
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        n = 0
        try:
            for tok in stream:
                self._chunk(json.dumps({"token": int(tok)}).encode()
                            + b"\n")
                self.wfile.flush()
                n += 1
            req = stream.request
            done_line = {"done": True, "tokens": n, "rid": req.rid,
                         "jid": req.jid,
                         "version": (req.group or "@?").split("@", 1)[-1]}
            if session is not None:
                done_line["session"] = session
                done_line["resumed"] = bool(req.resumed)
            self._chunk(json.dumps(done_line).encode() + b"\n")
            self._chunk(b"")
        except (BrokenPipeError, ConnectionResetError):
            stream.close()
        except BaseException as e:
            stream.close()
            try:
                self._chunk(json.dumps(
                    {"done": True, "tokens": n,
                     "error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n")
                self._chunk(b"")
            except OSError:
                pass

    def _models(self, body: dict):
        gw = self.server_ref.gateway
        action = body.get("action")
        model = body.get("model")
        version = body.get("version")
        if action in ("load", "swap"):
            kw = {}
            if body.get("draft_model") is not None:
                kw = {"draft_model": body.get("draft_model"),
                      "draft_version": body.get("draft_version"),
                      "speculate_k": int(body.get("speculate_k", 4)),
                      "draft_dirname": body.get("draft_dirname")}
            else:
                stray = [f for f in ("draft_version", "draft_dirname",
                                     "speculate_k")
                         if body.get(f) is not None]
                if stray:
                    # refuse, don't silently produce a plain group:
                    # the misconfiguration would otherwise surface as
                    # baffling 400s on every speculative request
                    raise ValueError(
                        f"models {action}: {'/'.join(stray)} need "
                        f"draft_model")
        if action == "load":
            key = gw.load_model(model, version,
                                dirname=body.get("dirname"),
                                n_slots=body.get("n_slots"), **kw)
            return self._send_json({"loaded": key})
        if action == "swap":
            key = gw.swap_model(model, version,
                                dirname=body.get("dirname"),
                                n_slots=body.get("n_slots"), **kw)
            return self._send_json({"swapped": key})
        if action == "unload":
            gw.unload_model(f"{model}@{version}" if version else model)
            return self._send_json({"unloaded": model})
        raise ValueError(f"models: unknown action {action!r} "
                         "(load/swap/unload)")

    def _admin(self, body: dict):
        """Operational actions.  ``drain`` flips the refusal
        gate immediately and runs the actual drain on a background
        thread — the caller (fleet router / CLI) polls /readyz for
        ``drained`` instead of holding a connection open across the
        whole drain."""
        gw = self.server_ref.gateway
        action = body.get("action")
        if action == "drain":
            timeout = float(body.get("timeout", 30.0))
            # begin_drain flips the refusal gate atomically (visible
            # before this response lands) and tells repeats apart:
            # retried drain verbs (router + CLI both draining) answer
            # idempotently instead of stacking concurrent
            # sched.shutdown() threads
            if not gw.begin_drain():
                return self._send_json({"draining": True})
            t = threading.Thread(
                target=lambda: gw.shutdown(drain=True, timeout=timeout),
                daemon=True, name="gateway-drain")
            t.start()
            return self._send_json({"draining": True})
        if action == "compact_journal":
            if gw.journal is None:
                raise ValueError("admin compact_journal: gateway has "
                                 "no journal")
            return self._send_json(gw.journal.compact())
        raise ValueError(f"admin: unknown action {action!r} "
                         "(drain/compact_journal)")


class GatewayServer:
    """Serve a ``Gateway`` over HTTP on a background thread."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0, request_timeout: float = 120.0):
        self.gateway = gateway
        self.request_timeout = float(request_timeout)
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
                               "GatewayServer")
        self.gateway.serve()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="gateway-server")
        self._thread.start()
        return self.address

    def stop(self, drain: bool = True) -> None:
        self._closed = True
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.gateway.shutdown(drain=drain)
