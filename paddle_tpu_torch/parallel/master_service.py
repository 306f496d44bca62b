"""Cross-process master: an HTTP/JSON surface over TaskQueue — the
port's copy of ``paddle_tpu/parallel/master_service.py``.

The reference's master is a *service* other processes call over RPC
(go/master/service.go:89 — GetTask :368 / TaskFinished :411 /
TaskFailed :455, with etcd discovery).  TaskQueue (master.py) implements
the accounting; this module makes it reachable from other worker
processes, so a dying worker's leases really do time out and re-dispatch
to survivors on other machines — the elasticity the Go master existed
for.  stdlib http.server + JSON replaces Go RPC + etcd: the control
plane is low-rate (one lease per chunk), so a thin HTTP surface is the
choice over a bespoke protocol.

Server:  ``MasterServer(queue).start()`` -> address, in the trainer-0 (or
         any) process.  With ``snapshot_path=`` the queue auto-snapshots
         after mutating routes and a restarted master recovers from the
         snapshot (the reference's etcd persistence,
         go/master/service.go:166-207), so a master crash costs at most
         the in-flight leases — which re-dispatch anyway.
Client:  ``MasterClient(address)`` duck-types TaskQueue's worker protocol
         (get_task/task_finished/task_failed/all_done/counts), so
         ``master_reader(MasterClient(addr), read_chunk)`` works
         unchanged in every worker process.  Transient transport
         failures (connection refused/reset, timeouts, 502/503/504)
         retry under a RetryPolicy — the go/master/client.go backoff
         loop — so a master restart is a pause, not a worker crash.

Retried mutations are safe by the queue's own rules: a re-sent
/task_finished or /task_failed for a lease the first (lost-reply)
attempt already settled returns ok=False instead of double-counting —
the at-least-once contract callers already hold; a /get_task whose
reply is lost leaves an orphan lease that expires and re-dispatches.
NOTE: expiry charges the chunk's failure budget (deliberately — it is
how a chunk whose records SIGKILL workers ever gets discarded, the Go
master's checkTimeoutFunc:341 -> processFailedTask:313 behavior), so
size failure_max with crash-redispatch and lossy-transport churn in
mind, not just read errors.  The two
NON-idempotent routes (/set_dataset, /new_epoch — re-applying either
resets live accounting) are deliberately NOT retried: they fail fast so
the coordinator can inspect /counts and decide, instead of a blind
re-send silently clearing state another worker advanced.
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..resilience.chaos import injector
from ..resilience.retry import RetryPolicy
from ..utils.sync import RANK_MASTER_SNAP, OrderedLock
from .master import Task, TaskQueue

__all__ = ["MasterServer", "MasterClient"]


class _Handler(BaseHTTPRequestHandler):
    queue: TaskQueue = None     # set by MasterServer
    master: "MasterServer" = None

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.rstrip("/") == "/ping":
            # liveness: answered without touching the queue lock, so a
            # wedged queue can't make the master look dead to probes
            return self._reply({"ok": True})
        return self._reply({"error": f"unknown route {self.path}"}, 404)

    def _task_id(self, req):
        """Parse the task_id field; raises _BadRequest on client
        mistakes (missing key, non-integer) — a 400, not a 500."""
        try:
            return int(req["task_id"])
        except (KeyError, TypeError, ValueError):
            raise _BadRequest(f"missing or non-integer task_id in "
                              f"{req!r}") from None

    def do_POST(self):
        if injector().should("master.drop"):
            # injected lost REQUEST: hang up before reading/dispatching;
            # the retry is the first application (pure transport loss)
            self.close_connection = True
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            return self._reply({"error": "bad json"}, 400)
        if not isinstance(req, dict):
            # valid JSON but not an object is still the client's mistake
            return self._reply({"error": "request body must be a JSON "
                                         "object"}, 400)
        q = self.queue
        route = self.path.rstrip("/")
        try:
            if route == "/get_task":
                t = q.get_task(req.get("worker", ""))
                if t is None:
                    out = {"task": None, "all_done": q.all_done()}
                else:
                    out = {"task": {"task_id": t.task_id,
                                    "chunk": t.chunk,
                                    "epoch": t.epoch}}
            elif route == "/task_finished":
                out = {"ok": q.task_finished(self._task_id(req))}
            elif route == "/task_failed":
                out = {"ok": q.task_failed(self._task_id(req))}
            elif route == "/task_returned":
                out = {"ok": q.task_returned(self._task_id(req),
                                             req.get("worker", ""))}
            elif route == "/all_done":
                out = {"all_done": q.all_done()}
            elif route == "/counts":
                out = dict(q.counts())
            elif route == "/set_dataset":
                try:
                    chunks = req["chunks"]
                except KeyError:
                    raise _BadRequest("missing chunks") from None
                q.set_dataset(chunks)
                out = {"ok": True}
            elif route == "/new_epoch":
                q.new_epoch()
                out = {"ok": True}
            else:
                return self._reply({"error": f"unknown route {route}"},
                                   404)
        except _BadRequest as e:            # client mistake -> 400
            return self._reply({"error": str(e)}, 400)
        except (TypeError, ValueError) as e:  # bad payload shape -> 400
            return self._reply({"error": str(e)}, 400)
        except Exception as e:  # genuine queue/server fault -> 500
            return self._reply({"error": str(e)}, 500)
        if self.master is not None:
            # snapshot BEFORE acking: state the client saw confirmed is
            # state a restarted master recovers (etcd write-then-reply).
            # Checked after EVERY route — lease timeouts charge failure
            # counts inside /get_task and /all_done too — but keyed on
            # the queue's durable-image version, so idle polling never
            # touches the disk.
            try:
                self.master._maybe_snapshot()
            except Exception as e:
                # surface a snapshot I/O failure (disk full, dir gone)
                # as a diagnosable 500 — letting it escape would read
                # as a dropped connection and be retried for the full
                # deadline against the same broken disk
                return self._reply(
                    {"error": f"snapshot failed: {e}"}, 500)
        if injector().should("master.drop_reply"):
            # injected lost REPLY: the mutation above was applied (and
            # snapshotted) but the client never hears; its retry re-runs
            # the route — the idempotency contract under test
            self.close_connection = True
            return
        return self._reply(out)


class _BadRequest(Exception):
    """Malformed client request (maps to HTTP 400)."""


class MasterServer:
    """Serve a TaskQueue over HTTP on a background thread.

    ``snapshot_path`` makes the master durable: the queue snapshots
    there whenever its durable image changed (batched by
    ``snapshot_every`` versions) and — when the file already exists at
    construction — the queue is RECOVERED from it, so
    ``MasterServer(None, port=P, snapshot_path=p)`` after a crash
    resumes where the dead master stopped (pending leases come back as
    todo and re-dispatch; see TaskQueue.snapshot).  Passing BOTH a
    queue and an existing snapshot is a ValueError: the two are
    conflicting sources of truth and neither should win silently.
    """

    def __init__(self, queue: Optional[TaskQueue] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 snapshot_path: Optional[str] = None,
                 snapshot_every: int = 1):
        import os

        self.snapshot_path = snapshot_path
        self.snapshot_every = max(1, int(snapshot_every))
        # ranked BELOW master.queue: _maybe_snapshot holds this while
        # queue.snapshot takes the queue lock (write-then-reply order)
        self._snap_lock = OrderedLock("master.snapshot",
                                      RANK_MASTER_SNAP)
        recovered = bool(snapshot_path and os.path.exists(snapshot_path))
        if recovered:
            if queue is not None:
                # refusing to guess: serving the recovered queue would
                # silently ignore the caller's (and their dataset);
                # serving the caller's would silently ignore the crash
                # state the snapshot preserves
                raise ValueError(
                    f"MasterServer: snapshot {snapshot_path!r} already "
                    f"exists AND a queue was passed — pass queue=None to "
                    f"recover from the snapshot, or delete/relocate the "
                    f"stale snapshot to start fresh")
            queue = TaskQueue.recover(snapshot_path)
        elif queue is None:
            queue = TaskQueue()
        self.queue = queue
        self._snapped_version = queue.version if recovered else None
        # telemetry: task/lease state for /metrics — counts()
        # already takes the queue lock, so the scrape is exact, and the
        # collector is weak (a stopped, GC'd master stops reporting)
        from ..observability.metrics import registry as _obs_registry

        _obs_registry().register_collector(self._collect_metrics)
        handler = type("BoundHandler", (_Handler,),
                       {"queue": queue, "master": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        if snapshot_path and not recovered:
            # eager first snapshot: without it, a master that dies
            # before its first POST leaves NO file, and the documented
            # crash-restart (queue=None) would silently serve a fresh
            # empty queue whose all_done() is True — a falsely
            # "completed" job.  After this, a missing file really does
            # mean first boot.  Written AFTER the port bind above so a
            # failed constructor (EADDRINUSE) can't strand a snapshot
            # that poisons the retry of the same call.
            try:
                queue.snapshot(snapshot_path)
            except BaseException:
                # don't leak the bound socket out of a failed __init__
                # (a retry of the same port would hit EADDRINUSE)
                self._httpd.server_close()
                raise
            self._snapped_version = queue.version

    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"{h}:{p}"

    def _collect_metrics(self):
        from ..observability.metrics import Sample

        counts = self.queue.counts()
        for state in ("todo", "pending", "done", "failed"):
            yield Sample("paddle_master_tasks", "gauge",
                         (("state", state),), float(counts[state]),
                         "Master task-queue chunks by lease state")
        # deliberately NO epoch gauge: same-series collector samples SUM
        # across live masters, and an epoch is a per-instance position,
        # not a summable quantity — read it from /statusz (counts())

    def counts(self):
        """The queue's live counts — lets an ObservabilityServer attach
        the master as a /statusz source (duck-typed via ``counts``)."""
        return self.queue.counts()

    def _maybe_snapshot(self) -> None:
        if not self.snapshot_path:
            return
        with self._snap_lock:
            # inside the lock: concurrent handler threads must not
            # interleave their _atomic_write renames out of order
            v = self.queue.version
            if (self._snapped_version is not None
                    and v - self._snapped_version < self.snapshot_every):
                return    # nothing durable changed (or below the batch)
            self.queue.snapshot(self.snapshot_path)
            self._snapped_version = v

    def start(self) -> str:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.snapshot_path:
            # under the snap lock: straggler handler threads (daemon
            # threads can outlive shutdown()) must not rename an OLDER
            # image over this final one
            with self._snap_lock:
                self.queue.snapshot(self.snapshot_path)
                self._snapped_version = self.queue.version


class _RemoteTask:
    """Client-side task handle with the Task fields master_reader uses."""

    __slots__ = ("task_id", "chunk", "epoch")

    def __init__(self, d):
        self.task_id = d["task_id"]
        self.chunk = d["chunk"]
        self.epoch = d.get("epoch", 0)


# the exception classes a master restart can surface client-side; the
# single source for both the policy's class filter and _transient (an
# HTTPError IS a URLError subclass — _transient decides by status code)
_TRANSIENT_TYPES = (urllib.error.URLError, ConnectionError, TimeoutError,
                    socket.timeout, http.client.BadStatusLine)


def _transient(exc: BaseException) -> bool:
    """What a master restart looks like from the client: connection
    refused/reset, timeouts, dropped replies, and gateway-style 502/503/
    504.  A plain 500 is an application error the queue surfaced (not
    transient) and a 4xx is the caller's bug — neither retries."""
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code in (502, 503, 504)
    return isinstance(exc, _TRANSIENT_TYPES)


def default_retry_policy() -> RetryPolicy:
    """The go/master/client.go backoff loop: keep redialing a
    restarting master for up to a minute before giving up."""
    return RetryPolicy(max_attempts=None, deadline=60.0, base_delay=0.05,
                       max_delay=2.0, retryable=_TRANSIENT_TYPES,
                       retry_if=_transient)


class MasterClient:
    """TaskQueue worker-protocol proxy — use from any process.

    ``retry`` is a RetryPolicy (default: default_retry_policy()) applied
    to every RPC; pass ``retry=False`` to fail fast (tests).
    """

    def __init__(self, address: str, worker: str = "",
                 timeout: float = 30.0, retry=None):
        self.address = address
        self.worker = worker
        self.timeout = timeout
        self._retry = default_retry_policy() if retry is None else retry
        # all_done piggybacked on the last empty /get_task reply — lets
        # master_reader's poll loop spend one RPC, not two
        self._all_done_hint: Optional[bool] = None

    def _call_once(self, route: str, payload=None):
        injector().maybe_fail("master.http")
        req = urllib.request.Request(
            f"http://{self.address}{route}",
            data=json.dumps(payload or {}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if isinstance(out, dict) and out.get("error"):
            raise RuntimeError(f"master: {out['error']}")
        return out

    def _call(self, route: str, payload=None, idempotent=True):
        self._all_done_hint = None     # any RPC invalidates the hint
        try:
            if self._retry and idempotent:
                return self._retry.call(self._call_once, route, payload)
            return self._call_once(route, payload)
        except urllib.error.HTTPError as e:  # server-side queue error
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:
                detail = str(e)
            raise RuntimeError(f"master: {detail}") from None

    def ping(self, timeout: Optional[float] = None) -> bool:
        """Liveness probe (/ping) — one unretried GET; False on any
        failure, so supervisors can poll it in a tight loop."""
        try:
            with urllib.request.urlopen(
                    f"http://{self.address}/ping",
                    timeout=self.timeout if timeout is None else timeout
            ) as resp:
                return bool(json.loads(resp.read()).get("ok"))
        except Exception:
            return False

    # -- TaskQueue worker protocol ------------------------------------------
    def get_task(self, worker: str = "") -> Optional[Task]:
        out = self._call("/get_task", {"worker": worker or self.worker})
        if out.get("task"):
            return _RemoteTask(out["task"])
        if "all_done" in out:
            self._all_done_hint = bool(out["all_done"])
        return None

    def task_finished(self, task_id: int) -> bool:
        return self._call("/task_finished", {"task_id": task_id})["ok"]

    def task_failed(self, task_id: int) -> bool:
        return self._call("/task_failed", {"task_id": task_id})["ok"]

    def task_returned(self, task_id: int, worker: str = "") -> bool:
        # NOT retried, by design: the hand-back is best-effort (a lost
        # attempt just leaves the lease to expire), and a blind re-send
        # after a lost reply could race the chunk's re-dispatch; the
        # server's owner check guards the race, no-retry avoids it
        return self._call("/task_returned",
                          {"task_id": task_id,
                           "worker": worker or self.worker},
                          idempotent=False)["ok"]

    def all_done(self) -> bool:
        # consume the hint from an immediately-preceding empty get_task;
        # one-shot so a later new_epoch can't be masked by a stale True
        hint, self._all_done_hint = self._all_done_hint, None
        if hint is not None:
            return hint
        return self._call("/all_done")["all_done"]

    def counts(self):
        return self._call("/counts")

    def set_dataset(self, chunks) -> None:
        # NOT retried (non-idempotent): a lost reply after the server
        # applied it would make the blind re-send clear live accounting.
        # On a transport error, check counts() before re-issuing.
        self._call("/set_dataset", {"chunks": list(chunks)},
                   idempotent=False)

    def new_epoch(self) -> None:
        # NOT retried: re-applying a rollover whose reply was lost trips
        # the server's undispatched-work invariant (see set_dataset)
        self._call("/new_epoch", idempotent=False)
