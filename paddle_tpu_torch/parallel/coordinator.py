"""Elastic multi-host pod coordinator — rendezvous, heartbeats,
cross-host guardrail agreement, and host-loss recovery; the port of
``paddle_tpu/parallel/coordinator.py``.

The reference ran multi-machine training as a fault-tolerance problem
first: the Go master owned membership + dispatch and etcd owned the
agreed state, so a dying trainer was an *expected event*, not a job
failure.  This module is that control plane for the pod itself (the
data side already has MasterServer/TaskQueue): one `PodCoordinator`
owns the membership ledger and the per-step agreement barriers, served
cross-process by `CoordinatorServer` over the same stdlib HTTP/JSON
surface as the master (low-rate control traffic; no bespoke RPC), and
joined by `PodClient` from every host.

Concepts
--------

* **Generation-numbered membership epochs.**  Hosts `/join` the pod;
  once ``world_min`` hosts are present a *generation* forms: a
  monotonically increasing epoch number plus a rank assignment (sorted
  host ids -> 0..N-1).  EVERY membership change — a join, a heartbeat
  eviction, a vote-stall eviction — bumps the generation.  A host
  whose RPC carries a stale generation is told so and re-rendezvouses
  (`resync`), restoring from the last committed pod snapshot: the
  elastic shrink/regrow loop.

* **Heartbeats on the RetryPolicy backoff.**  Each host runs a
  heartbeat thread (`PodClient.start_heartbeats`); a coordinator
  restart is a pause (decorrelated-jitter redial, exactly the master
  client loop), and a host whose heartbeats stop past
  ``heartbeat_timeout`` is evicted — host loss detection.  Liveness is
  checked lazily on every incoming request (like TaskQueue lease
  timeouts): no server-side timer thread.

* **Per-step two-phase agreement, piggybacked on the health flag.**
  `step_sync` is one barrier per (generation, step): phase one, every
  live member posts its vote — ``continue`` (healthy, gradient payload
  attached), ``skip`` (local non-finite: drop the batch), or
  ``rollback`` — phase two, all members poll until the coordinator
  decides.  The agreed verdict is the MOST SEVERE vote received
  (continue < skip < rollback), and a member that fails to vote within
  ``vote_timeout`` is counted as a conservative ``skip`` AND evicted
  (a stalled voter is a lost host discovered early).  Only an
  all-continue barrier returns reduced gradients, so a guarded skip on
  one host is applied by all hosts or none — without this, one
  host-local skip silently diverges replica params forever.

* **Gradient reduction rides the vote.**  The payload of a continue
  vote is the host's (equal-share) gradient dict; the coordinator
  reduces ONCE (mean over hosts, float64 accumulate) and every member
  receives the same bytes — cross-host bitwise identity by
  construction, the pserver's "one authoritative update" property
  without a parameter server.

* **Coordinated pod snapshots** (the state half lives in
  ``fluid.checkpoint.PodCheckpointManager``): `/staged` is an
  all-ranks barrier; the COMMIT marker is written only after every
  rank reported its fsynced stage, and `/committed` records the step
  as the pod's durable resume point (returned by `/join`).  A rank
  that dies mid-stage leaves a torn manifest that simply never
  commits — recovery skips it.

Gradients reach the coordinator as numpy arrays (a host fetched them
from its card) and leave it as numpy: nothing here touches a device,
so the coordinator runs as well inside a launcher that never imports
torch's CUDA runtime.

Chaos points (resilience/chaos.py, inert unless configured):
``net.partition`` (client-side dropped RPC, retried through the
policy), ``net.delay`` (seeded deterministic send delay), and
``coord.crash`` (SIGKILL self at step_sync entry — the host-loss
scenario the whole module exists to survive).
"""

from __future__ import annotations

import base64
import json
import os
import signal
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..resilience.chaos import injector
from ..utils.sync import RANK_COORD, OrderedLock

__all__ = ["PodCoordinator", "CoordinatorServer", "PodClient",
           "MembershipView", "StaleGeneration", "agree_verdicts",
           "VERDICTS"]

# agreement severity order: the agreed verdict is the max over votes
VERDICTS = ("continue", "skip", "rollback")
_SEVERITY = {v: i for i, v in enumerate(VERDICTS)}


class StaleGeneration(RuntimeError):
    """The pod membership changed out from under this host: its
    generation number is no longer current.  Recovery is mechanical —
    `PodClient.resync()` re-rendezvouses into the new generation and
    the trainer restores the last committed pod snapshot."""


class MembershipView(NamedTuple):
    """One host's view of the pod at a generation."""

    generation: int
    rank: int
    world: int
    resume_step: int


def agree_verdicts(votes: Dict[str, str], expected) -> str:
    """The agreement rule, as a pure function (unit-testable without a
    barrier): the most severe vote wins, and every expected member that
    did NOT vote contributes a conservative ``skip`` — an absent voter
    may have applied nothing, so nobody else may apply anything.
    ``votes`` maps host -> verdict; ``expected`` is the member set of
    the generation the barrier belongs to."""
    worst = "continue"
    for host in expected:
        v = votes.get(host, "skip")
        if v not in _SEVERITY:
            raise ValueError(f"unknown verdict {v!r} from {host!r} "
                             f"(want one of {VERDICTS})")
        if _SEVERITY[v] > _SEVERITY[worst]:
            worst = v
    return worst


# -- payload wire format -----------------------------------------------------
# Self-contained (no fluid import): the coordinator must stay light
# enough to run inside a launcher process that never touches the card.

def pack_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        out[name] = {"dtype": a.dtype.name, "shape": list(a.shape),
                     "data": base64.b64encode(a.tobytes()).decode()}
    return out


def unpack_arrays(packed: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for name, d in packed.items():
        buf = base64.b64decode(d["data"])
        out[name] = np.frombuffer(buf, dtype=np.dtype(d["dtype"])) \
            .reshape(d["shape"]).copy()
    return out


def _reduce_mean(payloads: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Mean over per-host gradient dicts, accumulated in float64 and
    cast back — computed ONCE, so every member receives byte-identical
    reduced values (the cross-host bitwise-identity anchor)."""
    if not payloads:
        return {}
    names = sorted(payloads[0])
    for p in payloads[1:]:
        if sorted(p) != names:
            raise ValueError(f"gradient name sets differ across hosts: "
                             f"{names} vs {sorted(p)}")
    unpacked = [unpack_arrays(p) for p in payloads]
    out = {}
    for n in names:
        arrs = [u[n] for u in unpacked]
        shapes = {a.shape for a in arrs}
        if len(shapes) != 1:
            raise ValueError(f"gradient {n!r} shapes differ across "
                             f"hosts: {sorted(map(str, shapes))}")
        mean = np.mean(np.stack([a.astype(np.float64) for a in arrs]),
                       axis=0)
        out[n] = mean.astype(arrs[0].dtype)
    return pack_arrays(out)


# -- the coordinator state machine -------------------------------------------

class _Member:
    __slots__ = ("host", "last_seen", "joined_at")

    def __init__(self, host: str, now: float):
        self.host = host
        self.last_seen = now
        self.joined_at = now


class _Barrier:
    """One (generation, step) agreement barrier."""

    __slots__ = ("votes", "payloads", "first_at", "verdict", "reduced",
                 "error")

    def __init__(self, now: float):
        self.votes: Dict[str, str] = {}
        self.payloads: Dict[str, Dict[str, Any]] = {}
        self.first_at = now
        self.verdict: Optional[str] = None
        self.reduced: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None


class PodCoordinator:
    """The membership + agreement state machine (thread-safe, clock
    injectable — the fast unit-test surface; `CoordinatorServer` is the
    HTTP shell around one of these).

    Parameters
    ----------
    world_min: members a FORMED pod needs to stay viable — a host loss
        that leaves >= world_min survivors reforms a smaller
        generation; below it the pod waits for rejoins.
    world_target: members the FIRST generation waits for (default:
        world_min) — so an N-host job starts as one world-N pod
        instead of a world-1 pod that regrows N-1 times.
    world_max: optional cap — joins beyond it are refused (a misfired
        duplicate launcher must not grow the pod).
    heartbeat_timeout: seconds of heartbeat silence before a member is
        declared lost (evicted -> generation bump).
    vote_timeout: seconds after a step barrier's FIRST vote before the
        missing voters are counted as conservative skips and evicted.
    """

    def __init__(self, world_min: int = 1,
                 world_target: Optional[int] = None,
                 world_max: Optional[int] = None,
                 heartbeat_timeout: float = 10.0,
                 vote_timeout: float = 30.0,
                 clock=time.monotonic):
        if world_min < 1:
            raise ValueError("world_min >= 1")
        if world_max is not None and world_max < world_min:
            raise ValueError("world_max >= world_min")
        self.world_min = int(world_min)
        self.world_target = max(self.world_min,
                                int(world_target or world_min))
        self.world_max = None if world_max is None else int(world_max)
        self._formed = False
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.vote_timeout = float(vote_timeout)
        self._clock = clock
        self._lock = OrderedLock("coord.state", RANK_COORD)
        self._members: Dict[str, _Member] = {}
        self._generation = 0          # 0 = no generation ever formed
        self._ranks: Dict[str, int] = {}
        self._barriers: Dict[Tuple[int, int], _Barrier] = {}
        self._staged: Dict[Tuple[int, int], set] = {}
        self._last_committed = 0
        self._losses = 0
        self._rendezvous = 0
        # telemetry (the "pod is one /metrics surface" note): the
        # membership epoch as a gauge + heartbeat/vote counters
        from ..observability.metrics import registry as _obs

        self._m_generation = _obs().gauge(
            "paddle_coord_generation",
            "Current pod membership epoch (0 = never formed)")
        self._m_world = _obs().gauge(
            "paddle_coord_world_size", "Live members of the current "
            "generation")
        self._m_committed = _obs().gauge(
            "paddle_coord_last_committed_step",
            "Newest step with a fully committed pod snapshot")
        self._m_heartbeats = _obs().counter(
            "paddle_coord_heartbeats_total", "Heartbeats received")
        self._m_votes = _obs().counter(
            "paddle_coord_votes_total",
            "Step-agreement votes received", labels=("verdict",))
        self._m_verdicts = _obs().counter(
            "paddle_coord_agreed_verdicts_total",
            "Agreed per-step verdicts by outcome", labels=("verdict",))
        self._m_losses = _obs().counter(
            "paddle_coord_host_losses_total",
            "Members evicted (heartbeat silence or vote stall)")
        self._m_generation.set(0)
        self._m_world.set(0)

    # -- membership ----------------------------------------------------------
    def _reform_locked(self) -> None:
        """Membership changed: next generation, ranks reassigned by
        sorted host id (deterministic).  The first formation waits for
        world_target; after that world_min keeps a shrunk pod viable."""
        need = self.world_min if self._formed else self.world_target
        if len(self._members) < need:
            if not self._formed:
                return        # still gathering the first rendezvous
            # the pod fell below quorum: no active generation until
            # enough hosts (re)join — survivors see 'wait' on resync
            self._generation += 1
            self._ranks = {}
        else:
            self._formed = True
            self._generation += 1
            self._ranks = {h: r for r, h in
                           enumerate(sorted(self._members))}
            self._rendezvous += 1
        self._m_generation.set(self._generation)
        self._m_world.set(len(self._ranks))

    def _evict_locked(self, hosts, why: str) -> None:
        changed = False
        for h in hosts:
            if self._members.pop(h, None) is not None:
                changed = True
                self._losses += 1
                self._m_losses.inc()
        if changed:
            self._reform_locked()

    def _check_liveness_locked(self, exempt: Optional[str] = None) -> None:
        now = self._clock()
        dead = [h for h, m in self._members.items()
                if h != exempt
                and now - m.last_seen > self.heartbeat_timeout]
        if dead:
            self._evict_locked(dead, "heartbeat")

    def _view_locked(self, host: str) -> Dict[str, Any]:
        if host not in self._ranks:
            return {"status": "wait", "generation": self._generation}
        return {"status": "ok", "generation": self._generation,
                "rank": self._ranks[host], "world": len(self._ranks),
                "resume_step": self._last_committed}

    def join(self, host: str) -> Dict[str, Any]:
        """Enter (or re-enter) the pod; idempotent for a current member.
        Returns status 'wait' until a generation containing this host
        has formed, then the (generation, rank, world, resume_step)
        view.  A returning evicted host re-joins here — the regrow
        path is the same code as first rendezvous."""
        if not host:
            raise ValueError("join needs a host id")
        with self._lock:
            self._check_liveness_locked(exempt=host)
            now = self._clock()
            m = self._members.get(host)
            if m is None:
                if (self.world_max is not None
                        and len(self._members) >= self.world_max):
                    return {"status": "refused",
                            "error": f"pod is at world_max="
                                     f"{self.world_max}"}
                self._members[host] = _Member(host, now)
                self._reform_locked()
            else:
                m.last_seen = now
            return self._view_locked(host)

    def heartbeat(self, host: str, generation: int) -> Dict[str, Any]:
        """Liveness + staleness probe: refreshes ``last_seen``, evicts
        silent members, and tells the caller whether its generation is
        still current (the fast path by which survivors learn about a
        host loss)."""
        with self._lock:
            self._m_heartbeats.inc()
            m = self._members.get(host)
            if m is not None:
                m.last_seen = self._clock()
            self._check_liveness_locked(exempt=host)
            return {"generation": self._generation,
                    "stale": (m is None
                              or int(generation) != self._generation),
                    "last_committed": self._last_committed}

    # -- per-step agreement --------------------------------------------------
    def step_sync(self, host: str, generation: int, step: int,
                  verdict: str, payload: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        """Record one vote and report the barrier state.  Poll-style
        and idempotent: a host re-posts the same vote until the reply
        is 'decided' (or 'stale').  The FIRST all-members-voted poll
        (or the first poll past ``vote_timeout``) decides."""
        if verdict not in _SEVERITY:
            raise ValueError(f"verdict must be one of {VERDICTS}, "
                             f"got {verdict!r}")
        step = int(step)
        generation = int(generation)
        with self._lock:
            m = self._members.get(host)
            if m is not None:
                m.last_seen = self._clock()
            self._check_liveness_locked(exempt=host)
            if generation != self._generation or host not in self._ranks:
                return {"status": "stale",
                        "generation": self._generation}
            key = (generation, step)
            bar = self._barriers.get(key)
            if bar is None:
                bar = self._barriers[key] = _Barrier(self._clock())
            if bar.verdict is None and host not in bar.votes:
                bar.votes[host] = verdict
                self._m_votes.labels(verdict=verdict).inc()
                if payload is not None:
                    bar.payloads[host] = payload
            if bar.verdict is None:
                expected = set(self._ranks)
                timed_out = (self._clock() - bar.first_at
                             > self.vote_timeout)
                if expected.issubset(bar.votes):
                    self._decide_locked(key, bar, expected)
                elif timed_out:
                    # conservative skip for the missing voters, AND
                    # they are lost hosts: a stalled barrier is how a
                    # SIGKILL mid-step is discovered fastest
                    missing = expected - set(bar.votes)
                    self._decide_locked(key, bar, expected)
                    self._evict_locked(missing, "vote-stall")
            if bar.verdict is None:
                return {"status": "wait", "generation": self._generation,
                        "votes": len(bar.votes),
                        "world": len(self._ranks)}
            out = {"status": "decided", "generation": self._generation,
                   "verdict": bar.verdict}
            if bar.error:
                out["error"] = bar.error
            if bar.verdict == "continue" and bar.reduced is not None:
                out["payload"] = bar.reduced
            return out

    def _decide_locked(self, key, bar: _Barrier, expected: set) -> None:
        bar.verdict = agree_verdicts(bar.votes, expected)
        if bar.verdict == "continue" and bar.payloads:
            try:
                bar.reduced = _reduce_mean(
                    [bar.payloads[h] for h in sorted(bar.payloads)])
            except ValueError as e:
                # mismatched contributions: applying ANY of them could
                # diverge the replicas — the conservative verdict is
                # the same skip a non-finite step gets
                bar.verdict = "skip"
                bar.error = str(e)
        bar.payloads.clear()          # reduced (or dropped): free the bytes
        self._m_verdicts.labels(verdict=bar.verdict).inc()
        # GC: decided barriers of much older steps can never be
        # re-polled by a live member (they resync instead)
        horizon = key[1] - 16
        for k in [k for k in self._barriers
                  if k[1] < horizon or k[0] < key[0] - 1]:
            del self._barriers[k]

    # -- coordinated snapshot barrier ----------------------------------------
    def staged(self, host: str, generation: int, step: int
               ) -> Dict[str, Any]:
        """Rank-staged barrier: True once every member of the
        generation has reported its fsynced stage — the precondition
        for writing the COMMIT marker."""
        step, generation = int(step), int(generation)
        with self._lock:
            m = self._members.get(host)
            if m is not None:
                m.last_seen = self._clock()
            self._check_liveness_locked(exempt=host)
            if generation != self._generation or host not in self._ranks:
                return {"status": "stale",
                        "generation": self._generation}
            got = self._staged.setdefault((generation, step), set())
            got.add(host)
            done = set(self._ranks).issubset(got)
            if done:
                for k in [k for k in self._staged
                          if k[1] < step - 16]:
                    del self._staged[k]
            return {"status": "ok", "all_staged": done,
                    "generation": self._generation}

    def committed(self, host: str, generation: int, step: int
                  ) -> Dict[str, Any]:
        """Record a durable pod snapshot: `step` becomes the pod's
        resume point (monotonic — a late commit of an older manifest
        never rewinds it)."""
        with self._lock:
            if int(generation) != self._generation:
                return {"status": "stale",
                        "generation": self._generation}
            self._last_committed = max(self._last_committed, int(step))
            self._m_committed.set(self._last_committed)
            return {"status": "ok",
                    "last_committed": self._last_committed}

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        """JSON-able rollup (the ObservabilityServer /statusz source,
        duck-typed via ``status``)."""
        with self._lock:
            self._check_liveness_locked()
            return {"generation": self._generation,
                    "world": len(self._ranks),
                    "world_min": self.world_min,
                    "world_target": self.world_target,
                    "members": sorted(self._members),
                    "ranks": dict(self._ranks),
                    "last_committed": self._last_committed,
                    "host_losses": self._losses,
                    "rendezvous": self._rendezvous,
                    "open_barriers": len([b for b in
                                          self._barriers.values()
                                          if b.verdict is None])}


# -- HTTP surface ------------------------------------------------------------

from http.server import BaseHTTPRequestHandler  # noqa: E402


class _CoordHandler(BaseHTTPRequestHandler):
    coord: PodCoordinator = None        # bound by CoordinatorServer

    def log_message(self, *a):          # quiet
        pass

    def _reply(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = self.path.rstrip("/")
        if path == "/ping":
            return self._reply({"ok": True})
        if path == "/status":
            return self._reply(self.coord.status())
        return self._reply({"error": f"unknown route {self.path}"}, 404)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
        except ValueError:
            return self._reply({"error": "bad json"}, 400)
        if not isinstance(req, dict):
            return self._reply({"error": "request body must be a JSON "
                                         "object"}, 400)
        c = self.coord
        route = self.path.rstrip("/")
        try:
            if route == "/join":
                out = c.join(req.get("host", ""))
            elif route == "/heartbeat":
                out = c.heartbeat(req.get("host", ""),
                                  req.get("generation", -1))
            elif route == "/step":
                out = c.step_sync(req.get("host", ""),
                                  req.get("generation", -1),
                                  req.get("step", -1),
                                  req.get("verdict", ""),
                                  req.get("payload"))
            elif route == "/staged":
                out = c.staged(req.get("host", ""),
                               req.get("generation", -1),
                               req.get("step", -1))
            elif route == "/committed":
                out = c.committed(req.get("host", ""),
                                  req.get("generation", -1),
                                  req.get("step", -1))
            elif route == "/status":
                out = c.status()
            else:
                return self._reply(
                    {"error": f"unknown route {route}"}, 404)
        except (TypeError, ValueError) as e:     # caller's payload bug
            return self._reply({"error": str(e)}, 400)
        except Exception as e:                   # genuine server fault
            return self._reply({"error": str(e)}, 500)
        return self._reply(out)


class CoordinatorServer:
    """Serve a PodCoordinator over HTTP on a background thread (the
    MasterServer shape: construct, ``start()`` -> address, ``stop()``).
    Run it anywhere every host can reach — the launcher process, rank
    0's sidecar, or a dedicated supervisor."""

    def __init__(self, coordinator: Optional[PodCoordinator] = None,
                 host: str = "127.0.0.1", port: int = 0, **coord_kw):
        self.coordinator = coordinator or PodCoordinator(**coord_kw)
        handler = type("BoundCoordHandler", (_CoordHandler,),
                       {"coord": self.coordinator})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"{h}:{p}"

    def status(self):
        """Duck-typed /statusz source passthrough."""
        return self.coordinator.status()

    def start(self) -> str:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="pod-coordinator")
        self._thread.start()
        return self.address

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


# -- host-side client --------------------------------------------------------

class PodClient:
    """One host's handle on the pod: join/resync, the heartbeat thread,
    and the per-step agreement calls.  Transport failures retry under
    the master client's RetryPolicy (a coordinator restart is a pause,
    not a host crash); pass ``retry=False`` to fail fast in tests.

    Chaos: every RPC passes the client-side ``net.partition`` (dropped
    request -> ChaosError -> retried) and ``net.delay`` (seeded send
    delay) points; ``step_sync`` additionally draws ``coord.crash`` —
    SIGKILL self, the deterministic stand-in for a host dying
    mid-step."""

    def __init__(self, address: str, host: str, timeout: float = 30.0,
                 retry=None, poll_interval: float = 0.05):
        from .master_service import default_retry_policy

        if not host:
            raise ValueError("PodClient needs a host id")
        self.address = address
        self.host = host
        self.timeout = float(timeout)
        self.poll_interval = float(poll_interval)
        self._retry = default_retry_policy() if retry is None else retry
        self.view: Optional[MembershipView] = None
        self._stale = threading.Event()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # -- transport -----------------------------------------------------------
    def _call_once(self, route: str, payload):
        import urllib.request

        inj = injector()
        inj.maybe_fail("net.partition")
        inj.maybe_delay("net.delay")
        req = urllib.request.Request(
            f"http://{self.address}{route}",
            data=json.dumps(payload or {}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if isinstance(out, dict) and out.get("error") \
                and out.get("status") not in ("decided", "stale"):
            raise RuntimeError(f"coordinator: {out['error']}")
        return out

    def _call(self, route: str, payload=None):
        import urllib.error

        try:
            if self._retry:
                return self._retry.call(self._call_once, route, payload)
            return self._call_once(route, payload)
        except urllib.error.HTTPError as e:
            try:
                detail = json.loads(e.read()).get("error", str(e))
            except Exception:
                detail = str(e)
            raise RuntimeError(f"coordinator: {detail}") from None

    def ping(self, timeout: Optional[float] = None) -> bool:
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://{self.address}/ping",
                    timeout=self.timeout if timeout is None else timeout
            ) as resp:
                return bool(json.loads(resp.read()).get("ok"))
        except Exception:
            return False

    def status(self) -> Dict[str, Any]:
        return self._call("/status")

    # -- rendezvous ----------------------------------------------------------
    def join(self, deadline: Optional[float] = None) -> MembershipView:
        """Rendezvous: block until a generation containing this host
        forms (poll /join; 'wait' means below world_min)."""
        t0 = time.monotonic()
        while True:
            out = self._call("/join", {"host": self.host})
            if out.get("status") == "ok":
                self._stale.clear()
                self.view = MembershipView(
                    int(out["generation"]), int(out["rank"]),
                    int(out["world"]), int(out["resume_step"]))
                return self.view
            if out.get("status") == "refused":
                raise RuntimeError(f"coordinator refused join: "
                                   f"{out.get('error')}")
            if deadline is not None \
                    and time.monotonic() - t0 > deadline:
                raise TimeoutError(
                    f"pod rendezvous did not form within {deadline}s "
                    f"(below world_min?)")
            time.sleep(self.poll_interval)

    def resync(self, deadline: Optional[float] = None) -> MembershipView:
        """Re-rendezvous after a StaleGeneration: same join loop — the
        coordinator treats a current member's join as idempotent."""
        return self.join(deadline)

    def stale(self) -> bool:
        return self._stale.is_set()

    # -- heartbeats ----------------------------------------------------------
    def heartbeat(self) -> Dict[str, Any]:
        gen = self.view.generation if self.view is not None else -1
        out = self._call("/heartbeat", {"host": self.host,
                                        "generation": gen})
        if out.get("stale"):
            self._stale.set()
        return out

    def start_heartbeats(self, interval: float = 1.0) -> None:
        """Beat on a daemon thread every ``interval`` seconds.  Each
        beat retries transient transport failures through the policy
        (the RetryPolicy backoff); a beat that still fails is dropped — the
        NEXT beat redials, and only coordinator-confirmed staleness
        flips the stale flag."""
        if self._hb_thread is not None:
            return

        def loop():
            while not self._hb_stop.wait(interval):
                try:
                    self.heartbeat()
                except Exception:
                    continue        # next beat redials

        self._hb_thread = threading.Thread(
            target=loop, daemon=True, name=f"pod-heartbeat-{self.host}")
        self._hb_thread.start()

    def stop_heartbeats(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
        self._hb_stop.clear()

    # -- per-step agreement --------------------------------------------------
    def step_sync(self, step: int, verdict: str = "continue",
                  grads: Optional[Dict[str, np.ndarray]] = None,
                  deadline: Optional[float] = None
                  ) -> Tuple[str, Optional[Dict[str, np.ndarray]]]:
        """Run one two-phase agreement barrier: post this host's vote
        (phase one), poll until decided (phase two).  Returns
        ``(agreed_verdict, reduced_grads_or_None)``; raises
        :class:`StaleGeneration` when the membership moved (the caller
        must resync + restore).  Re-posting the same vote is idempotent,
        so transport retries are safe mid-barrier."""
        if self.view is None:
            raise RuntimeError("step_sync before join()")
        inj = injector()
        if inj.should("coord.crash"):
            # the chaos host-loss: die holding our vote un-posted, so
            # the pod must discover us via the vote/heartbeat timeouts
            os.kill(os.getpid(), signal.SIGKILL)
        payload = pack_arrays(grads) if grads is not None else None
        req = {"host": self.host, "generation": self.view.generation,
               "step": int(step), "verdict": verdict,
               "payload": payload}
        t0 = time.monotonic()
        while True:
            if self._stale.is_set():
                raise StaleGeneration(
                    f"{self.host}: generation "
                    f"{self.view.generation} is stale (heartbeat)")
            out = self._call("/step", req)
            st = out.get("status")
            if st == "stale":
                self._stale.set()
                raise StaleGeneration(
                    f"{self.host}: generation {self.view.generation} "
                    f"superseded by {out.get('generation')}")
            if st == "decided":
                reduced = out.get("payload")
                return (out["verdict"],
                        unpack_arrays(reduced)
                        if reduced is not None else None)
            if deadline is not None \
                    and time.monotonic() - t0 > deadline:
                raise TimeoutError(
                    f"step {step} barrier undecided after {deadline}s")
            # after the vote is recorded, the poll no longer needs to
            # re-ship the gradient bytes
            req["payload"] = None
            time.sleep(self.poll_interval)

    # -- snapshot barrier ----------------------------------------------------
    def snapshot_barrier(self, step: int,
                         deadline: Optional[float] = None) -> None:
        """Report this rank's stage fsynced, then block until every
        rank of the generation has (the COMMIT precondition).  Raises
        StaleGeneration if the membership moves mid-barrier — the
        manifest is left torn and is skipped by recovery."""
        if self.view is None:
            raise RuntimeError("snapshot_barrier before join()")
        req = {"host": self.host, "generation": self.view.generation,
               "step": int(step)}
        t0 = time.monotonic()
        while True:
            if self._stale.is_set():
                raise StaleGeneration(
                    f"{self.host}: stale during snapshot barrier")
            out = self._call("/staged", req)
            if out.get("status") == "stale":
                self._stale.set()
                raise StaleGeneration(
                    f"{self.host}: generation moved during snapshot "
                    f"barrier at step {step}")
            if out.get("all_staged"):
                return
            if deadline is not None \
                    and time.monotonic() - t0 > deadline:
                raise TimeoutError(
                    f"snapshot barrier at step {step} incomplete "
                    f"after {deadline}s")
            time.sleep(self.poll_interval)

    def committed(self, step: int) -> None:
        if self.view is None:
            raise RuntimeError("committed before join()")
        self._call("/committed",
                   {"host": self.host,
                    "generation": self.view.generation,
                    "step": int(step)})
