"""FleetRouter — the front tier over N gateway replicas; the port of
``paddle_tpu/serving/fleet/router.py``.

The reference survived process death on the TRAINING side: the Go
master journaled task leases to etcd, health-checked workers through
lease timeouts, and re-dispatched a dead worker's chunk to a live one
(go/master/service.go).  This module is the same cycle applied to
serving: replicas are health-checked through ``/readyz``, a dead or
draining replica is pulled from rotation with seeded backoff
(``resilience/retry.RetryPolicy`` — the master client's redial loop),
and its journaled-but-unfinished requests are *migrated*: replayed onto
a healthy replica and marked done in the source journal so a respawn of
the dead process replays nothing twice.

Routing is prefix-cache aware: the request's leading prompt chunks are
chain-hashed with ``paging.affinity_key`` and rendezvous-hashed over
the ready replicas, so every request sharing a system prompt lands on
the replica that already holds its prefix pages.  Prompts with no full
chunk (nothing cacheable) fall back to least-loaded.

Exactly-once delivery is a three-way split, decided per journal entry
under the router lock:

* **delivered** — the proxy call returned before the replica died; its
  ``jid`` is in the router's delivered set (the async done-record
  writer may have lost the race with SIGKILL) -> mark done, no replay.
* **claimed** — a proxy call was IN FLIGHT when the replica died; its
  thread observed the connection failure, claimed its ``tag``, and is
  retrying on another replica itself -> mark done, no replay.
* everything else (queued work nobody is waiting on: a drain's
  leftovers, a predecessor's tail) -> replay onto a healthy replica,
  then mark done.

Marking done in the SOURCE journal is what makes migration safe against
respawn: the supervisor restarts the killed replica, its ``recover()``
reads a journal whose migrated entries are closed, and pid-qualified
jids guarantee its fresh requests never collide with the old tail.
"""

from __future__ import annotations

import hashlib
import http.client
import itertools
import json
import os
import signal as _signal
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

from ...observability import metrics as _obs_metrics
from ...resilience.retry import RetryPolicy
from ...utils.sync import RANK_FLEET_ROUTER, OrderedLock
from ..gateway.journal import RequestJournal
from ..paging import affinity_key

__all__ = ["FleetRouter", "ReplicaSpec", "NoReadyReplica"]


class NoReadyReplica(RuntimeError):
    """No replica in rotation can take the request (HTTP 503)."""

    retry_after = 2.0


class ReplicaSpec:
    """One replica as the router sees it: a name, an HTTP address, and
    (for migration) the path of its request journal — replicas and
    router share a filesystem, the fleet's one locality assumption."""

    def __init__(self, name: str, address: str,
                 journal_path: Optional[str] = None):
        self.name = str(name)
        self.address = str(address)
        self.journal_path = journal_path

    def __repr__(self):
        return (f"ReplicaSpec({self.name!r}, {self.address!r}, "
                f"journal={self.journal_path!r})")


class _Replica:
    """Router-side mutable state for one replica (guarded by the
    router lock; never touched by HTTP I/O directly)."""

    def __init__(self, spec: ReplicaSpec):
        self.spec = spec
        self.state = "unknown"      # unknown|ready|warming|draining|down
        self.in_flight = 0          # router-side proxied calls open
        self.fails = 0              # consecutive probe failures
        self.next_probe = 0.0       # monotonic deadline for next probe
        self.delays = None          # seeded backoff schedule while down
        self.drain_settled = False  # replica reported drained=True
        self.migrated = False       # this episode's journal tail handled
        self.migrations = 0
        # jids whose completions this router DELIVERED to a client —
        # the dedup input protecting against the done-record-lag window
        self.delivered = set()
        self._delivered_order: deque = deque()
        self.journal_reader: Optional[RequestJournal] = None

    def remember_delivered(self, jid: str, cap: int = 4096) -> None:
        if jid in self.delivered:
            return
        self.delivered.add(jid)
        self._delivered_order.append(jid)
        while len(self._delivered_order) > cap:
            self.delivered.discard(self._delivered_order.popleft())


def _read_http_error(e: urllib.error.HTTPError) -> Dict:
    """Parse an HTTPError's JSON body ONCE and cache it on the
    exception: the underlying response is consumable a single time,
    and the same error object is inspected at several layers (proxy's
    draining check, then _migrate's when proxy re-raises it)."""
    cached = getattr(e, "_fleet_body", None)
    if cached is None:
        try:
            cached = json.loads(e.read().decode() or "{}")
        except Exception:
            cached = {}
        e._fleet_body = cached
    return dict(cached)     # callers mutate (e.g. _probe); copy out


class FleetRouter:
    """Health-checked, affinity-routing, journal-migrating front tier.

    ``routing`` selects the placement policy: ``"affinity"`` (default;
    rendezvous-hash the prompt's leading-chunk chain hash over ready
    replicas, least-loaded when the prompt has no full chunk),
    ``"least_loaded"``, or ``"random"`` (seeded — the bench's control
    arm).  ``page_size``/``affinity_depth`` must match the replicas'
    paged generators for affinity to align with their prefix caches."""

    _tag_seq = itertools.count(1)

    def __init__(self, replicas: Sequence, page_size: int = 8,
                 affinity_depth: int = 2, routing: str = "affinity",
                 probe_interval: float = 0.25, probe_timeout: float = 2.0,
                 request_timeout: float = 120.0, max_failovers: int = 3,
                 settle_timeout: float = 5.0,
                 retry: Optional[RetryPolicy] = None, seed: int = 0):
        if routing not in ("affinity", "least_loaded", "random"):
            raise ValueError(f"FleetRouter: unknown routing {routing!r}")
        self._replicas: List[_Replica] = []
        for spec in replicas:
            if not isinstance(spec, ReplicaSpec):
                spec = ReplicaSpec(*spec)
            self._replicas.append(_Replica(spec))
        names = [r.spec.name for r in self._replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"FleetRouter: duplicate replica names in "
                             f"{names}")
        self.page_size = int(page_size)
        self.affinity_depth = int(affinity_depth)
        self.routing = routing
        self.probe_interval = float(probe_interval)
        self.probe_timeout = float(probe_timeout)
        self.request_timeout = float(request_timeout)
        self.max_failovers = int(max_failovers)
        self.settle_timeout = float(settle_timeout)
        self._seed = int(seed)
        # the probe backoff SHAPE is shared; each down episode draws a
        # per-replica seeded schedule so tests see identical timing
        self._retry = retry or RetryPolicy(
            max_attempts=None, deadline=60.0, base_delay=probe_interval,
            max_delay=2.0, seed=seed)
        import random as _random
        self._rng = _random.Random(seed)
        self._lock = OrderedLock("fleet.router", RANK_FLEET_ROUTER)
        # tags claimed by proxy threads that observed their replica die
        # mid-call and are failing over themselves (bounded: claims are
        # per-incident, not per-request)
        self._claimed = set()
        self._claimed_order: deque = deque()
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._proxied = 0
        self._failovers = 0
        self._migrated_entries = 0
        reg = _obs_metrics.registry()
        self._m_requests = reg.counter(
            "paddle_fleet_requests_total",
            "Front-tier proxy outcomes per replica",
            labels=("replica", "outcome"))
        self._m_routed = reg.counter(
            "paddle_fleet_routed_total",
            "Routing decisions by effective policy",
            labels=("policy",))
        self._m_transitions = reg.counter(
            "paddle_fleet_health_transitions_total",
            "Replica rotation state transitions",
            labels=("replica", "to"))
        self._m_migrated = reg.counter(
            "paddle_fleet_migrated_total",
            "Journal entries settled by migration, by disposition",
            labels=("replica", "mode"))
        self._g_up = reg.gauge(
            "paddle_fleet_replica_up",
            "1 = replica in rotation (ready), else 0",
            labels=("replica",))
        for rep in self._replicas:
            self._g_up.labels(replica=rep.spec.name).set(0)

    # -- HTTP plumbing (always OUTSIDE the router lock) ----------------------
    def _post(self, address: str, route: str, body: Dict,
              timeout: float) -> Dict:
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://{address}{route}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    def _get(self, address: str, route: str, timeout: float) -> Dict:
        with urllib.request.urlopen(f"http://{address}{route}",
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._thread is not None:
            raise RuntimeError("FleetRouter.start(): already running")
        self.health_check_once()        # populate rotation before serving
        self._stop.clear()
        self._thread = threading.Thread(target=self._health_loop,
                                        daemon=True, name="fleet-health")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.health_check_once()
            except Exception:
                pass    # a probe bug must never kill rotation upkeep
            self._kick.wait(self.probe_interval)
            self._kick.clear()

    # -- health checking -----------------------------------------------------
    def _probe(self, rep: _Replica) -> Dict:
        try:
            state = self._get(rep.spec.address, "/readyz",
                              self.probe_timeout)
            state["alive"] = True
            state.setdefault("ready", False)
            return state
        except urllib.error.HTTPError as e:
            state = _read_http_error(e)
            state["alive"] = True
            state["ready"] = False
            return state
        except (urllib.error.URLError, OSError, ValueError):
            return {"alive": False, "ready": False}

    def _set_state_locked(self, rep: _Replica, to: str) -> None:
        if rep.state != to:
            rep.state = to
            self._m_transitions.labels(replica=rep.spec.name, to=to).inc()
            self._g_up.labels(replica=rep.spec.name).set(
                1 if to == "ready" else 0)

    def _mark_down_locked(self, rep: _Replica, now: float) -> None:
        self._set_state_locked(rep, "down")
        rep.fails += 1
        if rep.delays is None:
            # per-replica seeded schedule: deterministic (stable hash —
            # builtin str hash is salted per process) and decorrelated
            salt = int(hashlib.sha1(rep.spec.name.encode())
                       .hexdigest()[:8], 16) % 997
            rep.delays = RetryPolicy(
                max_attempts=None, deadline=self._retry.deadline,
                base_delay=self._retry.base_delay,
                max_delay=self._retry.max_delay,
                seed=self._seed * 1000 + salt).delays()
        rep.next_probe = now + next(rep.delays)

    def health_check_once(self) -> None:
        """One probe sweep + any migrations it unlocked.  Also the
        health thread's body; callable inline from tests for
        deterministic stepping."""
        now = time.monotonic()
        due: List[_Replica] = []
        with self._lock:
            for rep in self._replicas:
                if now >= rep.next_probe:
                    due.append(rep)
        for rep in due:
            status = self._probe(rep)       # I/O outside the lock
            now = time.monotonic()
            with self._lock:
                if status.get("ready"):
                    if rep.state != "ready":
                        # back in rotation: a respawned process owns
                        # its journal again — the next death episode
                        # starts from a clean migration slate
                        rep.fails = 0
                        rep.delays = None
                        rep.drain_settled = False
                        rep.migrated = False
                        rep.journal_reader = None
                    self._set_state_locked(rep, "ready")
                    rep.next_probe = now + self.probe_interval
                elif status.get("alive"):
                    if status.get("draining"):
                        self._set_state_locked(rep, "draining")
                        if status.get("drained"):
                            rep.drain_settled = True
                    else:
                        self._set_state_locked(rep, "warming")
                    rep.fails = 0
                    rep.delays = None
                    rep.next_probe = now + self.probe_interval
                else:
                    self._mark_down_locked(rep, now)
        self._run_due_migrations()

    def _run_due_migrations(self) -> None:
        for rep in self._replicas:
            with self._lock:
                due = (not rep.migrated
                       and rep.spec.journal_path is not None
                       and (rep.state == "down"
                            or (rep.state == "draining"
                                and rep.drain_settled)))
            if due:
                self._migrate(rep)

    # -- routing -------------------------------------------------------------
    def _route(self, prompt: Sequence[int],
               excluded: Iterable[str]) -> _Replica:
        key = None
        if self.routing == "affinity":
            key = affinity_key(prompt, self.page_size,
                               self.affinity_depth)
        excluded = set(excluded)
        with self._lock:
            ready = [r for r in self._replicas
                     if r.state == "ready" and r.spec.name not in excluded]
            if not ready:
                raise NoReadyReplica(
                    "fleet: no ready replica in rotation"
                    + (f" (excluding {sorted(excluded)})" if excluded
                       else ""))
            if self.routing == "random":
                rep = ready[self._rng.randrange(len(ready))]
                policy = "random"
            elif key is not None:
                # rendezvous (HRW) hash: stable under membership churn —
                # only keys owned by a pulled replica move
                rep = max(ready, key=lambda r: hashlib.sha1(
                    f"{key}|{r.spec.name}".encode()).digest())
                policy = "affinity"
            else:
                rep = min(ready,
                          key=lambda r: (r.in_flight, r.spec.name))
                policy = "least_loaded"
            rep.in_flight += 1
            self._m_routed.labels(policy=policy).inc()
            return rep

    def _claim_locked(self, tag: str, cap: int = 4096) -> None:
        if tag in self._claimed:
            return
        self._claimed.add(tag)
        self._claimed_order.append(tag)
        while len(self._claimed_order) > cap:
            self._claimed.discard(self._claimed_order.popleft())

    # -- the proxy path ------------------------------------------------------
    def generate(self, model: str, prompt, tenant: str = "default",
                 max_new: Optional[int] = None,
                 speculate: Optional[bool] = None, constraint=None,
                 draft_model: Optional[str] = None,
                 timeout: Optional[float] = None) -> Dict:
        """Route + proxy one blocking ``/v1/generate`` (the existing
        wire format, verbatim).  Streaming goes straight to a replica —
        a mid-stream failover could not be exactly-once without token
        offsets, so the front tier does not pretend to offer it."""
        body: Dict = {"model": str(model),
                      "prompt": [int(t) for t in prompt],
                      "tenant": str(tenant)}
        if max_new is not None:
            body["max_new"] = int(max_new)
        if speculate is not None:
            body["speculate"] = bool(speculate)
        if constraint is not None:
            body["constraint"] = constraint
        if draft_model is not None:
            body["draft_model"] = str(draft_model)
        return self.proxy(body, timeout=timeout)

    def proxy(self, body: Dict, exclude: Iterable[str] = (),
              timeout: Optional[float] = None) -> Dict:
        """Proxy a prepared ``/v1/generate`` body with failover.  The
        router stamps its own ``tag`` (journaled by the replica): if
        the replica dies mid-call, THIS thread claims the tag — telling
        the migration pass the entry already has an owner — and retries
        on the next replica itself."""
        tag = f"fleet-{os.getpid()}-{next(FleetRouter._tag_seq)}"
        body = dict(body)
        body["tag"] = tag
        excluded = set(exclude)
        last_err: Optional[BaseException] = None
        for _ in range(self.max_failovers + 1):
            rep = self._route(body.get("prompt") or (), excluded)
            name = rep.spec.name
            try:
                out = self._post(rep.spec.address, "/v1/generate", body,
                                 timeout or self.request_timeout)
            except urllib.error.HTTPError as e:
                draining = (e.code == 503 and _read_http_error(e)
                            .get("reason") == "draining")
                if not draining:
                    # any other HTTP error is the replica's verdict on
                    # THIS request (429/400/404/500): propagate, don't
                    # failover
                    self._m_requests.labels(replica=name,
                                            outcome="error").inc()
                    raise
                with self._lock:
                    # claim BEFORE the finally below decrements: the
                    # migration pass gates on in_flight == 0, and a
                    # claim landing after that gate opens would let it
                    # replay an entry this thread is already retrying.
                    # The claim is a no-op when the 503 fired before
                    # journaling (submit refused).
                    self._claim_locked(tag)
                    self._set_state_locked(rep, "draining")
                self._m_requests.labels(replica=name,
                                        outcome="failover").inc()
                self._failovers += 1
                self._kick.set()
                excluded.add(name)
                last_err = e
                continue
            except (urllib.error.URLError, ConnectionError, OSError,
                    http.client.HTTPException, ValueError) as e:
                reason = getattr(e, "reason", e)
                if isinstance(reason, socket.timeout) \
                        or isinstance(e, socket.timeout):
                    # a TIMEOUT is not a death signal: the replica may
                    # still complete and journal it — failing over here
                    # could double-serve.  Surface it.
                    self._m_requests.labels(replica=name,
                                            outcome="error").inc()
                    raise
                # HTTPException covers IncompleteRead — a replica
                # SIGKILLed mid-response truncates the body — and
                # ValueError the JSON parse of that truncation; both
                # mean the response never reached a client, so claiming
                # + retrying still delivers exactly once
                with self._lock:
                    self._claim_locked(tag)
                    self._mark_down_locked(rep, time.monotonic())
                self._m_requests.labels(replica=name,
                                        outcome="failover").inc()
                self._failovers += 1
                self._kick.set()        # health thread migrates the tail
                excluded.add(name)
                last_err = e
                continue
            else:
                with self._lock:
                    jid = out.get("jid")
                    if jid:
                        rep.remember_delivered(str(jid))
                    self._proxied += 1
                self._m_requests.labels(replica=name,
                                        outcome="proxied").inc()
                out["replica"] = name
                return out
            finally:
                # the increment from _route is undone HERE and only
                # here, whatever the exit path — an exception outside
                # the handled set must not leak the count, or the
                # migration gate (in_flight == 0) never opens for this
                # replica and least-loaded routing skews forever.
                # Claims and delivered-marks above happen BEFORE this
                # decrement, so the gate cannot open without them.
                with self._lock:
                    rep.in_flight -= 1
        if last_err is not None:
            raise last_err
        raise NoReadyReplica("fleet: failover budget exhausted")

    # -- migration -----------------------------------------------------------
    def _decode_to_body(self, entry: Dict) -> Dict:
        body = {"model": entry["model"], "prompt": entry["prompt"],
                "tenant": entry.get("tenant", "default"),
                "max_new": entry.get("max_new")}
        decode = entry.get("decode") or {}
        if "draft" in decode:
            body["speculate"] = bool(decode["draft"])
        if decode.get("constraint") is not None:
            body["constraint"] = decode["constraint"]
        return body

    def _migrate(self, rep: _Replica) -> Dict[str, int]:
        """Settle a dead/drained replica's journal tail: every pending
        entry is closed exactly once — replayed onto a healthy replica,
        or marked done because its completion was already delivered or
        its proxy thread claimed it.  See the module docstring for why
        this is exactly-once."""
        name = rep.spec.name
        # let in-flight proxy threads against this replica observe the
        # failure and register their claims first — the split below is
        # only race-free once nobody is mid-call
        deadline = time.monotonic() + self.settle_timeout
        while True:
            with self._lock:
                if rep.in_flight == 0:
                    break
            if time.monotonic() >= deadline:
                # proxy threads still mid-call against the corpse:
                # their claims are not in yet, so splitting now could
                # replay an entry one of them is about to retry.
                # Punt to the next sweep rather than risk a duplicate.
                return {"replayed": 0, "claimed": 0, "delivered": 0,
                        "failed": 0}
            time.sleep(0.01)
        with self._lock:
            if rep.migrated:        # another pass won the race
                return {"replayed": 0, "claimed": 0, "delivered": 0,
                        "failed": 0}
            if rep.journal_reader is None:
                rep.journal_reader = RequestJournal(rep.spec.journal_path)
            jr = rep.journal_reader
        stats = {"replayed": 0, "claimed": 0, "delivered": 0, "failed": 0}
        for entry in jr.pending():
            jid = entry.get("jid")
            if jid is None:
                continue
            tag = entry.get("tag")
            with self._lock:
                was_delivered = jid in rep.delivered
                was_claimed = tag is not None and tag in self._claimed
            if was_delivered:
                jr.record_done(jid, ok=True, error="migrated:delivered")
                stats["delivered"] += 1
                self._m_migrated.labels(replica=name,
                                        mode="delivered").inc()
                continue
            if was_claimed:
                jr.record_done(jid, ok=True, error="migrated:claimed")
                stats["claimed"] += 1
                self._m_migrated.labels(replica=name,
                                        mode="claimed").inc()
                continue
            try:
                self.proxy(self._decode_to_body(entry),
                           exclude=(name,))
            except NoReadyReplica:
                # nowhere to put the work: leave the tail pending and
                # retry the whole migration at a later sweep
                jr.flush()
                return stats
            except urllib.error.HTTPError as e:
                if (e.code == 503 and _read_http_error(e)
                        .get("reason") == "draining"):
                    # proxy() exhausted its failover budget with every
                    # remaining target draining and re-raised the last
                    # 503 — the entry is perfectly recoverable, not a
                    # poison pill.  Same disposition as NoReadyReplica:
                    # leave the tail pending for a later sweep.
                    jr.flush()
                    return stats
                # the target REFUSED it (model gone, over limit): close
                # the entry as failed — replaying a poison pill forever
                # is how recovery loops die
                jr.record_done(jid, ok=False, error="migrate_failed")
                stats["failed"] += 1
                self._m_migrated.labels(replica=name, mode="failed").inc()
                continue
            except (urllib.error.URLError, ConnectionError, OSError,
                    http.client.HTTPException, ValueError):
                # the replay TARGET died mid-call and the failover
                # budget ran out — fleet-wide instability, not this
                # entry's fault.  Leave the tail pending; the next
                # sweep retries once the rotation stabilizes.
                jr.flush()
                return stats
            jr.record_done(jid, ok=True, error="migrated")
            stats["replayed"] += 1
            self._m_migrated.labels(replica=name, mode="replayed").inc()
        jr.flush()
        with self._lock:
            rep.migrated = True
            rep.migrations += 1
            self._migrated_entries += sum(stats.values())
        return stats

    # -- operator verbs (the fleet CLI's backend) ----------------------------
    def _by_name(self, name: str) -> _Replica:
        for rep in self._replicas:
            if rep.spec.name == name:
                return rep
        raise KeyError(f"fleet: unknown replica {name!r}")

    def drain(self, name: str, timeout: float = 30.0) -> Dict:
        """Start draining a replica: it finishes in-flight work, its
        queued tail migrates once settled, and it leaves rotation
        immediately."""
        rep = self._by_name(name)
        out = self._post(rep.spec.address, "/v1/admin",
                         {"action": "drain", "timeout": timeout}, 10.0)
        with self._lock:
            self._set_state_locked(rep, "draining")
        self._kick.set()
        return out

    def kill(self, name: str) -> Dict:
        """SIGKILL a replica process (same-host chaos drill): its pid
        comes from /statusz, its tail from journal migration, its
        respawn from the supervisor."""
        rep = self._by_name(name)
        st = self._get(rep.spec.address, "/statusz", 10.0)
        pid = st.get("pid")
        if not pid:
            raise RuntimeError(f"fleet: {name} reports no pid")
        os.kill(int(pid), _signal.SIGKILL)
        with self._lock:
            self._mark_down_locked(rep, time.monotonic())
        self._kick.set()
        return {"killed": name, "pid": int(pid)}

    def restore(self, name: str) -> Dict:
        """Ask for an immediate re-probe of a pulled replica (after a
        manual respawn) instead of waiting out its backoff."""
        rep = self._by_name(name)
        with self._lock:
            rep.next_probe = 0.0
            rep.fails = 0
            rep.delays = None
        self._kick.set()
        return {"restoring": name}

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            replicas = [{
                "name": r.spec.name, "address": r.spec.address,
                "state": r.state, "in_flight": r.in_flight,
                "probe_fails": r.fails, "migrations": r.migrations,
                "journal": r.spec.journal_path,
            } for r in self._replicas]
            return {
                "routing": self.routing,
                "page_size": self.page_size,
                "affinity_depth": self.affinity_depth,
                "replicas": replicas,
                "ready": sum(1 for r in self._replicas
                             if r.state == "ready"),
                "proxied": self._proxied,
                "failovers": self._failovers,
                "migrated_entries": self._migrated_entries,
            }
