"""Named, ranked locks and the process-global SyncRegistry — the port's
copy of ``paddle_tpu/utils/sync.py``.

The serving stack runs cooperating threads: the scheduler's admit/step
loop, the gateway's HTTP workers, journal writers, metrics scrapes.  This
module makes their locking discipline declared and checkable:

* ``OrderedLock`` / ``OrderedRLock`` / ``OrderedCondition`` wrap the
  stdlib primitives with a **name** and a **rank**.  The rank table
  (``RANK_*`` below, the reference's) encodes the permitted nesting
  order: a thread may only acquire locks of *ascending* rank.  Equal
  ranks may nest (two independent journals); the cycle detector polices
  those.
* The process-global ``SyncRegistry`` — active only when
  ``PADDLE_TPU_SYNC_CHECK=1`` (or ``enable_checking()``) — records a
  held->acquiring edge into a lock-order graph on every nested acquire
  and raises **at acquire time**:

  - ``LockOrderError`` on a rank inversion (acquiring a lower rank
    while holding a higher one), reporting BOTH acquisition sites;
  - ``DeadlockCycleError`` when the new edge closes a cycle in the
    lock-order graph (a potential ABBA deadlock), reporting the cycle
    and both acquisition sites of the conflicting edge.

  It also tracks per-lock acquire counts, contention, blocked-wait and
  hold times (the ``paddle_sync_*`` collector metrics) and offers a
  ``status()`` rollup with a stack dump of every blocked thread — a
  ``/statusz`` source (``ObservabilityServer.attach("sync",
  sync.registry())``).

* When checking is DISABLED (the default), every wrapper is a
  passthrough: one module-global flag test, then the raw ``threading``
  primitive.

* ``sync.preempt`` — the race-harness chaos point:
  ``enable_preemption(injector)`` arms seeded yield/sleep perturbations
  at acquire/release boundaries, drawn from the ``FaultInjector``'s
  sequence, so a test can widen race windows deterministically per
  seed.

Host-only: nothing here touches the device.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = [
    "OrderedLock", "OrderedRLock", "OrderedCondition", "SyncRegistry",
    "LockOrderError", "DeadlockCycleError", "registry",
    "enable_checking", "disable_checking", "checking_enabled",
    "enable_preemption", "disable_preemption", "RANK_TABLE",
]

# -- the repo rank table ------------------------------------------------------
# Ascending rank = permitted acquire order (outermost first).  A thread
# holding rank R may only acquire ranks > R (same-instance RLock
# re-entry excepted); equal ranks may nest across DIFFERENT names and
# are policed by the cycle detector instead.  Keep this table in sync
# with the reference's README "Concurrency discipline".
RANK_LOADER = 8            # pipeline.loader       fluid/pipeline_io.py
#                            executor.capture      fluid/executor.py
RANK_SERVICE = 10          # resilience.service    resilience/service.py
RANK_LIFECYCLE = 12        # lifecycle.controller  lifecycle/controller.py
RANK_NATIVE_BUILD = 14     # native.build          kernels/_build.py
RANK_NATIVE = 15           # native.lib            native/__init__.py
RANK_COORD = 18            # coord.state           parallel/coordinator.py
RANK_MASTER_SNAP = 20      # master.snapshot       parallel/master_service.py
RANK_MASTER_QUEUE = 22     # master.queue          parallel/master.py
RANK_FLEET_ROUTER = 24     # fleet.router          serving/fleet/router.py
RANK_GATEWAY_WEDGE = 26    # gateway.wedge         serving/gateway/gateway.py
RANK_SCHEDULER = 30        # serving.scheduler     serving/scheduler.py
RANK_SESSIONS = 34         # serving.sessions      serving/sessions.py
RANK_ROUTER = 40           # gateway.router        serving/gateway/router.py
RANK_CANARY = 42           # lifecycle.canary      lifecycle/canary.py
RANK_MODEL_REGISTRY = 44   # gateway.registry      serving/gateway/registry.py
RANK_CONSTRAINTS = 46      # serving.constraints   serving/speculative.py
RANK_JOURNAL_CV = 50       # gateway.journal.cv    serving/gateway/journal.py
RANK_JOURNAL_FILE = 52     # *.journal.file        utils/journal.py
RANK_GUARD = 60            # guardrails.dispatch   resilience/guardrails.py
RANK_COLLECTOR_INIT = 70   # obs.collector_init    one-shot register guards
RANK_OBS_SOURCES = 75      # obs.server.sources    observability/server.py
RANK_METRICS_REGISTRY = 80  # metrics.registry     observability/metrics.py
RANK_METRICS_FAMILY = 82   # metrics.family        observability/metrics.py
RANK_METRICS_CHILD = 84    # metrics.child         observability/metrics.py
RANK_PROFILER = 85         # fluid.profiler        fluid/profiler.py
RANK_TRACER = 86           # obs.tracer            observability/tracing.py
RANK_CHAOS = 90            # chaos.injector        resilience/chaos.py

RANK_TABLE: Dict[str, int] = {
    "pipeline.loader": RANK_LOADER,
    "resilience.service": RANK_SERVICE,
    "lifecycle.controller": RANK_LIFECYCLE,
    "native.build": RANK_NATIVE_BUILD,
    "native.lib": RANK_NATIVE,
    "coord.state": RANK_COORD,
    "master.snapshot": RANK_MASTER_SNAP,
    "master.queue": RANK_MASTER_QUEUE,
    "fleet.router": RANK_FLEET_ROUTER,
    "gateway.wedge": RANK_GATEWAY_WEDGE,
    "serving.scheduler": RANK_SCHEDULER,
    "serving.sessions": RANK_SESSIONS,
    "gateway.router": RANK_ROUTER,
    "lifecycle.canary": RANK_CANARY,
    "gateway.registry": RANK_MODEL_REGISTRY,
    "serving.constraints": RANK_CONSTRAINTS,
    "gateway.journal.cv": RANK_JOURNAL_CV,
    # JournalFile locks are named "<journal>.file" per instance
    "gateway.journal.file": RANK_JOURNAL_FILE,
    "lifecycle.journal.file": RANK_JOURNAL_FILE,
    "guardrails.dispatch": RANK_GUARD,
    "obs.collector_init": RANK_COLLECTOR_INIT,
    "obs.server.sources": RANK_OBS_SOURCES,
    "metrics.registry": RANK_METRICS_REGISTRY,
    "metrics.family": RANK_METRICS_FAMILY,
    "metrics.child": RANK_METRICS_CHILD,
    "fluid.profiler": RANK_PROFILER,
    "obs.tracer": RANK_TRACER,
    "chaos.injector": RANK_CHAOS,
}


class LockOrderError(RuntimeError):
    """A lock was acquired against the declared rank order — the nesting
    the rank table forbids, caught at acquire time instead of as a
    production deadlock."""


class DeadlockCycleError(LockOrderError):
    """The acquire would close a cycle in the observed lock-order graph
    — two threads have taken (or are taking) the same locks in opposite
    orders: a potential ABBA deadlock."""


# -- hot-path switches --------------------------------------------------------
# Read (not imported) by the wrappers on every acquire so tests
# can toggle at runtime; both default off => raw-primitive passthrough.
_CHECKING = os.environ.get("PADDLE_TPU_SYNC_CHECK", "").lower() \
    in ("1", "true", "yes")
_PREEMPT = None            # Optional[FaultInjector] with sync.preempt armed


def checking_enabled() -> bool:
    return _CHECKING


def enable_checking() -> None:
    """Turn on order/cycle checking + wait/hold accounting process-wide
    (idempotent).  Registers the ``paddle_sync_*`` metrics collector on
    first use."""
    global _CHECKING
    _CHECKING = True
    _REG._register_collector()


def disable_checking() -> None:
    """Turn checking off.  Held-lock bookkeeping is dropped: releases
    go through the passthrough while off, so entries recorded before
    the toggle could never be unwound — a later re-enable would see
    stale entries and raise spurious self-deadlock/rank errors."""
    global _CHECKING
    _CHECKING = False
    with _REG._meta:
        _REG._held.clear()
        _REG._waiting.clear()


def enable_preemption(injector=None) -> None:
    """Arm the ``sync.preempt`` chaos point: every lock acquire/release
    boundary consumes one seeded draw from ``injector`` (default: the
    process-global ``resilience.chaos.injector()``) and, when it fires,
    yields or sleeps a tiny deterministic-length interval — widening
    race windows so the seeded-schedule harness can shake out ordering
    bugs reproducibly."""
    global _PREEMPT
    if injector is None:
        from ..resilience.chaos import injector as _inj  # lazy: chaos
        injector = _inj()                                # imports sync
    _PREEMPT = injector


def disable_preemption() -> None:
    global _PREEMPT
    _PREEMPT = None


def _perturb() -> None:
    inj = _PREEMPT
    if inj is not None:
        try:
            inj.maybe_preempt()
        except Exception:
            pass    # a broken injector must never break locking itself


def _call_site() -> str:
    """file:line of the first frame outside this module — where the
    lock is being acquired (only computed while checking is on)."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:       # pragma: no cover - interpreter teardown
        return "?"
    return f"{f.f_code.co_filename}:{f.f_lineno}"


class _Held:
    """One lock a thread currently holds."""

    __slots__ = ("lock", "site", "since", "depth")

    def __init__(self, lock, site: str, since: float):
        self.lock = lock
        self.site = site
        self.since = since
        self.depth = 1


class SyncRegistry:
    """Process-global lock-order graph + per-lock accounting.

    All internal state is guarded by ONE raw ``threading.Lock``
    (``_meta``) that is deliberately outside the ordered world: the
    registry must be callable from inside any wrapper without
    re-entering itself.  No callout (metrics, chaos, I/O) ever happens
    while ``_meta`` is held."""

    def __init__(self):
        self._meta = threading.Lock()
        # tid -> [_Held, ...] in acquisition order (only the owning
        # thread mutates its own list; _meta serializes cross-thread
        # reads for status()/graph())
        self._held: Dict[int, List[_Held]] = {}
        # (from_name, to_name) -> {"count", "held_site", "acquire_site"}
        self._edges: Dict[Tuple[str, str], Dict] = {}
        # name -> accounting dict
        self._stats: Dict[str, Dict[str, float]] = {}
        # tid -> (lock name, since, site) while blocked in acquire/wait
        self._waiting: Dict[int, Tuple[str, float, str]] = {}
        self.violations = 0
        self._collector_registered = False

    # -- bookkeeping (called from the wrappers, checking on) -----------------
    def _stat(self, name: str) -> Dict[str, float]:
        st = self._stats.get(name)
        if st is None:
            st = {"acquires": 0, "contended": 0, "wait_s": 0.0,
                  "hold_s": 0.0, "max_wait_s": 0.0, "max_hold_s": 0.0}
            self._stats[name] = st
        return st

    def _note_before_acquire(self, lock, site: str) -> Optional[_Held]:
        """Rank/cycle checks + edge recording BEFORE the inner acquire
        (a violation must raise instead of deadlocking).  Returns the
        existing _Held entry for a reentrant reacquire, else None."""
        tid = threading.get_ident()
        with self._meta:
            held = self._held.get(tid, [])
            for h in held:
                if h.lock is lock:
                    if lock._reentrant:
                        return h
                    # non-reentrant self-deadlock: about to block forever
                    self.violations += 1
                    raise LockOrderError(
                        f"self-deadlock: thread already holds "
                        f"non-reentrant lock {lock.name!r} "
                        f"(held since {h.site}, re-acquiring at {site})")
            if held and lock.rank is not None:
                worst = max((h for h in held
                             if h.lock.rank is not None),
                            key=lambda h: h.lock.rank, default=None)
                if worst is not None and lock.rank < worst.lock.rank:
                    self.violations += 1
                    raise LockOrderError(
                        f"rank inversion: acquiring {lock.name!r} "
                        f"(rank {lock.rank}) at {site} while holding "
                        f"{worst.lock.name!r} (rank {worst.lock.rank}) "
                        f"acquired at {worst.site} — the rank table "
                        f"requires ascending acquisition order")
            for h in held:
                self._record_edge(h, lock, site)
        return None

    def _record_edge(self, held: _Held, lock, site: str) -> None:
        """Add held.name -> lock.name to the graph; raise if it closes
        a cycle.  Caller holds _meta."""
        a, b = held.lock.name, lock.name
        if a == b:
            # two DIFFERENT instances under one name nested — the
            # symmetric case is indistinguishable, i.e. ABBA-prone
            self.violations += 1
            raise DeadlockCycleError(
                f"lock-order cycle: {a!r} -> {b!r} (two instances of "
                f"the same lock name nested; first held at "
                f"{held.site}, acquiring at {site})")
        edge = self._edges.get((a, b))
        if edge is None:
            path = self._find_path(b, a)
            if path is not None:
                self.violations += 1
                cyc = " -> ".join([a, b] + path[1:])
                rev = self._edges.get((path[0], path[1])) \
                    if len(path) > 1 else self._edges.get((b, a))
                rev_site = (f"; reverse edge first recorded "
                            f"held@{rev['held_site']} "
                            f"acquire@{rev['acquire_site']}"
                            if rev else "")
                raise DeadlockCycleError(
                    f"lock-order cycle: {cyc} — this thread holds "
                    f"{a!r} (acquired at {held.site}) and is acquiring "
                    f"{b!r} at {site}, but the opposite order was "
                    f"already observed{rev_site}")
            self._edges[(a, b)] = {"count": 1, "held_site": held.site,
                                   "acquire_site": site}
        else:
            edge["count"] += 1

    def _find_path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS over the edge graph from src to dst; returns the node
        path [src, ..., dst] or None.  Caller holds _meta."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self._edges:
            adj.setdefault(a, []).append(b)
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def _note_acquired(self, lock, site: str, reentrant: Optional[_Held],
                       wait_s: float, contended: bool) -> None:
        now = time.perf_counter()
        with self._meta:
            if not _CHECKING:
                # disable_checking() raced this in-flight acquire (its
                # clear runs under _meta after the flag flip): don't
                # record a held entry the passthrough release would
                # never unwind
                return
            if reentrant is not None:
                reentrant.depth += 1
                return
            self._held.setdefault(threading.get_ident(), []).append(
                _Held(lock, site, now))
            st = self._stat(lock.name)
            st["acquires"] += 1
            if contended:
                st["contended"] += 1
                st["wait_s"] += wait_s
                st["max_wait_s"] = max(st["max_wait_s"], wait_s)

    def _note_release(self, lock) -> None:
        tid = threading.get_ident()
        now = time.perf_counter()
        with self._meta:
            held = self._held.get(tid)
            if not held:
                return        # checking was enabled mid-hold: tolerate
            for i in range(len(held) - 1, -1, -1):
                h = held[i]
                if h.lock is lock:
                    if h.depth > 1:
                        h.depth -= 1
                        return
                    del held[i]
                    st = self._stat(lock.name)
                    dur = now - h.since
                    st["hold_s"] += dur
                    st["max_hold_s"] = max(st["max_hold_s"], dur)
                    return

    def _note_waiting(self, lock, site: str, kind: str = "acquire") -> None:
        with self._meta:
            self._waiting[threading.get_ident()] = (
                f"{lock.name}({kind})", time.perf_counter(), site)

    def _note_waiting_done(self) -> None:
        with self._meta:
            self._waiting.pop(threading.get_ident(), None)

    def _unwind_for_wait(self, lock) -> Optional[_Held]:
        """Condition.wait is about to release the lock internally: pop
        the held entry (whatever its depth) and account the hold."""
        tid = threading.get_ident()
        now = time.perf_counter()
        with self._meta:
            held = self._held.get(tid)
            if not held:
                return None
            for i in range(len(held) - 1, -1, -1):
                if held[i].lock is lock:
                    h = held[i]
                    del held[i]
                    st = self._stat(lock.name)
                    dur = now - h.since
                    st["hold_s"] += dur
                    st["max_hold_s"] = max(st["max_hold_s"], dur)
                    return h
        return None

    def _rewind_after_wait(self, lock, saved: Optional[_Held],
                           site: str) -> None:
        """The condition reacquired the lock on wake: re-push the held
        entry with a fresh timestamp (same recursion depth)."""
        with self._meta:
            if not _CHECKING:
                return      # toggle raced the wait (see _note_acquired)
            h = _Held(lock, site, time.perf_counter())
            if saved is not None:
                h.depth = saved.depth
            self._held.setdefault(threading.get_ident(), []).append(h)
            self._stat(lock.name)["acquires"] += 1

    # -- metrics collector ----------------------------------------------------
    def _register_collector(self) -> None:
        with self._meta:
            if self._collector_registered:
                return
            self._collector_registered = True
        # OUTSIDE _meta: the metrics registry takes its own locks
        from ..observability.metrics import registry as _metrics_registry

        _metrics_registry().register_collector(self._collect_metrics)

    def _collect_metrics(self):
        from ..observability.metrics import Sample

        with self._meta:
            stats = {n: dict(st) for n, st in self._stats.items()}
            violations = self.violations
            blocked = len(self._waiting)
        for name in sorted(stats):
            st = stats[name]
            lbl = (("lock", name),)
            yield Sample("paddle_sync_acquires_total", "counter", lbl,
                         float(st["acquires"]),
                         "Checked lock acquisitions per named lock")
            yield Sample("paddle_sync_contended_total", "counter", lbl,
                         float(st["contended"]),
                         "Acquisitions that blocked behind another "
                         "holder")
            yield Sample("paddle_sync_wait_seconds_total", "counter",
                         lbl, st["wait_s"],
                         "Total blocked-wait time per named lock")
            yield Sample("paddle_sync_hold_seconds_total", "counter",
                         lbl, st["hold_s"],
                         "Total hold time per named lock")
        yield Sample("paddle_sync_order_violations_total", "counter", (),
                     float(violations),
                     "Rank inversions + lock-order cycles detected")
        yield Sample("paddle_sync_blocked_threads", "gauge", (),
                     float(blocked),
                     "Threads currently blocked on a checked lock")

    # -- public views ---------------------------------------------------------
    def graph(self) -> Dict[str, object]:
        """The observed lock-order graph: JSON-able nodes + edges with
        the first-recorded acquisition sites."""
        with self._meta:
            edges = [{"from": a, "to": b, **dict(info)}
                     for (a, b), info in sorted(self._edges.items())]
            nodes = sorted({n for e in self._edges for n in e}
                           | set(self._stats))
        return {"checking": _CHECKING, "nodes": nodes, "edges": edges,
                "ranks": {n: RANK_TABLE.get(n) for n in nodes},
                "violations": self.violations}

    def export_graph(self, path: str) -> Dict[str, object]:
        import json

        g = self.graph()
        with open(path, "w", encoding="utf-8") as f:
            json.dump(g, f, indent=1, sort_keys=True)
        return g

    def status(self) -> Dict[str, object]:
        """JSON-able rollup — a duck-typed /statusz source: per-lock
        accounting, the graph size, and a stack dump of every thread
        currently blocked on a checked lock (the wedge diagnosis the
        gateway's ``wedged()`` detector cannot give)."""
        now = time.perf_counter()
        with self._meta:
            stats = {n: {k: (round(v, 6) if isinstance(v, float) else v)
                         for k, v in st.items()}
                     for n, st in sorted(self._stats.items())}
            waiting = dict(self._waiting)
            held = {tid: [(h.lock.name, h.site, round(now - h.since, 6))
                          for h in hs]
                    for tid, hs in self._held.items() if hs}
            n_edges = len(self._edges)
        frames = sys._current_frames()
        blocked = []
        for tid, (what, since, site) in sorted(waiting.items()):
            entry = {"thread": tid, "blocked_on": what,
                     "waited_s": round(now - since, 6), "site": site}
            f = frames.get(tid)
            if f is not None:
                entry["stack"] = traceback.format_stack(f)
            blocked.append(entry)
        return {"checking": _CHECKING,
                "preempt": _PREEMPT is not None,
                "locks": stats,
                "edges": n_edges,
                "violations": self.violations,
                "held": {str(t): hs for t, hs in sorted(held.items())},
                "blocked": blocked}

    def reset(self) -> None:
        """Drop graph/stats/waiting state (tests).  Held entries are
        cleared too; releases of locks acquired before the reset are
        tolerated by ``_note_release``."""
        with self._meta:
            self._held.clear()
            self._edges.clear()
            self._stats.clear()
            self._waiting.clear()
            self.violations = 0


_REG = SyncRegistry()


def registry() -> SyncRegistry:
    """The process-global SyncRegistry (attach it to an
    ObservabilityServer: ``srv.attach("sync", sync.registry())``)."""
    return _REG


# -- the wrappers -------------------------------------------------------------
class OrderedLock:
    """``threading.Lock`` with a declared name and rank.  Passthrough
    when checking is off; order-checked + accounted when on."""

    _reentrant = False
    __slots__ = ("name", "rank", "_lock")

    def __init__(self, name: str, rank: Optional[int] = None):
        self.name = str(name)
        self.rank = None if rank is None else int(rank)
        self._lock = self._make()

    def _make(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _CHECKING:
            if _PREEMPT is not None:
                _perturb()
                got = self._lock.acquire(blocking, timeout)
                if got:
                    _perturb()
                return got
            return self._lock.acquire(blocking, timeout)
        return self._acquire_checked(blocking, timeout)

    def _acquire_checked(self, blocking: bool, timeout: float) -> bool:
        site = _call_site()
        reentrant = _REG._note_before_acquire(self, site)
        _perturb()
        t0 = time.perf_counter()
        got = self._lock.acquire(False)
        contended = False
        if not got and blocking:
            contended = True
            _REG._note_waiting(self, site)
            try:
                got = self._lock.acquire(True, timeout)
            finally:
                _REG._note_waiting_done()
        wait = (time.perf_counter() - t0) if contended else 0.0
        if got:
            _REG._note_acquired(self, site, reentrant, wait, contended)
            _perturb()
        return got

    def release(self) -> None:
        if _CHECKING:
            _perturb()
            _REG._note_release(self)
            self._lock.release()
            if _PREEMPT is not None:
                _perturb()
            return
        if _PREEMPT is not None:
            # the harness's usual mode (preemption without checking):
            # perturb BOTH sides of the release — before (widening the
            # critical section) and after (delaying this thread in the
            # release-then-publish handoff window)
            _perturb()
            self._lock.release()
            _perturb()
            return
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        return (f"<{type(self).__name__} {self.name!r} "
                f"rank={self.rank}>")


class OrderedRLock(OrderedLock):
    """``threading.RLock`` flavor: same-thread re-entry skips the order
    checks (re-acquiring a lock you hold creates no new edge)."""

    _reentrant = True
    __slots__ = ()

    def _make(self):
        return threading.RLock()

    def locked(self) -> bool:     # RLock has no locked() before 3.12
        owned = getattr(self._lock, "_is_owned", None)
        if owned is not None and owned():
            # a bare probe-acquire would succeed REENTRANTLY for the
            # owner and report the held lock as free
            return True
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True


class OrderedCondition:
    """``threading.Condition`` over an OrderedLock/OrderedRLock.

    Pass ``lock=`` to share an existing ordered lock (the scheduler's
    ``_work`` condition shares its state lock — both map to the SAME
    registry node), or ``name``/``rank`` to own a fresh one.  ``wait``
    unwinds/rewinds the registry's held bookkeeping around the
    stdlib condition's internal release/reacquire."""

    __slots__ = ("_olock", "_cond")

    def __init__(self, lock: Optional[OrderedLock] = None,
                 name: str = "condition", rank: Optional[int] = None):
        if lock is None:
            lock = OrderedLock(name, rank)
        self._olock = lock
        self._cond = threading.Condition(lock._lock)

    @property
    def lock(self) -> OrderedLock:
        return self._olock

    @property
    def name(self) -> str:
        return self._olock.name

    def acquire(self, *a, **kw) -> bool:
        return self._olock.acquire(*a, **kw)

    def release(self) -> None:
        self._olock.release()

    def __enter__(self) -> "OrderedCondition":
        self._olock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._olock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not _CHECKING:
            if _PREEMPT is not None:
                _perturb()
            return self._cond.wait(timeout)  # syncheck: ok — delegation
        site = _call_site()
        saved = _REG._unwind_for_wait(self._olock)
        _REG._note_waiting(self._olock, site, kind="wait")
        try:
            return self._cond.wait(timeout)  # syncheck: ok — delegation
        finally:
            _REG._note_waiting_done()
            _REG._rewind_after_wait(self._olock, saved, site)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        """Predicate-loop wait (stdlib semantics), routed through our
        ``wait`` so the bookkeeping stays consistent."""
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                remaining = endtime - time.monotonic()
                if remaining <= 0:
                    break
                self.wait(remaining)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()
