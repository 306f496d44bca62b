"""Continuous-batching scheduler over fixed in-flight decode slots — the
port's copy of ``paddle_tpu/serving/scheduler.py``, host-only.

A fixed number of in-flight lanes decode in lockstep, finished sequences
retire IMMEDIATELY, and queued requests backfill the freed lane at the
next step boundary.  ``serve()`` runs the admit/step loop on a daemon
thread; ``submit()`` is thread-safe and returns a ``Request`` whose
``wait()`` blocks until the sequence finishes, with per-request queue,
TTFT and latency accounting (``stats()``).

Page-aware models (``model.page_aware`` — ``PagedTransformerGenerator``)
are admitted by page budget: ``can_admit(src, max_new)`` gates each
admission, and a prompt that could NEVER fit (``prompt_infeasible``) is
rejected with ``PoolCapacityError`` instead of hanging at the head of
the queue.  A model with ``lane_step()`` steps itself: one call over
every lane (chunked prefill interleaved with decode) returns
``{slot: token}`` for the lanes that emitted.

The scheduler also keeps the reference's multi-model lane groups
(``add_model``/``remove_model``), routed and policy-driven admission,
cancellation and clean shutdown.  It reads the optional model features
(``static_hbm_estimate``, ``resume_slot``/``detach_slot``,
``tier_maintenance``, ``speculative_aware``) through ``getattr``, as
the reference does: a ``SpeculativeGenerator`` group takes per-request
decode options, a ``PagedTransformerGenerator`` with a session store
suspends and resumes sessions and runs the tier's maintenance slice, and
no port model has the static HBM estimate yet, so every group's is 0.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..observability import metrics as _obs_metrics
from ..observability import tracing as _obs_tracing
from ..utils.sync import (RANK_COLLECTOR_INIT, RANK_SCHEDULER,
                          OrderedCondition, OrderedLock)
from .paging import PoolCapacityError

__all__ = ["Request", "ContinuousBatchingScheduler", "RequestCancelled",
           "SchedulerShutdown", "HBMBudgetError", "suggest_model_axis",
           "DEFAULT_MODEL"]

DEFAULT_MODEL = "default"


class HBMBudgetError(RuntimeError):
    """Admitting this model would exceed the declared HBM budget —
    unload something (or raise the budget) first.  Raised by both the
    scheduler's ``add_model`` (when constructed with
    ``hbm_budget_bytes``) and the gateway registry's costed load; the
    message carries the static planner's per-component breakdown.
    When tensor-parallel sharding would make the model fit,
    ``suggested_model_axis`` carries the smallest mesh ``model``-axis
    size whose per-shard footprint fits the remaining budget (None
    when nothing shards or no considered axis size helps)."""

    def __init__(self, message, suggested_model_axis=None):
        super().__init__(message)
        self.suggested_model_axis = suggested_model_axis


# plan components that divide across the mesh 'model' axis: parameters
# (column/row-sharded matmul weights) and the head-sharded KV pool.
# Activations and feeds are priced replicated — the static planner's
# own conservative rule — so a suggestion never overpromises.
_SHARDABLE_COMPONENTS = ("params", "kv_pool")


def suggest_model_axis(components, available, max_axis=64):
    """Smallest power-of-two mesh ``model``-axis size whose PER-SHARD
    static footprint fits ``available`` bytes, computed from a refused
    plan's per-component breakdown (speculative plans prefix components
    with ``target.``/``draft.`` — the suffix is what shards).  Returns
    None when nothing shards or even ``max_axis`` shards stay over
    budget."""
    if not components:
        return None
    available = int(available)
    shardable = fixed = 0
    for k, v in components.items():
        if k.split(".")[-1] in _SHARDABLE_COMPONENTS:
            shardable += int(v)
        else:
            fixed += int(v)
    if shardable <= 0 or fixed > available:
        return None
    n = 2
    while n <= max_axis:
        if fixed + -(-shardable // n) <= available:
            return n
        n *= 2
    return None

# tokens-per-request is a count histogram, not a latency one
_TOKEN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


class RequestCancelled(RuntimeError):
    """The caller cancelled the request before it finished."""


class SchedulerShutdown(RuntimeError):
    """The scheduler shut down before this request was admitted."""


# ONE module-level collector aggregates every live scheduler (the
# paging.py pool-collector rule): queue depth and slot counts SUM
# honestly, but a per-instance utilization RATIO would sum to nonsense
# (two schedulers at 0.8 -> 1.6) — so the ratio is computed over the
# aggregated counts.  Schedulers register weakly.
_LIVE_SCHEDULERS: "weakref.WeakSet" = weakref.WeakSet()
_sched_collector_lock = OrderedLock("obs.collector_init",
                                    RANK_COLLECTOR_INIT)
_sched_collector_registered = False


def _collect_scheduler_metrics():
    from ..observability.metrics import Sample

    queued = active = free = total = 0
    shard_rows = []
    for s in list(_LIVE_SCHEDULERS):
        try:
            with s._lock:
                queued += len(s._queue)
                for g in s._groups.values():
                    active += len(g.active)
                    free += len(g.free)
                    total += g.n_slots
                    fn = getattr(g.model, "shard_plan", None)
                    if callable(fn):
                        shard_rows.append((g.key, fn()))
        except Exception:
            continue
    yield Sample("paddle_serving_queue_depth", "gauge", (),
                 float(queued), "Requests waiting for a slot, all live "
                 "schedulers")
    yield Sample("paddle_serving_in_flight", "gauge", (), float(active),
                 "Requests occupying a decode lane")
    for state, v in (("free", free), ("active", active),
                     ("total", total)):
        yield Sample("paddle_serving_slots", "gauge",
                     (("state", state),), float(v),
                     "Decode lanes by state")
    yield Sample("paddle_serving_slot_utilization", "gauge", (),
                 active / max(1, total),
                 "Occupied fraction of all live schedulers' lanes")
    # per-shard KV pool residency: one sample per mesh model-axis shard
    # (shard "0" with the full pool for unsharded groups), so a scrape
    # shows what each chip actually holds, not the global pool size
    for key, plan in shard_rows:
        n = max(1, int(plan.get("n_model_shards", 1)))
        per_shard = float(plan.get("pool_bytes_per_shard", 0))
        for i in range(n):
            yield Sample("paddle_serving_shard_pool_bytes", "gauge",
                         (("model", key), ("shard", str(i))), per_shard,
                         "KV pool bytes resident on each mesh "
                         "model-axis shard")


def _register_scheduler_collector() -> None:
    global _sched_collector_registered
    with _sched_collector_lock:
        if _sched_collector_registered:
            return
        _obs_metrics.registry().register_collector(
            _collect_scheduler_metrics)
        _sched_collector_registered = True


class Request:
    """One generation request and its lifecycle timestamps."""

    # itertools.count is atomic under the GIL — submit() runs in caller
    # threads, so a read-modify-write counter would hand out dup rids
    _next_id = itertools.count(1)

    def __init__(self, src_tokens, max_new_tokens: int,
                 model: str = DEFAULT_MODEL, tenant: Optional[str] = None,
                 on_token: Optional[Callable] = None,
                 decode: Optional[Dict] = None,
                 session: Optional[str] = None):
        self.rid = next(Request._next_id)
        self.src = np.asarray(src_tokens)
        self.max_new_tokens = int(max_new_tokens)
        # tiered-KV session id: admission tries resume_slot
        # first (continue from suspended KV, no re-prefill) and a clean
        # retire suspends the lane's pages instead of destroying them.
        # ``resumed`` records which path admission actually took.
        self.session = session
        self.resumed = False
        self.model = str(model)          # alias as submitted; resolved
        self.group: Optional[str] = None  # lane-group key at admission
        # per-request decode options: a speculative-aware
        # lane group receives this at admit_slot — {"draft": bool,
        # "constraint": grammar spec}; None = the model's defaults.
        # Plain JSON so the request journal replays it verbatim.
        self.decode = decode
        # admission-time routing override: a canary admission
        # policy pins the request to an explicit lane-group key (set at
        # most once, at pick time); None follows the alias through
        # ``resolve`` as usual.  Cleared — falling back to the alias —
        # if the pinned group disappears before admission (a rolled-back
        # canary must never take its queued requests down with it).
        self.route_to: Optional[str] = None
        self.tenant = tenant
        # on_token(req, tok) per decoded token and on_token(req, None)
        # once at completion — called under the scheduler lock, so it
        # must be fast and non-blocking (the streaming layer enqueues)
        self.on_token = on_token
        self.tokens: List[int] = []
        self.error: Optional[BaseException] = None
        self.submitted = time.perf_counter()
        self.admitted: Optional[float] = None
        self.finished: Optional[float] = None
        # first/last token marks (same clock as submitted/finished):
        # TTFT = first_token - submitted, inter-token gaps feed the ITL
        # histogram — the per-token signal end-to-end p50/p95 cannot see
        self.first_token: Optional[float] = None
        self.last_token: Optional[float] = None
        self.slot: Optional[int] = None
        self._done = threading.Event()
        self._cancel = threading.Event()

    # -- caller surface ------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def cancel(self) -> None:
        """Ask the scheduler to drop this request: dequeued immediately
        if still waiting, retired (lane + pages freed) at the next step
        boundary if in flight.  ``error`` becomes ``RequestCancelled``;
        tokens decoded so far stay readable."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def queue_latency(self) -> Optional[float]:
        return None if self.admitted is None else \
            self.admitted - self.submitted

    @property
    def total_latency(self) -> Optional[float]:
        return None if self.finished is None else \
            self.finished - self.submitted

    def _emit(self, tok: Optional[int]) -> None:
        """Deliver one token (or the ``None`` completion sentinel) to the
        streaming callback; a broken callback must never kill the serve
        loop.  The callback is DROPPED after the sentinel: finished
        Requests live on in the scheduler's history, and a retained
        closure would pin whatever it captured (a gateway's callback
        captures the model instance — keeping it would hold an unloaded
        version's whole KV pool in HBM after a hot swap)."""
        cb = self.on_token
        if tok is None:
            self.on_token = None
        if cb is None:
            return
        try:
            cb(self, tok)
        except Exception:
            pass


class _LaneGroup:
    """One model's lanes inside the scheduler: the model, its free/active
    slot bookkeeping, and the per-lane host state its step feed reads."""

    def __init__(self, key: str, model, n_slots: int,
                 hbm_bytes: Optional[int] = None):
        self.key = key
        self.model = model
        self.n_slots = int(n_slots)
        self.page_aware = bool(getattr(model, "page_aware", False))
        self.managed = callable(getattr(model, "lane_step", None))
        # the static planner's peak-HBM estimate for this group:
        # explicit override > model.static_hbm_estimate at the
        # group's lane count > unknown (0).  The scheduler's model-level
        # admission and stats() consult this, not a byte-count heuristic.
        if hbm_bytes is None:
            est = getattr(model, "static_hbm_estimate", None)
            if callable(est):
                try:
                    hbm_bytes = est(assume_lanes=self.n_slots).peak_bytes
                except TypeError:
                    hbm_bytes = est().peak_bytes
        self.static_hbm_bytes = int(hbm_bytes or 0)
        model.open_slots(self.n_slots)
        self.free = list(range(self.n_slots))
        self.active: Dict[int, Request] = {}
        # idle lanes hold benign values: position 0, the start token,
        # source length 1
        self.tokens = np.full(self.n_slots, model.start_id, np.int64)
        self.pos = np.zeros(self.n_slots, np.int64)
        self.src_len = np.ones(self.n_slots, np.int32)
        self.draining = False      # no new admissions (unload/hot-swap)


class ContinuousBatchingScheduler:
    """Admit → step → retire/backfill loop over per-model lane groups."""

    def __init__(self, model=None, n_slots: Optional[int] = None,
                 max_new_tokens: int = 32,
                 resolve: Optional[Callable[[str], str]] = None,
                 admission_policy: Optional[Callable] = None,
                 hbm_budget_bytes: Optional[int] = None):
        self.default_max_new = int(max_new_tokens)
        # optional chip-level budget: add_model refuses a group whose
        # static peak-HBM estimate would push the total past it.  The
        # reservation counter holds a group's bytes from the (locked)
        # budget check until the group registers, so two concurrent
        # add_model calls cannot both pass against the same headroom.
        self.hbm_budget_bytes = (None if hbm_budget_bytes is None
                                 else int(hbm_budget_bytes))
        self._hbm_reserved = 0
        # ONE state lock (rank table: serving.scheduler); the
        # work condition SHARES it, so `with self._work:` and
        # `with self._lock:` are the same registry node
        self._lock = OrderedLock("serving.scheduler", RANK_SCHEDULER)
        self._work = OrderedCondition(self._lock)
        self._groups: Dict[str, _LaneGroup] = {}
        self._queue: deque = deque()
        self._peak_in_flight = 0
        self._steps = 0
        self._finished: List[Request] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._draining = False
        # alias -> lane-group key, applied at admission time (and for
        # submit-time feasibility checks); identity by default.  The
        # gateway registry swaps versions by flipping what this returns.
        self.resolve: Callable[[str], str] = resolve or (lambda name: name)
        # admission_policy(candidates, active) -> Request|None picks among
        # the ADMISSIBLE queued requests; None keeps strict FIFO with
        # head-of-line blocking
        self.admission_policy = admission_policy
        # -- telemetry: labeled instruments in the shared
        # registry + per-request span timeline.  stats() stays the dict
        # view; these are the exported series a /metrics scrape reads.
        reg = _obs_metrics.registry()
        self._tracer = _obs_tracing.tracer()
        self._m_requests = reg.counter(
            "paddle_serving_requests_total",
            "Request lifecycle events (submitted/admitted/finished/"
            "failed/rejected/cancelled)", labels=("event",))
        self._m_tokens = reg.counter(
            "paddle_serving_tokens_total", "Decoded tokens emitted")
        self._m_steps = reg.counter(
            "paddle_serving_steps_total", "Lockstep scheduler steps run")
        self._h_total = reg.histogram(
            "paddle_serving_request_latency_seconds",
            "submit -> finish latency of successful requests")
        self._h_queue = reg.histogram(
            "paddle_serving_queue_latency_seconds",
            "submit -> admission latency")
        self._h_ttft = reg.histogram(
            "paddle_serving_ttft_seconds",
            "submit -> first decoded token (time-to-first-token)")
        self._h_itl = reg.histogram(
            "paddle_serving_inter_token_seconds",
            "gap between consecutive decoded tokens of one request")
        self._h_tokens_per_req = reg.histogram(
            "paddle_serving_tokens_per_request",
            "decoded tokens per finished request",
            buckets=_TOKEN_BUCKETS)
        if model is not None:
            if n_slots is None:
                raise ValueError("single-model constructor needs n_slots")
            self.add_model(DEFAULT_MODEL, model, n_slots)
        _LIVE_SCHEDULERS.add(self)
        _register_scheduler_collector()

    # -- model registry surface ----------------------------------------------
    def _hbm_committed_locked(self) -> int:
        return (sum(g.static_hbm_bytes for g in self._groups.values())
                + self._hbm_reserved)

    def hbm_committed(self) -> int:
        """Sum of the registered groups' static peak-HBM estimates
        (plus in-flight add_model reservations)."""
        with self._lock:
            return self._hbm_committed_locked()

    def can_admit_model(self, hbm_bytes: int) -> bool:
        """Would a group with this static estimate fit the budget?
        (Always true without a declared budget.)"""
        if self.hbm_budget_bytes is None:
            return True
        return self.hbm_committed() + int(hbm_bytes) \
            <= self.hbm_budget_bytes

    def add_model(self, key: str, model, n_slots: int,
                  hbm_bytes: Optional[int] = None) -> None:
        """Register a lane group for ``model`` under ``key``.  The
        group's ``open_slots`` device work runs before the group becomes
        visible, so the serve loop never steps a half-built group.
        ``hbm_bytes`` overrides the group's static peak-HBM estimate
        (default: ``model.static_hbm_estimate()`` when available); with
        a declared ``hbm_budget_bytes``, an estimate that does not fit
        raises ``HBMBudgetError`` before any lane opens.  The check and
        the registration are atomic against concurrent add_model calls:
        the estimate is reserved under the lock while the group builds."""
        reserved = 0
        if self.hbm_budget_bytes is not None:
            est = hbm_bytes
            comp = None
            if est is None:
                fn = getattr(model, "static_hbm_estimate", None)
                if callable(fn):
                    try:
                        plan = fn(assume_lanes=int(n_slots))
                    except TypeError:
                        plan = fn()
                    est = plan.peak_bytes
                    comp = dict(getattr(plan, "components", None) or {})
            est = int(est or 0)
            with self._lock:
                committed = self._hbm_committed_locked()
                if committed + est > self.hbm_budget_bytes:
                    avail = self.hbm_budget_bytes - committed
                    ax = suggest_model_axis(comp, avail)
                    hint = ("" if ax is None else
                            f" — sharding over a mesh model-axis of "
                            f"{ax} would fit per-shard; rebuild with "
                            f"mesh_axes={{'model': {ax}}}")
                    raise HBMBudgetError(
                        f"model {key!r} needs ~{est} static peak-HBM "
                        f"bytes but only {avail} of "
                        f"{self.hbm_budget_bytes} remain "
                        f"({committed} committed){hint}",
                        suggested_model_axis=ax)
                self._hbm_reserved += est
            reserved = est
            hbm_bytes = est
        try:
            group = _LaneGroup(str(key), model, n_slots,
                               hbm_bytes=hbm_bytes)
            with self._work:
                if group.key in self._groups:
                    raise ValueError(f"model {key!r} already registered")
                self._hbm_reserved -= reserved
                reserved = 0
                self._groups[group.key] = group
                self._work.notify()
        finally:
            if reserved:
                with self._lock:
                    self._hbm_reserved -= reserved

    def remove_model(self, key: str, drain: bool = True,
                     timeout: float = 30.0) -> None:
        """Unregister lane group ``key``.  ``drain=True`` first stops
        admissions into it and lets in-flight lanes finish (driving the
        loop inline when ``serve()`` is not running); lanes still active
        at the deadline are failed.  Queued requests that still resolve
        to the group are rejected at their next admission attempt."""
        with self._lock:
            group = self._groups.get(str(key))
            if group is None:
                raise KeyError(f"no model {key!r} registered")
            group.draining = True
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if not group.active:
                        break
                if self._thread is None:
                    if not self.step_once():
                        break
                else:
                    time.sleep(0.005)
        with self._lock:
            for slot, req in list(group.active.items()):
                req.error = req.error or RuntimeError(
                    f"model {key!r} unloaded while request in flight")
                self._retire_locked(group, slot, req)
            del self._groups[group.key]

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._groups)

    def _group_for(self, alias: str) -> Optional[_LaneGroup]:
        try:
            key = self.resolve(alias)
        except Exception:
            return None
        return self._groups.get(key)

    @property
    def model(self):
        """Single-model compatibility: the default lane group's model."""
        g = self._groups.get(DEFAULT_MODEL)
        return g.model if g is not None else None

    @property
    def n_slots(self) -> int:
        return sum(g.n_slots for g in self._groups.values())

    # -- submission ----------------------------------------------------------
    def submit(self, src_tokens, max_new_tokens: Optional[int] = None,
               model: str = DEFAULT_MODEL, tenant: Optional[str] = None,
               on_token: Optional[Callable] = None,
               decode: Optional[Dict] = None,
               session: Optional[str] = None) -> Request:
        with self._lock:
            group = self._group_for(model)
        if group is None:
            raise KeyError(f"submit: no model registered for {model!r}")
        src_cap = getattr(group.model, "src_len", None)
        if src_cap is not None and len(np.asarray(src_tokens)) > src_cap:
            # reject HERE, synchronously in the caller's thread — a
            # too-long prompt failing inside the serve loop would kill
            # the loop for every other in-flight request
            raise ValueError(
                f"submit: prompt length {len(np.asarray(src_tokens))} "
                f"exceeds the model's src_len {src_cap}")
        if decode is not None and \
                not getattr(group.model, "speculative_aware", False):
            if decode.get("constraint") is None \
                    and not decode.get("draft", True):
                # the same carve-out as the admit-time gate: an
                # explicit speculation OPT-OUT asks for nothing a
                # plain group cannot do — journal replay of an
                # opted-out request onto a draftless version must
                # decode plain, not fail
                decode = None
            else:
                # a decode-options request admitted into a group that
                # cannot honor them would fail inside the serve loop
                raise ValueError(
                    f"submit: model {model!r} does not support "
                    f"per-request decode options (draft/constraint "
                    f"need a speculative lane group)")
        cap = getattr(group.model, "max_out_len", self.default_max_new)
        if session is not None and not callable(
                getattr(group.model, "resume_slot", None)):
            # a sessionless group serves the request fine — it just
            # cannot suspend/resume; drop the id rather than reject so
            # journal replay onto an untiered build still decodes
            session = None
        req = Request(src_tokens,
                      min(max_new_tokens or self.default_max_new, cap),
                      model=model, tenant=tenant, on_token=on_token,
                      decode=decode, session=session)
        if group.page_aware and group.model.prompt_infeasible(
                req.src, req.max_new_tokens):
            # structurally unserveable: the prompt + decode reservation
            # exceed the WHOLE page pool — queueing it would park it at
            # the queue head forever (admission can never succeed)
            self._m_requests.labels(event="rejected").inc()
            self._tracer.instant("request/rejected", cat="serving",
                                 rid=req.rid, reason="pool_capacity")
            raise PoolCapacityError(
                f"submit: request needs more pages than the entire pool "
                f"holds (prompt {len(req.src)} tokens, max_new "
                f"{req.max_new_tokens})")
        # telemetry BEFORE the queue append: once the request is queued
        # the serve thread can admit it immediately, and the admitted
        # instant must never precede the submitted one in the trace
        self._m_requests.labels(event="submitted").inc()
        self._tracer.instant("request/submitted", cat="serving",
                             rid=req.rid, prompt_tokens=len(req.src),
                             max_new=req.max_new_tokens, model=req.model)
        with self._work:
            self._queue.append(req)
            self._work.notify()
        return req

    # -- the loop ------------------------------------------------------------
    def _finish_unadmitted_locked(self, req: Request,
                                  error: BaseException,
                                  event: str, reason: str) -> None:
        """Fail a request that never reached a lane (still queued)."""
        req.error = error
        req.finished = time.perf_counter()
        self._finished.append(req)
        req._emit(None)
        req._done.set()
        self._m_requests.labels(event=event).inc()
        self._tracer.instant(f"request/{event}", cat="serving",
                             rid=req.rid, reason=reason)

    def _pick_locked(self):
        """-> (req, group) for the next queued request to admit, or None.
        Walks the queue in submission order, rejecting dead entries
        (cancelled / unknown model / structurally infeasible prompt)
        inline.  Without an admission policy the head blocks the line
        (backpressure); with one, every admissible
        request is a candidate and the policy picks."""
        candidates = []
        for req in list(self._queue):
            if req.cancelled:
                self._queue.remove(req)
                self._finish_unadmitted_locked(
                    req, RequestCancelled("cancelled before admission"),
                    "cancelled", "cancelled")
                continue
            group = self._group_for(req.route_to or req.model)
            if (group is None or group.draining) \
                    and req.route_to is not None:
                # the pinned canary target is gone (rolled back or
                # unloaded): fall back to the alias — the request must
                # survive the canary, not die with it
                req.route_to = None
                group = self._group_for(req.model)
            if group is None or group.draining:
                self._queue.remove(req)
                self._finish_unadmitted_locked(
                    req, KeyError(f"no model registered for "
                                  f"{req.model!r}"),
                    "rejected", "unknown_model")
                continue
            if req.decode is not None and not getattr(
                    group.model, "speculative_aware", False):
                if req.decode.get("constraint") is None \
                        and not req.decode.get("draft", True):
                    # an explicit speculation OPT-OUT ({"draft": False},
                    # no grammar) that a swap re-routed to a plain
                    # group: plain decode is exactly what was asked —
                    # admit it plain instead of rejecting
                    req.decode = None
                else:
                    # the request carries decode options (grammar/
                    # draft) its resolved group cannot honor — a canary
                    # pin or a hot swap re-pointed the alias at a plain
                    # generator AFTER the submit-time check.  Silently
                    # admitting would serve a grammar-constrained
                    # request unconstrained; reject it loudly instead.
                    self._queue.remove(req)
                    self._finish_unadmitted_locked(
                        req, ValueError(
                            f"model {req.model!r} no longer serves "
                            f"with decode options (draft/constraint) — "
                            f"the serving group changed under the "
                            f"request"),
                        "rejected", "decode_unsupported")
                    continue
            if group.page_aware and group.model.prompt_infeasible(
                    req.src, req.max_new_tokens):
                # reject-with-error, never hang: this prompt can NEVER
                # fit, so park-at-head would starve the whole queue
                self._queue.remove(req)
                self._finish_unadmitted_locked(
                    req, PoolCapacityError(
                        "prompt + decode reservation exceed the entire "
                        "page pool"),
                    "rejected", "pool_capacity")
                continue
            blocked = not group.free or (
                group.page_aware and not group.model.can_admit(
                    req.src, req.max_new_tokens))
            if not blocked:
                if self.admission_policy is None:
                    return req, group
                candidates.append((req, group))
            elif self.admission_policy is None:
                # pool/slots momentarily full: stay queued; the next
                # retirement frees capacity and re-runs admission
                return None
        if not candidates:
            return None
        active = [r for g in self._groups.values()
                  for r in g.active.values()]
        pool = candidates
        while pool:
            chosen = self.admission_policy([r for r, _ in pool], active)
            entry = next(((r, g) for r, g in pool if r is chosen), None)
            if entry is None:
                return None
            r, g = entry
            if r.route_to is not None:
                # the policy may have pinned the request during this
                # very pick (canary slicing): honor the new target when
                # it can admit right now
                g2 = self._group_for(r.route_to)
                if g2 is None or g2.draining:
                    # pinned to a group that vanished between the walk
                    # and the pick: fall back to the alias group
                    r.route_to = None
                    g2 = g
                if g2 is not g:
                    blocked = (not g2.free
                               or (g2.page_aware
                                   and not g2.model.can_admit(
                                       r.src, r.max_new_tokens)))
                    if blocked:
                        # the pinned target is full: keep the request
                        # queued (the pin is durable) but let the
                        # policy pick among the REST of this round's
                        # candidates — a saturated canary group must
                        # not block admission into free stable slots
                        pool = [(rr, gg) for rr, gg in pool
                                if rr is not r]
                        continue
                    g = g2
            return r, g
        return None

    def _admit_pending(self) -> int:
        """Admit queued requests into free slots.  The model's prefill
        dispatch runs OUTSIDE the lock (only the loop thread touches the
        model), so concurrent submit() callers never stall behind a
        device dispatch."""
        admitted = 0
        while True:
            with self._lock:
                if self._draining:
                    return admitted
                picked = self._pick_locked()
                if picked is None:
                    return admitted
                req, group = picked
                self._queue.remove(req)
                slot = group.free.pop()
            try:
                resumed_max_new = None
                if getattr(group.model, "speculative_aware", False):
                    s_true = group.model.admit_slot(
                        slot, req.src, max_new=req.max_new_tokens,
                        decode=req.decode)
                elif group.page_aware:
                    s_true = None
                    if req.session is not None and callable(
                            getattr(group.model, "resume_slot", None)):
                        # session resume first (device h2d upload —
                        # correctly OUTSIDE the lock, like prefill); any
                        # miss (unknown/corrupt/stale artifact, pool
                        # pressure) degrades to a fresh prefill of the
                        # same prompt — greedy decode is deterministic,
                        # so degrading costs latency, never wrong tokens
                        got = group.model.resume_slot(
                            slot, req.session,
                            max_new=req.max_new_tokens)
                        if got is not None:
                            s_true = got["s_true"]
                            resumed_max_new = got["max_new"]
                            req.resumed = True
                    if s_true is None:
                        s_true = group.model.admit_slot(
                            slot, req.src, max_new=req.max_new_tokens)
                else:
                    s_true = group.model.admit_slot(slot, req.src)
            except BaseException as e:
                # fail THIS request, give the slot back, keep serving —
                # one bad prompt must not leak capacity or kill the loop
                with self._lock:
                    group.free.append(slot)
                    req.error = e
                    req.finished = time.perf_counter()
                    self._finished.append(req)
                req._emit(None)
                req._done.set()
                self._m_requests.labels(event="failed").inc()
                self._tracer.instant("request/admit_failed",
                                     cat="serving", rid=req.rid,
                                     error=type(e).__name__)
                continue
            with self._lock:
                if self._groups.get(group.key) is not group \
                        or group.draining:
                    # the group was torn down (or began draining)
                    # while this admission's prefill dispatch ran
                    # OUTSIDE the lock — a hot swap or unload raced
                    # us.  Before this check the request was silently
                    # orphaned: parked in a group the step loop no
                    # longer iterates, never stepped, never failed
                    # It has produced no tokens, so give the lane
                    # state back and RE-QUEUE it at the head: the next
                    # admission round re-resolves its alias — the new
                    # version after a swap (zero lost), the normal
                    # rejected-at-admission path after a plain unload.
                    if group.page_aware:
                        try:
                            group.model.clear_slot(slot)
                        except Exception:
                            pass
                    group.free.append(slot)
                    req.resumed = False
                    self._queue.appendleft(req)
                    continue
                req.slot = slot
                req.group = group.key
                if resumed_max_new is not None:
                    # the resumed lane's self-KV table is sized for the
                    # recorded position + this continuation: the retire
                    # cap must not outrun it
                    req.max_new_tokens = min(req.max_new_tokens,
                                             resumed_max_new)
                req.admitted = time.perf_counter()
                group.active[slot] = req
                in_flight = sum(len(g.active)
                                for g in self._groups.values())
                self._peak_in_flight = max(self._peak_in_flight,
                                           in_flight)
                group.tokens[slot] = group.model.start_id
                group.pos[slot] = 0
                group.src_len[slot] = s_true
            self._m_requests.labels(event="admitted").inc()
            self._h_queue.observe(req.admitted - req.submitted)
            self._tracer.instant("request/admitted", cat="serving",
                                 rid=req.rid, slot=slot, model=group.key,
                                 resumed=req.resumed)
            admitted += 1

    def _retire_locked(self, group: _LaneGroup, slot: int,
                       req: Request) -> None:
        # no device work in here (submit() blocks on this lock): the
        # lane's caches stay stale until the next admit_slot, which
        # re-zeroes them before use — lanes are row-independent, so a
        # stale lane decoding garbage contaminates nothing.  Page-aware
        # models DO free their pages here (host-side bookkeeping only):
        # "retire frees pages immediately" is what lets the very next
        # admission round backfill under page pressure — and what makes
        # cancellation release a mid-prefill lane's pages at once.
        req.finished = time.perf_counter()
        del group.active[slot]
        if group.page_aware:
            detached = False
            if req.session is not None and req.error is None:
                # session retire SUSPENDS instead of destroys: the
                # lane's page refs move to a pending-suspend record
                # (bookkeeping only — legal under this lock); the d2h
                # spill + artifact store run later in tier_maintenance,
                # off the lock.  Any failure degrades to the plain
                # destroy path below.
                try:
                    detached = bool(getattr(
                        group.model, "detach_slot",
                        lambda *_: False)(slot, req.session))
                except BaseException:
                    detached = False
            if not detached:
                try:
                    group.model.clear_slot(slot)
                except BaseException as e:  # pragma: no cover - belt and
                    req.error = req.error or e  # braces; keep the slot
        group.tokens[slot] = group.model.start_id
        group.pos[slot] = 0
        group.src_len[slot] = 1
        group.free.append(slot)
        self._finished.append(req)
        req._emit(None)
        req._done.set()
        ok = req.error is None
        event = ("finished" if ok else
                 "cancelled" if isinstance(req.error, RequestCancelled)
                 else "failed")
        self._m_requests.labels(event=event).inc()
        if ok:
            self._h_total.observe(req.finished - req.submitted)
            self._h_tokens_per_req.observe(len(req.tokens))
        self._tracer.instant("request/retired", cat="serving",
                             rid=req.rid, slot=slot,
                             tokens=len(req.tokens), ok=ok)
        # the whole-request span, stamped from the Request's own marks —
        # one bar per request in the Chrome-trace view, submit to retire
        self._tracer.complete("request", req.submitted, req.finished,
                              cat="serving", rid=req.rid,
                              tokens=len(req.tokens), ok=ok)

    def _reap_cancelled_locked(self) -> None:
        """Retire cancelled in-flight requests BEFORE the next dispatch:
        the lane (and, page-aware, its pages — including a lane still
        mid-prefill) frees immediately rather than decoding to the cap."""
        for group in self._groups.values():
            for slot, req in list(group.active.items()):
                if req.cancelled:
                    req.error = req.error or RequestCancelled(
                        "cancelled in flight")
                    self._retire_locked(group, slot, req)

    def _note_token(self, req: Request, tok: int) -> None:
        """Per-token telemetry (called under the lock, right after the
        token was appended): TTFT on the first token, inter-token gap on
        the rest, and one ``request/token`` trace instant — token
        instants per rid reconstruct the exact decode timeline (the
        test asserts count == len(req.tokens))."""
        now = time.perf_counter()
        if req.first_token is None:
            req.first_token = now
            self._h_ttft.observe(now - req.submitted)
        else:
            self._h_itl.observe(now - req.last_token)
        req.last_token = now
        self._m_tokens.inc()
        req._emit(tok)
        self._tracer.instant("request/token", cat="serving", rid=req.rid,
                             index=len(req.tokens))

    def _step_group(self, group: _LaneGroup, snap) -> None:
        """One lockstep dispatch over ``group``'s lanes + retirement."""
        if group.managed:
            # self-managed model: one dispatch interleaves chunked
            # prefill and decode over every lane; only lanes that
            # actually emitted come back.  A speculative model
            # returns a LIST of tokens per lane — the accepted
            # draft prefix plus the target's own next token — delivered
            # one by one so streaming, telemetry, end-of-sequence and
            # the max_new cap see the exact per-token sequence a plain
            # model would have produced (tokens past the end/cap in the
            # same round are dropped, as a plain model would never have
            # decoded them).
            try:
                with self._tracer.span("scheduler/step", cat="serving",
                                       managed=True, model=group.key):
                    emitted = group.model.lane_step()
            except BaseException as e:
                self._fail_group(group, e)
                return
            with self._lock:
                self._steps += 1
                self._m_steps.inc()
                for slot, toks in emitted.items():
                    req = group.active.get(slot)
                    if req is None:
                        continue
                    seq = toks if isinstance(toks, (list, tuple,
                                                    np.ndarray)) \
                        else [toks]
                    for tok in seq:
                        req.tokens.append(int(tok))
                        self._note_token(req, int(tok))
                        if int(tok) == group.model.end_id or \
                                len(req.tokens) >= req.max_new_tokens:
                            self._retire_locked(group, slot, req)
                            break
            return
        tokens, pos, src_len = snap
        try:
            with self._tracer.span("scheduler/step", cat="serving",
                                   managed=False, model=group.key):
                nxt = group.model.step_slots(tokens, pos, src_len)
        except BaseException as e:
            self._fail_group(group, e)
            return
        with self._lock:
            self._steps += 1
            self._m_steps.inc()
            for slot, req in list(group.active.items()):
                tok = int(nxt[slot])
                req.tokens.append(tok)
                self._note_token(req, tok)
                group.tokens[slot] = tok
                group.pos[slot] += 1
                if tok == group.model.end_id or \
                        len(req.tokens) >= req.max_new_tokens:
                    self._retire_locked(group, slot, req)

    def step_once(self) -> bool:
        """Admit what fits, run ONE lockstep decode step per lane group
        with active lanes, retire finished lanes.  Returns False when
        there was nothing to do."""
        self._admit_pending()
        with self._lock:
            self._reap_cancelled_locked()
            work = []
            maint = []
            for group in self._groups.values():
                if group.managed and callable(
                        getattr(group.model, "tier_maintenance", None)):
                    # snapshot the next queued prompt bound for this
                    # group so the maintenance slice (outside the lock)
                    # can prefetch its demoted prefix chunks back to HBM
                    # during the admission gap
                    pre = None
                    for req in self._queue:
                        if not req.cancelled and self._group_for(
                                req.route_to or req.model) is group:
                            pre = req.src
                            break
                    maint.append((group, pre))
                if not group.active:
                    continue
                snap = None if group.managed else (
                    group.tokens.copy(), group.pos.copy(),
                    group.src_len.copy())
                work.append((group, snap))
            if not work and not maint:
                return False
        busy = bool(work)
        for group, snap in work:
            self._step_group(group, snap)
        # the off-lock tier slice, AFTER stepping: pending suspends
        # spill to host/disk, queued-prompt chunks prefetch back, free
        # pages top up to the demote watermark.  Counted as progress so
        # the loop (and drain) keeps running until suspends complete.
        for group, pre in maint:
            try:
                if group.model.tier_maintenance(prefetch=pre):
                    busy = True
            except BaseException:           # pragma: no cover - belt and
                pass                        # braces; never kill the loop
        return busy

    def _fail_group(self, group: _LaneGroup, exc: BaseException) -> None:
        """A step dispatch failed: fail every in-flight request of that
        lane group with the error (their cache lanes are in an unknown
        state), free the slots, and keep the loop alive."""
        with self._lock:
            for slot, req in list(group.active.items()):
                req.error = exc
                self._retire_locked(group, slot, req)

    def _fail_in_flight(self, exc: BaseException) -> None:
        """Fail every in-flight request across all lane groups."""
        with self._lock:
            for group in self._groups.values():
                for slot, req in list(group.active.items()):
                    req.error = exc
                    self._retire_locked(group, slot, req)

    def run_until_idle(self, max_steps: Optional[int] = None) -> int:
        """Drive the loop inline until queue and slots drain; returns the
        number of decode steps executed."""
        steps = 0
        while self.step_once():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    # -- threaded serving ----------------------------------------------------
    def serve(self) -> "ContinuousBatchingScheduler":
        """Start the admit/step loop on a daemon thread; returns self."""
        if self._thread is not None:
            raise RuntimeError("serve() already running")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    busy = self.step_once()
                except BaseException as e:     # pragma: no cover - belt
                    # and braces: step_once contains model failures
                    # itself; anything else must not silently kill the
                    # serving thread and strand every waiter
                    self._fail_in_flight(e)
                    busy = True
                if not busy:
                    with self._work:
                        if not self._queue and not any(
                                g.active for g in self._groups.values()):
                            self._work.wait(timeout=0.05)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-scheduler")
        self._thread.start()
        return self

    def shutdown(self, timeout: float = 5.0,
                 drain: bool = False) -> List[Request]:
        """Stop the serve loop.  Default (``drain=False``) is the
        immediate behavior: the thread stops at the next step
        boundary, in-flight lanes are simply abandoned (their waiters
        keep waiting — callers that want clean completion use drain).

        ``drain=True``: stop admitting, let every
        in-flight lane decode to completion (driving the loop inline
        when ``serve()`` was never started), join the thread, then fail
        any still-queued request with ``SchedulerShutdown``.  Returns
        the failed queued requests so a gateway can resubmit their
        journal entries after a restart."""
        leftovers: List[Request] = []
        if drain:
            deadline = time.monotonic() + timeout
            with self._lock:
                self._draining = True
            while time.monotonic() < deadline:
                with self._lock:
                    busy = any(g.active for g in self._groups.values())
                if not busy:
                    break
                if self._thread is None:
                    if not self.step_once():
                        break
                else:
                    time.sleep(0.005)
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if drain:
            with self._lock:
                while self._queue:
                    req = self._queue.popleft()
                    self._finish_unadmitted_locked(
                        req, SchedulerShutdown(
                            "scheduler shut down before admission"),
                        "rejected", "shutdown")
                    leftovers.append(req)
                self._draining = False
        return leftovers

    # -- accounting ----------------------------------------------------------
    def queued_requests(self) -> List[Request]:
        """Snapshot of the waiting queue in submission order (the
        router's per-tenant queue-depth source)."""
        with self._lock:
            return list(self._queue)

    def active_requests(self) -> List[Request]:
        with self._lock:
            return [r for g in self._groups.values()
                    for r in g.active.values()]

    def finished_requests(self) -> List[Request]:
        """Every retired/rejected request so far (the gateway's
        per-tenant latency-percentile source)."""
        with self._lock:
            return list(self._finished)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            done = list(self._finished)
            in_flight = sum(len(g.active) for g in self._groups.values())
            out: Dict[str, object] = {
                "steps": self._steps,
                "finished": len(done),
                "queued": len(self._queue),
                "in_flight": in_flight,
                "peak_in_flight": self._peak_in_flight,
            }
            groups = list(self._groups.values())
        out["failed"] = sum(1 for r in done if r.error is not None)
        out["cancelled"] = sum(1 for r in done
                               if isinstance(r.error, RequestCancelled))
        if len(groups) > 1 or (groups and groups[0].key != DEFAULT_MODEL):
            out["models"] = {
                g.key: {"n_slots": g.n_slots, "in_flight": len(g.active),
                        "free": len(g.free), "draining": g.draining,
                        "static_hbm_bytes": g.static_hbm_bytes}
                for g in groups}
        if self.hbm_budget_bytes is not None:
            out["hbm"] = {
                "budget_bytes": self.hbm_budget_bytes,
                "committed_bytes": sum(g.static_hbm_bytes
                                       for g in groups),
            }
        default = self._groups.get(DEFAULT_MODEL)
        if default is not None and default.page_aware \
                and hasattr(default.model, "page_bytes"):
            # capacity in BYTES, not just pages: int8 pools shrink
            # page_bytes, so the same HBM budget holds more
            # pages — surfaced here so a capacity report never re-derives
            # the bytes/slot math per kv_dtype
            model = default.model
            out["kv"] = {
                "kv_dtype": getattr(model, "kv_dtype", "float32"),
                "page_bytes": model.page_bytes,
                "pool_bytes": model.page_bytes * model.num_pages,
                # ALWAYS a float: the dashboard
                # schema divides by this key unconditionally — a model
                # without the accessor reports 0.0, never a missing key
                # or None
                "kv_bytes_per_token": (
                    float(model.kv_bytes_per_token())
                    if hasattr(model, "kv_bytes_per_token")
                    else 0.0),
            }
            alloc = getattr(model, "alloc", None)
            if alloc is not None and hasattr(alloc, "stats"):
                ast = alloc.stats()
                gts = getattr(model, "_tier_stats", {})
                out["kv"]["tiers"] = {
                    "hbm_pages": int(getattr(model, "num_pages", 0)),
                    "hbm_pages_in_use": int(ast.get("in_use", 0)),
                    "host_pages": int(ast.get("host_pages", 0)),
                    "host_pages_used": int(ast.get("host_pages_used",
                                                   0)),
                    "host_chunks": int(ast.get("host_chunks", 0)),
                }
                out["kv"]["spills"] = {
                    "demotes": int(ast.get("demotes", 0)),
                    "promotes": int(ast.get("promotes", 0)),
                    "host_evictions": int(ast.get("host_evictions", 0)),
                    "spilled_bytes": int(ast.get("spilled_bytes", 0)),
                    "fetched_bytes": int(ast.get("fetched_bytes", 0)),
                    "suspends": int(gts.get("suspends", 0)),
                    "suspend_drops": int(gts.get("suspend_drops", 0)),
                    "resumes": int(gts.get("resumes", 0)),
                    "resume_misses": int(gts.get("resume_misses", 0)),
                    "prefetches": int(gts.get("prefetches", 0)),
                    "eager_demotes": int(gts.get("eager_demotes", 0)),
                }
            if hasattr(model, "shard_plan"):
                # mesh shape + per-shard pool residency for /statusz
                out["kv"]["shard"] = model.shard_plan()
        # latency percentiles cover successfully served requests only (a
        # request failed at admission has no admitted timestamp)
        ok = [r for r in done if r.error is None]
        if ok:
            total = np.asarray([r.total_latency for r in ok])
            queued = np.asarray([r.queue_latency for r in ok])
            toks = sum(len(r.tokens) for r in ok)
            span = (max(r.finished for r in ok)
                    - min(r.submitted for r in ok)) or 1e-9
            out.update({
                "p50_latency_s": round(float(np.percentile(total, 50)), 4),
                "p95_latency_s": round(float(np.percentile(total, 95)), 4),
                "p50_queue_s": round(float(np.percentile(queued, 50)), 4),
                "decoded_tokens": toks,
                "decoded_tok_per_s": round(toks / span, 2),
            })
            # percentiles from the per-token span
            # marks (first_token/last_token are what the request/token
            # trace instants are stamped from) — TTFT and tail latency
            # the end-to-end numbers above cannot express.  Existing
            # keys stay untouched.
            out["p99_latency_s"] = round(float(np.percentile(total, 99)),
                                         4)
            ttft = np.asarray([r.first_token - r.submitted for r in ok
                               if r.first_token is not None])
            if ttft.size:
                out["ttft_p50_s"] = round(float(np.percentile(ttft, 50)),
                                          4)
                out["ttft_p95_s"] = round(float(np.percentile(ttft, 95)),
                                          4)
            ntok = np.asarray([len(r.tokens) for r in ok])
            out["tokens_per_request"] = {
                "p50": round(float(np.percentile(ntok, 50)), 2),
                "p95": round(float(np.percentile(ntok, 95)), 2),
                "max": int(ntok.max()),
            }
        return out
