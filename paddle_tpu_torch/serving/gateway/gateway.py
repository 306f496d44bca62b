"""Gateway: the front door tying registry + router + scheduler together;
the port's copy of ``paddle_tpu/serving/gateway/gateway.py``.

One ``Gateway`` owns:

* a ``ModelRegistry`` (versioned model instances + alias map),
* a ``TenantRouter`` (rate limits, SLO preemption, fair share),
* ONE multi-model ``ContinuousBatchingScheduler`` whose ``resolve``
  hook is the registry's alias map and whose ``admission_policy`` is
  the router,
* an optional ``RequestJournal`` — every accepted request is journaled
  before it queues and marked done when it retires, so a supervised
  restart replays the incomplete tail with
  ``recover()`` instead of dropping it.

Request flow: ``submit`` debits the tenant's token bucket (RateLimited
= HTTP 429 before any queueing), journals, then enqueues with the
model ALIAS — version resolution happens at admission, which is what
lets ``swap_model`` flip mid-traffic with zero lost requests.

Token streaming (``submit_stream``): a ``TokenStream`` iterator yields
tokens as decode steps retire them, riding the scheduler's per-token
callback (the same marks the scheduler's span timeline stamps).  Closing the
stream — or a client disconnect in the HTTP layer — cancels the
request: the lane and (paged models) its pages free at the next step
boundary, mid-prefill included."""

from __future__ import annotations

import contextlib
import os as _os
import queue as _queue
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from ...observability import metrics as _obs_metrics
from ...resilience.chaos import injector as _chaos_injector
from ...utils.sync import RANK_GATEWAY_WEDGE, OrderedLock
from ..scheduler import (ContinuousBatchingScheduler, Request,
                         RequestCancelled, SchedulerShutdown)
from .journal import RequestJournal
from .registry import ModelRegistry
from .router import TenantRouter

__all__ = ["Gateway", "GatewayDraining", "TokenStream"]


class GatewayDraining(RuntimeError):
    """Submit refused: the gateway is draining toward shutdown .  HTTP layer maps this to 503 + ``Retry-After`` — the client
    (or the fleet router) retries on another replica instead of
    queueing work here that drain would only hand back as failed."""

    retry_after = 2.0


class TokenStream:
    """Iterator over one streaming request's tokens.

    Yields each decoded token as the scheduler retires its step; raises
    the request's error (if it failed) after the last token; supports
    ``close()`` — also triggered by ``with`` exit and generator
    teardown — which CANCELS the request, freeing its lane and pages
    immediately."""

    _DONE = object()

    def __init__(self, request: Optional[Request] = None,
                 timeout: float = 60.0):
        # the queue exists BEFORE the request does: the serve thread can
        # emit tokens between sched.submit() returning and the stream
        # object being handed back, and none may be lost — submit_stream
        # builds the stream first and binds the request after
        self.request = request
        self.timeout = float(timeout)
        self._q: "_queue.Queue" = _queue.Queue()

    # the scheduler-side callback (runs under the scheduler lock: a
    # lock-free enqueue is all that happens here)
    def _push(self, req: Request, tok: Optional[int]) -> None:
        self._q.put(self._DONE if tok is None else int(tok))

    def __iter__(self) -> Iterator[int]:
        return self

    def __next__(self) -> int:
        if self.request.done and self._q.empty():
            self._finish()
        try:
            item = self._q.get(timeout=self.timeout)
        except _queue.Empty:
            raise TimeoutError(
                f"stream: no token for {self.timeout}s "
                f"(rid {self.request.rid})")
        if item is self._DONE:
            self._finish()
        return item

    def _finish(self):
        err = self.request.error
        if err is not None and not isinstance(err, RequestCancelled):
            raise err
        raise StopIteration

    def close(self) -> None:
        """Cancel the request if it is still running (client went away:
        its lane and pages must not keep decoding for nobody)."""
        if not self.request.done:
            self.request.cancel()

    def __enter__(self) -> "TokenStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class Gateway:
    """Multi-model, multi-tenant serving front door."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 router: Optional[TenantRouter] = None,
                 n_slots: int = 4, max_new_tokens: int = 32,
                 journal_path: Optional[str] = None,
                 journal_fsync: bool = False,
                 check_invariants: bool = False):
        self.registry = registry or ModelRegistry()
        self.router = router or TenantRouter()
        self.default_n_slots = int(n_slots)
        self.sched = ContinuousBatchingScheduler(
            max_new_tokens=max_new_tokens,
            resolve=self.registry.resolve,
            admission_policy=self.router.admission_policy)
        self.router.bind(lambda: self.sched.n_slots,
                         self.sched.queued_requests)
        self.journal = (RequestJournal(journal_path, fsync=journal_fsync)
                        if journal_path else None)
        # PageAllocator.check_invariants after every retirement — the
        # steady-state leak tripwire the cancellation tests run under
        self.check_invariants = bool(check_invariants)
        # ranked BELOW the scheduler: _swap_guard holds it across
        # add/remove_model (which take the scheduler lock); wedged()
        # deliberately reads sched.stats() BEFORE taking it
        self._wedge_lock = OrderedLock("gateway.wedge",
                                       RANK_GATEWAY_WEDGE)
        self._wedge_mark = (0, time.monotonic())
        # >0 while a load/swap is warming a new version: the compile
        # legitimately freezes the step counter, and wedged() must not
        # read that as a stall (restarting the process for every swap
        # would turn each deploy into an outage)
        self._swapping = 0
        # externally visible drain state: set the moment
        # shutdown(drain=True) begins, cleared by serve().  submit()
        # refuses with GatewayDraining while it is up, and /readyz
        # reports not-ready — the fleet router's rotation signal.
        self._draining = False
        reg = _obs_metrics.registry()
        self._m_requests = reg.counter(
            "paddle_gateway_requests_total",
            "Gateway request lifecycle by tenant/model/version",
            labels=("tenant", "model", "version", "event"))
        self._m_tokens = reg.counter(
            "paddle_gateway_tokens_total",
            "Tokens streamed/delivered per tenant and model",
            labels=("tenant", "model"))
        self._h_latency = reg.histogram(
            "paddle_gateway_request_latency_seconds",
            "submit -> finish per tenant SLO class",
            labels=("tenant", "slo"))
        # per-VERSION latency: the release controller's
        # canary verdict differences this series between marks to price
        # the candidate's p95 against the stable version's, live
        self._h_version_latency = reg.histogram(
            "paddle_gateway_version_latency_seconds",
            "submit -> finish latency per served model version",
            labels=("model", "version"))

    # -- model lifecycle -----------------------------------------------------
    def drop_version_series(self, name: str, version: str) -> None:
        """Retire an unloaded version's per-version metric children —
        without this, a continual-publish release loop leaks one
        latency histogram + request-counter set per candidate it ever
        served, forever (the registry keeps children until told
        otherwise).  Called on every unload path; the release
        controller calls it when it drains a version itself."""
        self._h_version_latency.remove_matching(model=name,
                                                version=str(version))
        # request-counter children label model with what was SUBMITTED:
        # the bare alias for routed traffic, the pinned key for probes
        for label in (name, f"{name}@{version}"):
            self._m_requests.remove_matching(model=label,
                                             version=str(version))

    @contextlib.contextmanager
    def _swap_guard(self):
        """Mark a model load/swap in progress for wedged()."""
        with self._wedge_lock:
            self._swapping += 1
        try:
            yield
        finally:
            with self._wedge_lock:
                self._swapping -= 1

    def _warm(self, key: str, n_slots: int) -> None:
        """Resolve the new version's step signatures BEFORE it takes
        traffic (on the card: each one's eager first step and CUDA graph
        capture, the kernel libraries loaded from the artifact's
        ``compiled/`` cache where it ships them): a paged generator runs
        one tiny admit/lane_step cycle AT THE SERVING LANE COUNT (the
        unified program's batch dimension is the lane count — warming at
        any other width would capture a shape serving never uses and
        still pay the real capture on the first request); an engine
        uploads its weights.  After this,
        steady state must add zero executable-cache misses — the
        ``recompiles_after_warmup == 0`` contract across a swap."""
        inst = self.registry.instance(key)
        if getattr(inst, "speculative_aware", False):
            # speculative pair: resolve the draft, verify,
            # and COW executables at the serving lane count with
            # all-idle dispatches — the generic admit/lane_step warm
            # below would only exercise the verify program
            inst.aot_warm(n_slots)
            return
        if hasattr(inst, "lane_step"):
            inst.open_slots(n_slots)
            prompt = np.full(min(2, getattr(inst, "src_len", 2)),
                             inst.start_id, np.int64)
            inst.admit_slot(0, prompt, max_new=1)
            for _ in range(64):          # bounded: prefill chunks + 1
                if inst.lane_step():
                    break
            inst.clear_slot(0)
        elif hasattr(inst, "warmup") and getattr(inst, "feed_names", None):
            # engines need a shaped sample; without one we at least
            # upload the weights so the first request pays no H2D.
            inst.place_weights()
            # when the artifact SHIPS a compiled bucket set (the
            # registry-mounted compiled/ cache with entries), resolve
            # it now — each signature's plan and kernel libraries load
            # from disk, so the first real request of those buckets
            # pays zero compiles.  A cold
            # cache keeps the old lazy behavior, and stop_on_compile
            # bounds a PARTIALLY-shipped set to at most one synchronous
            # compile (the rest stay lazy): pre-compiling every bucket
            # at load time would turn load_model into the compile
            # storm this cache exists to kill.
            aot = getattr(getattr(inst, "exe", None), "_aot_cache",
                          lambda: None)()
            if callable(getattr(inst, "preresolve", None)) \
                    and aot is not None and aot.keys():
                try:
                    inst.preresolve(stop_on_compile=True)
                except ValueError:
                    pass    # open bucket set — nothing enumerable

    def load_model(self, name: str, version: str,
                   dirname: Optional[str] = None,
                   n_slots: Optional[int] = None, warm: bool = True,
                   instance=None, draft_model: Optional[str] = None,
                   draft_version: Optional[str] = None,
                   speculate_k: int = 4, **overrides) -> str:
        """Load a version and register its lane group; the first version
        of a model becomes the alias target and starts taking traffic
        immediately.  ``draft_model``/``draft_version``
        attach a draft generator artifact: the group serves as a
        ``SpeculativeGenerator`` (k = ``speculate_k``), budgeted
        jointly and warmed across its draft/verify/cow executables."""
        if instance is not None:
            if draft_model is not None or draft_version is not None:
                # refuse, don't silently drop: an adopted instance is
                # used as-is (wrap it in a SpeculativeGenerator before
                # registering if you want a draft attached)
                raise ValueError(
                    "load_model: draft_model/draft_version do not "
                    "apply to instance= loads — pass a "
                    "SpeculativeGenerator instance instead")
            key = self.registry.register(name, version, instance)
        elif draft_model is not None:
            if draft_version is None:
                raise ValueError("load_model: draft_model needs "
                                 "draft_version")
            draft_dirname = overrides.pop("draft_dirname", None)
            if overrides:
                # the plain path applies manifest overrides; the
                # speculative loader does not — refusing beats
                # silently loading (and budgeting) a config the
                # operator never asked for
                raise ValueError(
                    f"load_model: overrides {sorted(overrides)} are "
                    f"not supported with draft_model — bake them into "
                    f"the artifact manifests")
            key = self.registry.load_speculative(
                name, version, draft_model, draft_version,
                k=speculate_k, dirname=dirname,
                draft_dirname=draft_dirname)
        else:
            key = self.registry.load(name, version, dirname=dirname,
                                     **overrides)
        try:
            with self._swap_guard():
                if warm:
                    self._warm(key, n_slots or self.default_n_slots)
                inst = self.registry.instance(key)
                if callable(getattr(inst, "open_slots", None)):
                    self.sched.add_model(key, inst,
                                         n_slots or self.default_n_slots)
        except BaseException:
            # a failed warm/add must not leak registry budget
            try:
                self.registry.unload(key)
            except Exception:
                pass
            raise
        return key

    def swap_model(self, name: str, version: str,
                   dirname: Optional[str] = None,
                   n_slots: Optional[int] = None,
                   drain_timeout: float = 30.0, instance=None,
                   **overrides) -> str:
        """Zero-downtime hot swap: load + warm the new version BESIDE
        the old one (both briefly budgeted), atomically flip the alias
        so queued and new requests resolve to it, then drain the old
        version's in-flight lanes and unload it — its pages and scope
        free with the instance.  In-flight requests on the old version
        run to completion: preemption never happens mid-request."""
        old_key = self.registry.current_key(name)
        new_key = self.load_model(name, version, dirname=dirname,
                                  n_slots=n_slots, warm=True,
                                  instance=instance, **overrides)
        try:
            # chaos point: a seeded mid-swap "crash" — the
            # new version is loaded and warmed but NOT yet aliased
            _chaos_injector().maybe_fail("gateway.swap")
        except BaseException:
            # unwind the orphan so the in-process survivor matches the
            # real-crash case: the old version keeps serving, nothing
            # routes to (or budgets for) the half-swapped one
            try:
                self.sched.remove_model(new_key, drain=False)
            except Exception:
                pass
            try:
                self.registry.unload(new_key)
            except Exception:
                pass
            raise
        self.registry.set_alias(name, version)
        if old_key is not None and old_key != new_key:
            with self._swap_guard():
                self.sched.remove_model(old_key, drain=True,
                                        timeout=drain_timeout)
                self.registry.unload(old_key)
            self.drop_version_series(name, old_key.split("@", 1)[-1])
        return new_key

    def unload_model(self, name_or_key: str,
                     drain_timeout: float = 30.0) -> None:
        key = self.registry.resolve(name_or_key)
        # validate BEFORE touching lanes: a registry refusal (alias
        # target with other versions loaded) after remove_model would
        # leave an alias pointing at a group that no longer exists
        self.registry.check_unload(key)
        self.sched.remove_model(key, drain=True, timeout=drain_timeout)
        self.registry.unload(key)
        name, _, version = key.partition("@")
        if version:
            self.drop_version_series(name, version)

    def models(self) -> List[Dict[str, object]]:
        return self.registry.entries()

    # -- request path --------------------------------------------------------
    def _wrap_on_token(self, jid: Optional[str], slo: str, inst,
                       user_cb=None):
        """Compose journal completion + gateway metrics + the caller's
        callback into the scheduler's per-token hook."""

        def on_token(req: Request, tok: Optional[int]) -> None:
            tenant = req.tenant or "default"
            if tok is not None:
                self._m_tokens.labels(tenant=tenant, model=req.model
                                      ).inc()
            else:
                # a request that never reached a lane has no group; a
                # canary-pinned one still names its target in route_to —
                # without this, a candidate whose admission dispatch
                # fails would error under version="unresolved" and the
                # release controller's error-rate gate would never see it
                target = req.group or req.route_to or "@unresolved"
                version = target.split("@", 1)[-1]
                ok = req.error is None
                event = ("finished" if ok else
                         "cancelled"
                         if isinstance(req.error, RequestCancelled)
                         else "failed")
                self._m_requests.labels(
                    tenant=tenant, model=req.model, version=version,
                    event=event).inc()
                if ok and req.total_latency is not None:
                    self._h_latency.labels(tenant=tenant, slo=slo
                                           ).observe(req.total_latency)
                    self._h_version_latency.labels(
                        model=req.model.split("@", 1)[0],
                        version=version).observe(req.total_latency)
                if self.journal is not None and jid is not None \
                        and not isinstance(req.error, SchedulerShutdown):
                    # SchedulerShutdown = drain stopped before this
                    # request was served; leave its journal entry OPEN
                    # so the work survives the process — a restart's
                    # recover() or the fleet router's migration replays
                    # it (closing it here is how a drain used to lose
                    # every queued request)
                    self.journal.record_done(
                        jid, ok=ok,
                        error=None if ok else type(req.error).__name__)
                if self.check_invariants:
                    check = getattr(inst, "check_invariants", None)
                    if callable(check):
                        # a speculative pair checks BOTH pools (its
                        # .alloc is only the target's)
                        check()
                    else:
                        alloc = getattr(inst, "alloc", None)
                        if alloc is not None:
                            alloc.check_invariants()
            if user_cb is not None:
                user_cb(req, tok)
        return on_token

    def _decode_options(self, model: str, inst,
                        draft_model: Optional[str],
                        constraint, speculate: Optional[bool]):
        """Validate per-request decode options against the serving
        instance and fold them into the scheduler's ``decode`` dict —
        loudly, at submit time (HTTP 400), never inside the serve loop.
        Returns None for a plain (non-speculative) group; a speculative
        group always gets an explicit dict — speculation defaults ON
        there (``speculate=False`` opts a request out)."""
        spec_aware = getattr(inst, "speculative_aware", False)
        if not spec_aware:
            if draft_model is None and constraint is None \
                    and speculate is not True:
                # nothing asked that a plain group cannot serve — an
                # explicit speculate=False OPT-OUT lands here too:
                # plain decode is exactly what the client requested
                return None
            raise ValueError(
                f"model {model!r} has no draft attached — "
                f"draft_model/constraint/speculate=True need a "
                f"speculative group (load_model(..., draft_model=))")
        if draft_model is None and constraint is None \
                and speculate is None:
            # nothing asked: leave decode None so the journal records
            # nothing and a replay (or a queued request surviving a
            # swap to a DRAFTLESS version) decodes plain instead of
            # being rejected for options the client never requested —
            # speculation still defaults ON group-side (admit_slot)
            return None
        attached = getattr(inst, "draft_name", None)
        if draft_model is not None and str(draft_model) != str(attached):
            # attached None (an adopted instance built without
            # draft_name) also lands here: the client named a draft we
            # cannot confirm is the one attached — refuse rather than
            # silently speculate with an unknown draft
            raise ValueError(
                f"model {model!r} serves with draft {attached!r}, not "
                f"{draft_model!r} — one draft per lane group")
        decode = {"draft": True if speculate is None
                  else bool(speculate)}
        if constraint is not None:
            if not isinstance(constraint, dict):
                # the journal replays decode options as JSON; a
                # prebuilt Constraint object could neither serialize
                # nor reconstruct — in-process callers with custom
                # automata use the scheduler/generator directly
                raise ValueError(
                    "gateway constraint must be a JSON spec dict "
                    "(serving/constraints.py wire format), not "
                    f"{type(constraint).__name__}")
            # compile now so a malformed grammar 400s the submit; the
            # generator memoizes, so admission pays a dict lookup
            inst.compile_constraint(constraint)
            decode["constraint"] = constraint
        return decode

    def submit(self, model: str, prompt, tenant: str = "default",
               max_new: Optional[int] = None, on_token=None,
               draft_model: Optional[str] = None, constraint=None,
               speculate: Optional[bool] = None,
               tag: Optional[str] = None,
               session: Optional[str] = None) -> Request:
        """Rate-limit gate -> journal -> queue.  Returns the scheduler
        ``Request`` (``wait()`` for blocking use).  ``draft_model``
        (must match the group's attached draft), ``constraint`` (a
        grammar spec — serving/constraints.py wire format) and
        ``speculate`` (False = plain decode on a speculative group)
        ride the request as ``Request.decode``.  ``tag`` is
        an opaque caller id journaled with the entry (the
        fleet router's migration correlator)."""
        if self._draining:
            # refuse BEFORE rate-limit debit and BEFORE journaling:
            # work accepted now would only be handed back as failed
            # when the drain reaches the queue
            raise GatewayDraining(
                "gateway is draining; resubmit to another replica")
        cfg = self.router.tenant(tenant)
        key = self.registry.resolve(model)
        try:
            inst = self.registry.instance(key)  # KeyError: unknown model
        except KeyError:
            # TOCTOU with a concurrent hot swap (found by the
            # reference's race harness): the alias flipped and the old version
            # unloaded between resolve() and instance() — a client
            # submitting against a model that IS being served got a
            # spurious unknown-model error mid-swap.  Re-resolve once;
            # a genuinely unknown model still raises.
            key = self.registry.resolve(model)
            inst = self.registry.instance(key)
        if not callable(getattr(inst, "open_slots", None)):
            raise TypeError(
                f"model {model!r} is an engine artifact (batch "
                f"inference); the generate path needs a generator — "
                f"call registry.instance({model!r}).infer(feed) instead")
        cap = getattr(inst, "max_out_len", self.sched.default_max_new)
        eff_new = min(max_new or self.sched.default_max_new, cap)
        # rate-limit BEFORE decoding options: compile_constraint can
        # cost real CPU/memory on a large grammar, and an over-budget
        # tenant must not get to burn it
        self.router.check_submit(
            tenant, self.router.request_cost(len(prompt), eff_new))
        decode = self._decode_options(model, inst, draft_model,
                                      constraint, speculate)
        jid = None
        if self.journal is not None:
            jid = self.journal.new_jid()
            self.journal.record_submit(jid, tenant, model, prompt,
                                       eff_new, decode=decode, tag=tag,
                                       session=session)
        try:
            req = self.sched.submit(
                prompt, max_new_tokens=eff_new, model=model,
                tenant=tenant, decode=decode, session=session,
                on_token=self._wrap_on_token(jid, cfg.slo, inst,
                                             on_token))
        except BaseException as e:
            # the scheduler refused it (infeasible prompt, too long):
            # close the journal entry, or a restart would replay a
            # request that can never be served — a poison pill
            if self.journal is not None and jid is not None:
                self.journal.record_done(jid, ok=False,
                                         error=type(e).__name__)
            raise
        req.jid = jid
        version = key.split("@", 1)[-1] if "@" in key else "?"
        self._m_requests.labels(tenant=tenant, model=model,
                                version=version, event="submitted").inc()
        return req

    def generate(self, model: str, prompt, tenant: str = "default",
                 max_new: Optional[int] = None,
                 timeout: Optional[float] = 120.0,
                 draft_model: Optional[str] = None, constraint=None,
                 speculate: Optional[bool] = None,
                 tag: Optional[str] = None,
                 session: Optional[str] = None) -> Dict[str, object]:
        """Blocking path: submit, wait, return the full token list.

        ``session`` names a tiered-KV conversation: the first
        call decodes normally and SUSPENDS the lane's KV pages at retire
        (host/disk artifact keyed by this id); a later call with the same
        id resumes from the suspended position — the response's tokens
        are the CONTINUATION only, and ``resumed`` tells which path
        admission took (False = the artifact was missing/stale and the
        prompt re-prefilled from scratch)."""
        req = self.submit(model, prompt, tenant=tenant, max_new=max_new,
                          draft_model=draft_model, constraint=constraint,
                          speculate=speculate, tag=tag, session=session)
        if not req.wait(timeout):
            req.cancel()
            raise TimeoutError(f"generate: rid {req.rid} still running "
                               f"after {timeout}s (cancelled)")
        if req.error is not None:
            raise req.error
        # jid rides the response so the fleet router can tell a
        # DELIVERED completion from one whose async done record was
        # still queued when the replica died (the dedup input for
        # zero-duplicate journal migration)
        out = {"rid": req.rid, "jid": req.jid, "model": req.model,
               "version": (req.group or "@?").split("@", 1)[-1],
               "tenant": tenant, "tokens": list(req.tokens),
               "latency_s": round(req.total_latency or 0.0, 4)}
        if session is not None:
            out["session"] = session
            out["resumed"] = bool(req.resumed)
        return out

    def submit_stream(self, model: str, prompt, tenant: str = "default",
                      max_new: Optional[int] = None,
                      timeout: float = 60.0,
                      draft_model: Optional[str] = None, constraint=None,
                      speculate: Optional[bool] = None,
                      session: Optional[str] = None) -> TokenStream:
        """Streaming path: returns a ``TokenStream`` yielding tokens as
        decode steps retire.  Token-for-token identical to the blocking
        path (same scheduler, same lanes) — the acceptance test asserts
        it.  A speculative lane delivers its accepted tokens through
        the same per-token callback, so a stream consumer sees a burst
        of up to k+1 tokens per round, in order."""
        stream = TokenStream(timeout=timeout)
        req = self.submit(model, prompt, tenant=tenant, max_new=max_new,
                          on_token=stream._push, draft_model=draft_model,
                          constraint=constraint, speculate=speculate,
                          session=session)
        stream.request = req
        return stream

    # -- recovery (supervised restart) ---------------------------------------
    def recover(self) -> List[Request]:
        """Resubmit every journaled-but-unfinished request (call AFTER
        the models are loaded).  Rate limits are NOT re-debited — the
        work was already admitted once; a restart must not double-charge
        the tenant.  Returns the resubmitted requests."""
        if self.journal is None:
            return []
        # compact first: the restart boundary is the natural
        # moment to drop the predecessor's done-record history and its
        # torn tail — replay input is identical, the file stops growing
        # across restart cycles
        self.journal.compact()
        out = []
        for entry in self.journal.pending():
            cfg = self.router.tenant(entry["tenant"])
            try:
                inst = self.registry.instance(entry["model"])
                req = self.sched.submit(
                    np.asarray(entry["prompt"], np.int64),
                    max_new_tokens=entry["max_new"],
                    model=entry["model"], tenant=entry["tenant"],
                    decode=entry.get("decode"),
                    session=entry.get("session"),
                    on_token=self._wrap_on_token(entry["jid"], cfg.slo,
                                                 inst))
            except Exception as e:
                # the model is gone, the prompt no longer fits, or the
                # pool can never hold it in the restarted process:
                # close the journal entry and keep replaying the rest —
                # one bad entry must never poison the whole recovery
                self.journal.record_done(entry["jid"], ok=False,
                                         error=type(e).__name__)
                continue
            req.jid = entry["jid"]
            out.append(req)
        return out

    # -- serving loop --------------------------------------------------------
    def serve(self) -> "Gateway":
        self._draining = False
        self.sched.serve()
        return self

    def shutdown(self, drain: bool = True,
                 timeout: float = 30.0) -> List[Request]:
        if drain:
            # flip the refusal gate FIRST: from here on submits 503
            # (GatewayDraining) instead of queueing work the drain
            # below would only hand back as failed
            self._draining = True
        leftovers = self.sched.shutdown(timeout=timeout, drain=drain)
        if self.journal is not None:
            # settle the file: a migrator reading the journal after the
            # drain must see every done record that will ever be
            # written — what is still pending afterwards is exactly the
            # handoff set (the leftovers above plus anything in-flight
            # a non-drain shutdown abandoned)
            self.journal.flush()
        return leftovers

    def begin_drain(self) -> bool:
        """Atomically flip the draining gate (under the wedge lock):
        True when THIS call turned it on — the caller owns running the
        actual drain; False when a drain is already in progress, so
        repeated drain verbs (router retries, CLI + router both
        draining) are idempotent instead of stacking concurrent
        ``shutdown(drain=True)`` threads."""
        with self._wedge_lock:
            if self._draining:
                return False
            self._draining = True
            return True

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def drained(self) -> bool:
        """True once a drain finished: nothing queued, nothing in
        flight, serve loop stopped — the fleet router's cue that this
        replica's journal tail is stable and safe to migrate."""
        if not self._draining:
            return False
        st = self.sched.stats()
        return (st["queued"] == 0 and st["in_flight"] == 0
                and self.sched._thread is None)

    def ready(self) -> Dict[str, object]:
        """Readiness (distinct from liveness): False while a load/swap
        is warming a compile or while draining.  /readyz serves this —
        the router's rotation signal."""
        if self._draining:
            return {"ready": False, "reason": "draining",
                    "draining": True, "drained": self.drained}
        with self._wedge_lock:
            warming = self._swapping > 0
        if warming:
            return {"ready": False, "reason": "warming",
                    "draining": False}
        return {"ready": True, "draining": False}

    def run_until_idle(self, max_steps: Optional[int] = None) -> int:
        return self.sched.run_until_idle(max_steps)

    def wedged(self, stall_s: float = 30.0) -> bool:
        """True when work is pending but the step counter has not moved
        for ``stall_s`` — the supervised launcher's restart trigger (the
        hung-step watchdog idea applied to serving)."""
        st = self.sched.stats()
        busy = st["in_flight"] > 0 or st["queued"] > 0
        now = time.monotonic()
        with self._wedge_lock:
            if self._swapping:
                # a hot swap's _warm compile legitimately freezes the
                # step counter with work pending — reset the stall
                # clock so the pause is never mistaken for a wedge
                self._wedge_mark = (st["steps"], now)
                return False
            steps, since = self._wedge_mark
            if st["steps"] != steps or not busy:
                self._wedge_mark = (st["steps"], now)
                return False
            return (now - since) > stall_s

    # -- accounting ----------------------------------------------------------
    def tenant_latencies(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant p50/p95 over successfully finished requests — the
        isolation numbers the flooding test asserts."""
        by_tenant: Dict[str, List[float]] = {}
        for r in self.sched.finished_requests():
            if r.error is None and r.total_latency is not None:
                by_tenant.setdefault(r.tenant or "default", []).append(
                    r.total_latency)
        out = {}
        for tenant, vals in sorted(by_tenant.items()):
            arr = np.asarray(vals)
            out[tenant] = {
                "count": int(arr.size),
                "p50_latency_s": round(float(np.percentile(arr, 50)), 4),
                "p95_latency_s": round(float(np.percentile(arr, 95)), 4),
            }
        return out

    def stats(self) -> Dict[str, object]:
        out = {
            "registry": self.registry.stats(),
            "router": self.router.stats(),
            "scheduler": self.sched.stats(),
            "tenants": self.tenant_latencies(),
            # pid lets a same-host operator (the fleet CLI's kill) find
            # the process behind an address; draining/drained are the
            # router's migration cues
            "pid": _os.getpid(),
            "draining": self._draining,
            "drained": self.drained,
        }
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        return out
