"""TenantRouter: rate limits, SLO classes, and fair-share admission —
the port's copy of ``paddle_tpu/serving/gateway/router.py``.

One greedy client must not starve the rest, so the gateway gives each *tenant* (API consumer) an explicit contract:

* **token-bucket rate limit** — enforced synchronously at ``submit``:
  each request costs ``prompt_tokens + max_new`` bucket tokens; an
  empty bucket rejects with ``RateLimited`` (HTTP 429) instead of
  queueing work the tenant has no budget for.
* **SLO class** — ``"latency"`` or ``"batch"``.  Preemption happens at
  ADMISSION ONLY, never mid-request: whenever a slot frees, every
  queued latency-class request outranks every batch-class request, and
  batch tenants may hold at most ``n_slots - reserve_latency_slots``
  lanes, so ``reserve_latency_slots`` lanes are always draining toward
  the latency class.  The resulting isolation bound is STATED, not
  vibes: a latency request waits at most the residual decode time of
  the latency requests ahead of it plus ONE reserved-lane turnover —
  independent of how hard a batch tenant floods the queue
  (tests/test_gateway.py asserts the p95 consequence under a seeded
  flood).
* **weighted fair share** — within a class, the admissible candidate
  whose tenant has consumed the least ``service/weight`` (service =
  admitted prompt+decode tokens) is admitted next, so two latency
  tenants at weight 2:1 split slots 2:1 under contention instead of
  FIFO luck.

The router plugs into the scheduler as its ``admission_policy`` and
never touches lanes itself — the scheduler remains the only owner of
slots and pages."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ...utils.sync import RANK_ROUTER, OrderedLock
from ..scheduler import Request

__all__ = ["RateLimited", "TenantConfig", "TenantRouter"]

SLO_CLASSES = ("latency", "batch")


class RateLimited(RuntimeError):
    """The tenant's token bucket is empty — try again later (HTTP 429)."""


class TenantConfig:
    """One tenant's contract: SLO class, fair-share weight, rate limit."""

    def __init__(self, name: str, slo: str = "batch", weight: float = 1.0,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None):
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo={slo!r}: one of {SLO_CLASSES}")
        if weight <= 0:
            raise ValueError("weight must be > 0")
        self.name = str(name)
        self.slo = slo
        self.weight = float(weight)
        # rate: bucket tokens refilled per second (cost of one request =
        # prompt tokens + max_new); None = unlimited.  burst defaults to
        # one second of rate — enough for one full-size request.
        self.rate = None if rate is None else float(rate)
        self.burst = float(burst if burst is not None
                           else (rate if rate is not None else 0.0))

    def to_dict(self) -> Dict[str, object]:
        return {"slo": self.slo, "weight": self.weight,
                "rate": self.rate, "burst": self.burst}


class _Bucket:
    """Classic token bucket with an injectable clock (tests drive it
    deterministically via ``now``)."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def take(self, cost: float, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class TenantRouter:
    """Per-tenant admission control over one scheduler's slots."""

    def __init__(self, tenants: Optional[List[TenantConfig]] = None,
                 default_slo: str = "batch",
                 reserve_latency_slots: int = 1,
                 now_fn: Callable[[], float] = time.monotonic):
        if default_slo not in SLO_CLASSES:
            raise ValueError(f"default_slo={default_slo!r}")
        # acquired under the scheduler lock (admission_policy hook)
        self._lock = OrderedLock("gateway.router", RANK_ROUTER)
        self._tenants: Dict[str, TenantConfig] = {}
        self._buckets: Dict[str, _Bucket] = {}
        self._service: Dict[str, float] = {}
        self._counts: Dict[str, Dict[str, int]] = {}
        self.default_slo = default_slo
        self.reserve_latency_slots = int(reserve_latency_slots)
        self._now = now_fn
        self._slots_fn: Callable[[], int] = lambda: 0
        self._queued_fn: Callable[[], List[Request]] = list
        for t in tenants or []:
            self.add_tenant(t)
        from ...observability import metrics as _m

        self._m_rejected = _m.registry().counter(
            "paddle_gateway_rejections_total",
            "Requests refused before queueing",
            labels=("tenant", "reason"))

    # -- wiring --------------------------------------------------------------
    def bind(self, slots_fn: Callable[[], int],
             queued_fn: Optional[Callable[[], List[Request]]] = None
             ) -> None:
        """Attach the scheduler views the router reasons over: total
        slot count (the batch-class cap base) and the waiting queue
        (per-tenant depth in ``stats()``)."""
        self._slots_fn = slots_fn
        if queued_fn is not None:
            self._queued_fn = queued_fn

    def add_tenant(self, cfg: TenantConfig) -> None:
        with self._lock:
            self._tenants[cfg.name] = cfg
            if cfg.rate is not None:
                self._buckets[cfg.name] = _Bucket(cfg.rate, cfg.burst,
                                                  self._now())
            else:
                self._buckets.pop(cfg.name, None)
            self._service.setdefault(cfg.name, 0.0)
            self._counts.setdefault(
                cfg.name, {"admitted": 0, "rejected": 0})

    def tenant(self, name: str) -> TenantConfig:
        """Config for ``name``; unknown tenants are auto-registered with
        the default class, weight 1, and no rate limit."""
        with self._lock:
            cfg = self._tenants.get(name)
            if cfg is None:
                cfg = TenantConfig(name, slo=self.default_slo)
                self._tenants[name] = cfg
                self._service.setdefault(name, 0.0)
                self._counts.setdefault(
                    name, {"admitted": 0, "rejected": 0})
            return cfg

    # -- submit-time gate ----------------------------------------------------
    @staticmethod
    def request_cost(prompt_tokens: int, max_new: int) -> float:
        return float(int(prompt_tokens) + int(max_new))

    def check_submit(self, tenant: str, cost: float) -> None:
        """Debit the tenant's token bucket; raises ``RateLimited`` when
        the bucket cannot cover ``cost``."""
        cfg = self.tenant(tenant)
        with self._lock:
            bucket = self._buckets.get(cfg.name)
            if bucket is not None and not bucket.take(cost, self._now()):
                self._counts[cfg.name]["rejected"] += 1
                self._m_rejected.labels(tenant=cfg.name,
                                        reason="rate_limit").inc()
                raise RateLimited(
                    f"tenant {cfg.name!r}: rate limit exceeded "
                    f"(cost {cost:g}, {bucket.tokens:.1f} tokens left of "
                    f"{bucket.burst:g} at {bucket.rate:g}/s)")

    # -- admission policy (scheduler hook) -----------------------------------
    def _slo(self, req: Request) -> str:
        return self.tenant(req.tenant or "default").slo

    def admission_policy(self, candidates: List[Request],
                         active: List[Request]) -> Optional[Request]:
        """Pick which admissible queued request takes the next free
        slot.  Called by the scheduler under its lock — pure host
        bookkeeping, no device work, no blocking."""
        if not candidates:
            return None
        lat = [r for r in candidates if self._slo(r) == "latency"]
        pool = lat
        if not pool:
            # batch class is capped below the slot count so the reserve
            # is always draining toward future latency arrivals — never
            # preempting anything already running.  The reserve only
            # exists while a latency-class tenant is REGISTERED: with no
            # one to reserve for, holding lanes idle would just starve
            # batch work (a 1-slot scheduler could never admit anything)
            with self._lock:
                has_latency = any(c.slo == "latency"
                                  for c in self._tenants.values())
            reserve = self.reserve_latency_slots if has_latency else 0
            cap = max(0, self._slots_fn() - reserve)
            busy = sum(1 for r in active if self._slo(r) == "batch")
            if busy >= cap:
                return None
            pool = candidates
        chosen = min(pool, key=self._fair_key)
        cfg = self.tenant(chosen.tenant or "default")
        with self._lock:
            self._service[cfg.name] = self._service.get(cfg.name, 0.0) \
                + self.request_cost(len(chosen.src),
                                    chosen.max_new_tokens)
            self._counts[cfg.name]["admitted"] += 1
        return chosen

    def _fair_key(self, req: Request):
        cfg = self.tenant(req.tenant or "default")
        with self._lock:
            service = self._service.get(cfg.name, 0.0)
        # weighted fair share; submission order (rid) breaks ties so two
        # even tenants interleave deterministically
        return (service / cfg.weight, req.rid)

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        queued = self._queued_fn()
        depth: Dict[str, int] = {}
        for r in queued:
            depth[r.tenant or "default"] = \
                depth.get(r.tenant or "default", 0) + 1
        with self._lock:
            out = {}
            for name, cfg in sorted(self._tenants.items()):
                out[name] = dict(cfg.to_dict(),
                                 service_tokens=self._service.get(name,
                                                                  0.0),
                                 queued=depth.get(name, 0),
                                 **self._counts.get(
                                     name,
                                     {"admitted": 0, "rejected": 0}))
        for name, n in depth.items():
            if name not in out:
                out[name] = {"queued": n}
        return {"tenants": out,
                "reserve_latency_slots": self.reserve_latency_slots,
                "default_slo": self.default_slo}
