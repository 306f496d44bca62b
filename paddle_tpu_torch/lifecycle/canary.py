"""CanarySlice — deterministic canary routing as an admission policy;
the port's copy of ``paddle_tpu/lifecycle/canary.py``.

The scheduler's pluggable ``admission_policy(candidates, active)`` hook
(serving/scheduler.py) picks WHICH admissible queued request takes the
next free slot; the canary wraps whatever policy is installed (the
TenantRouter's SLO/fair-share policy in the gateway) and additionally
PINS the chosen request's lane-group target via ``Request.route_to``:
a seeded, deterministic slice of the alias's traffic goes to the
candidate version, the rest to the stable one.

Design points:

* **deterministic slice** — draw k for the alias is
  ``FaultInjector.decision(seed, "canary.<alias>", k)``, the same pure
  crc32 function the chaos layer uses, so the exact routing sequence
  replays from the seed (the chaos e2e depends on it).
* **pin once, at pick time** — a request is routed the first time the
  policy chooses it and keeps that target across blocked admission
  retries (a request must not flap between versions while it waits).
  Pinned ``name@version`` submissions (the controller's quality
  probes) and other aliases pass through untouched.
* **uninstall before teardown** — the controller restores the inner
  policy BEFORE removing the candidate's lane group; the scheduler
  then falls queued canary-pinned requests back to the alias (see
  ``Request.route_to``), so a rollback never takes queued work down
  with it.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..resilience.chaos import FaultInjector
from ..serving.scheduler import Request
from ..utils.sync import RANK_CANARY, OrderedLock

__all__ = ["CanarySlice"]


class CanarySlice:
    """Route a deterministic fraction of one alias's admissions to a
    candidate lane group; everything else sticks to the stable one."""

    def __init__(self, alias: str, stable_key: str, canary_key: str,
                 fraction: float, seed: int = 0,
                 inner: Optional[Callable] = None):
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"fraction={fraction}: want [0, 1]")
        self.alias = str(alias)
        self.stable_key = str(stable_key)
        self.canary_key = str(canary_key)
        self.fraction = float(fraction)
        self.seed = int(seed)
        self.inner = inner
        # acquired under the scheduler lock (admission_policy hook)
        self._lock = OrderedLock("lifecycle.canary", RANK_CANARY)
        self._draw = 0
        self.assigned = {"stable": 0, "canary": 0}

    def route(self, req: Request) -> None:
        """Pin ``req`` to stable or canary (idempotent; foreign aliases
        and already-pinned requests untouched)."""
        if req.route_to is not None or req.model != self.alias:
            return
        with self._lock:
            index = self._draw
            self._draw += 1
        value = FaultInjector.decision(self.seed,
                                       f"canary.{self.alias}", index)
        to_canary = value < self.fraction
        req.route_to = self.canary_key if to_canary else self.stable_key
        with self._lock:
            self.assigned["canary" if to_canary else "stable"] += 1

    def admission_policy(self, candidates: List[Request],
                         active: List[Request]) -> Optional[Request]:
        """The scheduler hook: delegate the PICK to the inner policy
        (submission order when none), then route the chosen request.
        Runs under the scheduler lock — pure host bookkeeping."""
        if self.inner is not None:
            chosen = self.inner(candidates, active)
        else:
            chosen = candidates[0] if candidates else None
        if chosen is not None:
            self.route(chosen)
        return chosen

    def stats(self) -> dict:
        with self._lock:
            return {"alias": self.alias, "stable_key": self.stable_key,
                    "canary_key": self.canary_key,
                    "fraction": self.fraction, "seed": self.seed,
                    "draws": self._draw, "assigned": dict(self.assigned)}
