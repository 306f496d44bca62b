"""Named, ranked locks — the port's copy of ``paddle_tpu/utils/sync.py``.

The serving stack runs the scheduler's admit/step loop on its own thread
beside the callers that submit requests, and the metrics and tracer
sinks take their own locks under the scheduler's.  Each lock carries a
name and a rank from the table below; a thread may only acquire locks of
ascending rank (outermost first).  The ranks are the reference's, so the
two packages name and order their locks alike.

This copy keeps the wrappers and the ranks the port's modules use.  The
reference's checking registry (rank-inversion and cycle detection,
enabled with ``PADDLE_TPU_SYNC_CHECK=1``) is not ported yet: here every
wrapper is the passthrough the reference runs when checking is off.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["OrderedLock", "OrderedRLock", "OrderedCondition", "RANK_TABLE"]

RANK_SCHEDULER = 30        # serving.scheduler     serving/scheduler.py
RANK_SESSIONS = 34         # serving.sessions      serving/sessions.py
RANK_CONSTRAINTS = 46      # serving.constraints   serving/speculative.py
RANK_COLLECTOR_INIT = 70   # obs.collector_init    one-shot register guards
RANK_METRICS_REGISTRY = 80  # metrics.registry     observability/metrics.py
RANK_METRICS_FAMILY = 82   # metrics.family        observability/metrics.py
RANK_METRICS_CHILD = 84    # metrics.child         observability/metrics.py
RANK_TRACER = 86           # obs.tracer            observability/tracing.py
RANK_CHAOS = 90            # chaos.injector        resilience/chaos.py

RANK_TABLE: Dict[str, int] = {
    "serving.scheduler": RANK_SCHEDULER,
    "serving.sessions": RANK_SESSIONS,
    "serving.constraints": RANK_CONSTRAINTS,
    "obs.collector_init": RANK_COLLECTOR_INIT,
    "metrics.registry": RANK_METRICS_REGISTRY,
    "metrics.family": RANK_METRICS_FAMILY,
    "metrics.child": RANK_METRICS_CHILD,
    "obs.tracer": RANK_TRACER,
    "chaos.injector": RANK_CHAOS,
}


class OrderedLock:
    """``threading.Lock`` with a declared name and rank."""

    __slots__ = ("name", "rank", "_lock")

    def __init__(self, name: str, rank: Optional[int] = None):
        self.name = str(name)
        self.rank = None if rank is None else int(rank)
        self._lock = self._make()

    def _make(self):
        return threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._lock.acquire(blocking, timeout)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "OrderedLock":
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def __repr__(self) -> str:    # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r} rank={self.rank}>"


class OrderedRLock(OrderedLock):
    """``threading.RLock`` flavor of :class:`OrderedLock`."""

    __slots__ = ()

    def _make(self):
        return threading.RLock()


class OrderedCondition:
    """``threading.Condition`` over an OrderedLock.  Pass ``lock=`` to
    share an existing ordered lock (the scheduler's work condition
    shares its state lock), or ``name``/``rank`` to own a fresh one."""

    __slots__ = ("_olock", "_cond")

    def __init__(self, lock: Optional[OrderedLock] = None,
                 name: str = "condition", rank: Optional[int] = None):
        if lock is None:
            lock = OrderedLock(name, rank)
        self._olock = lock
        self._cond = threading.Condition(lock._lock)

    def __enter__(self) -> "OrderedCondition":
        self._olock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._olock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._cond.wait(timeout)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()
