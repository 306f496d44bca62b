"""Structured trace spans — the port's copy of
``paddle_tpu/observability/tracing.py``: ring-buffered, thread-safe,
exportable as Chrome-trace / Perfetto JSON.

``Tracer`` keeps a bounded ring of event dicts (append under one lock):

* ``span(name, **args)`` — context manager emitting a Chrome "X"
  (complete) event with microsecond ``ts``/``dur``;
* ``instant(name, **args)`` — zero-duration "i" event (lifecycle marks:
  submitted / admitted / token / retired);
* ``complete(name, start, end, **args)`` — an X event from timestamps
  recorded elsewhere (the scheduler builds the whole-request span from
  the Request's own submitted/finished marks).

Ids come from a process-local counter, so two runs that do the same
work emit the same id sequence.  ``chrome_trace()`` emits the
``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto load
(``/trace`` of the observability server).  Host-only: nothing here
touches the device.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.sync import RANK_TRACER, OrderedLock

__all__ = ["Tracer", "tracer", "span", "instant"]


class Tracer:
    """Bounded in-memory trace sink.  ``capacity`` bounds the ring (old
    events drop, counted in ``dropped``); ``enabled=False`` turns every
    emit into a cheap no-op."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        # innermost-but-one rank: emits happen under the scheduler and
        # router locks (span instants from _retire_locked/_note_token)
        self._lock = OrderedLock("obs.tracer", RANK_TRACER)
        self._events: deque = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)
        self.enabled = bool(enabled)
        self.dropped = 0
        self._pid = os.getpid()

    # -- emit ----------------------------------------------------------------
    def _emit(self, ev: Dict[str, object]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def _base(self, name: str, cat: str, ph: str, ts: float
              ) -> Dict[str, object]:
        return {"name": name, "cat": cat or "default", "ph": ph,
                "ts": ts * 1e6, "pid": self._pid,
                "tid": threading.get_ident(), "id": next(self._ids)}

    def instant(self, name: str, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        ev = self._base(name, cat, "i", time.perf_counter())
        ev["s"] = "t"               # thread-scoped instant
        if args:
            ev["args"] = args
        self._emit(ev)

    def complete(self, name: str, start: float, end: float,
                 cat: str = "", **args) -> None:
        """An "X" event from externally recorded perf_counter marks."""
        if not self.enabled:
            return
        ev = self._base(name, cat, "X", start)
        ev["dur"] = max(0.0, (end - start) * 1e6)
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Time a block as one complete event.  Yields a mutable dict
        merged into the event's args at exit — fill in results computed
        inside the block (token ids, counts)."""
        if not self.enabled:
            yield {}
            return
        extra: Dict[str, object] = {}
        t0 = time.perf_counter()
        try:
            yield extra
        finally:
            self.complete(name, t0, time.perf_counter(), cat=cat,
                          **{**args, **extra})

    # -- control -------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- export --------------------------------------------------------------
    def events(self, name: Optional[str] = None,
               cat: Optional[str] = None) -> List[Dict[str, object]]:
        """Snapshot of the ring (optionally filtered), oldest first."""
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["name"] == name]
        if cat is not None:
            evs = [e for e in evs if e["cat"] == cat]
        return evs

    def chrome_trace(self) -> Dict[str, object]:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome-trace JSON; returns the event count."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


_tracer = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every instrumented surface shares."""
    return _tracer


def span(name: str, cat: str = "", **args):
    """Module-level shorthand for ``tracer().span(...)``."""
    return _tracer.span(name, cat=cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    _tracer.instant(name, cat=cat, **args)
