"""Structured trace spans — the port's copy of
``paddle_tpu/observability/tracing.py``.

``Tracer`` keeps a bounded ring of Chrome-trace event dicts: ``span``
(an "X" complete event), ``instant`` (an "i" lifecycle mark: submitted,
admitted, token, retired) and ``complete`` (an X event from timestamps
taken elsewhere); ``events()`` reads them back.  Ids come from a
process-local counter, so two runs that do the same work emit the same
id sequence.  The reference's Chrome-trace export is not ported yet.
Host-only: nothing here touches the device.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..utils.sync import RANK_TRACER, OrderedLock

__all__ = ["Tracer", "tracer"]


class Tracer:
    """Bounded in-memory trace sink.  ``capacity`` bounds the ring (old
    events drop, counted in ``dropped``); ``enabled=False`` turns every
    emit into a cheap no-op."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        # emits happen under the scheduler lock (instants from
        # _retire_locked/_note_token), so the tracer ranks above it
        self._lock = OrderedLock("obs.tracer", RANK_TRACER)
        self._events: deque = deque(maxlen=int(capacity))
        self._ids = itertools.count(1)
        self.enabled = bool(enabled)
        self.dropped = 0
        self._pid = os.getpid()

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
        merged into the event's args at exit."""
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


_tracer = Tracer()


def tracer() -> Tracer:
    """The process-global tracer every instrumented surface shares."""
    return _tracer
