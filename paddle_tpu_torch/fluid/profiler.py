"""Profiler — the port of ``paddle_tpu/fluid/profiler.py`` (analog of
python/paddle/v2/fluid/profiler.py: the ``profiler`` context :76,
``cuda_profiler`` :33, over platform/profiler.h's RecordEvent).

``record_event`` times a block on the host clock and nothing else: it
never synchronizes with the card, so a step it wraps (``Executor.run``
wraps each in ``executor_step/<mode>``) keeps its one host sync, and on
the card it measures what the host spent issuing the step, not the
card's time.  Every event is also a span of the observability tracer.
The deep device profile (``tpu_trace``, and ``cuda_profiler`` by the
reference's name) is ``torch.profiler`` writing a Chrome trace into the
directory given.  ``op_cost_table`` (the reference's costed HLO per op)
raises: it needs the cost model of ROADMAP A14.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

from ..observability.tracing import tracer as _obs_tracer
from ..utils.sync import RANK_PROFILER, OrderedLock

__all__ = ["profiler", "cuda_profiler", "tpu_trace", "reset_profiler",
           "op_cost_table", "record_event", "get_profile_table"]

# appended from whatever thread runs a step (a scheduler's, a loader
# consumer's), so every touch goes through the lock
_events: Dict[str, List[float]] = defaultdict(list)
_events_lock = OrderedLock("fluid.profiler", RANK_PROFILER)
_enabled = False
_trace_ids = itertools.count()


@contextlib.contextmanager
def record_event(name: str):
    """Time a block on the host clock (platform::RecordEvent,
    profiler.h:25): into the table while ``profiler()`` is active, and
    as a tracing span (same name, cat="profiler") while the tracer is
    on."""
    tr = _obs_tracer()
    if not _enabled and not tr.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if _enabled:
            with _events_lock:
                _events[name].append(t1 - t0)
        tr.complete(name, t0, t1, cat="profiler")


def reset_profiler():
    with _events_lock:
        _events.clear()


def get_profile_table(sorted_key: Optional[str] = "total"):
    """Event table like the reference's ParseEvents output
    (platform/profiler.cc): name, calls, total, min, max, ave (s)."""
    with _events_lock:
        snapshot = {name: list(times) for name, times in _events.items()}
    rows = []
    for name, times in snapshot.items():
        rows.append({
            "name": name, "calls": len(times),
            "total": sum(times), "min": min(times), "max": max(times),
            "ave": sum(times) / len(times),
        })
    if sorted_key:
        rows.sort(key=lambda r: -r.get(sorted_key, 0))
    return rows


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             print_table: bool = True):
    """fluid.profiler.profiler(state, sorted_key): collect events for
    the block and print the table at its exit."""
    global _enabled
    old, _enabled = _enabled, True
    reset_profiler()
    try:
        yield
    finally:
        _enabled = old
        if print_table:
            rows = get_profile_table(sorted_key)
            if rows:
                w = max(len(r["name"]) for r in rows)
                print(f"{'Event':<{w}}  Calls  Total(s)   Min(s)    Max(s)"
                      f"    Ave(s)")
                for r in rows:
                    print(f"{r['name']:<{w}}  {r['calls']:>5}  "
                          f"{r['total']:8.4f}  {r['min']:8.4f}  "
                          f"{r['max']:8.4f}  {r['ave']:8.4f}")


@contextlib.contextmanager
def tpu_trace(log_dir: Optional[str] = None):
    """Deep profile of the block through ``torch.profiler`` (host ops,
    and the card's kernels and copies where there is a card), written
    as a Chrome trace ``trace.<pid>.<n>.json`` into ``log_dir`` (a
    folder under the temporary directory by default).  Yields the
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "paddle_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{next(_trace_ids)}.json"))


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """The reference's name (fluid/profiler.py:33): ``tpu_trace`` into
    the directory ``output_file``.  ``output_mode`` and ``config`` (the
    reference's nvprof settings) change nothing."""
    with tpu_trace(output_file) as d:
        yield d


def op_cost_table(program=None, feed=None, scope=None, mode="train",
                  top: int = 20, print_table: bool = True):
    """The reference's per-op costed-HLO breakdown: not ported."""
    raise NotImplementedError(
        "profiler.op_cost_table needs a per-op cost model (the "
        "reference's XLA HLO cost analysis), not ported to "
        "paddle_tpu_torch (ROADMAP Queue A14)")
