"""Async input pipeline — the device-prefetch DataLoader, the port of
``paddle_tpu/fluid/pipeline_io.py``.

Analog of the reference's reader-op stack: ``py_reader`` (a python
thread feeding a blocking queue), ``double_buffer`` (the next batch kept
resident on the device) and ``decorator.buffered`` collapse into one
``DataLoader``: its producer thread runs the reader, applies the
``DataFeeder`` conversion and, with ``device_prefetch``, copies each
batch to the card up to ``capacity`` batches ahead of the step that
consumes it.

On the card the copy must neither make the host wait nor race the step:

* the producer copies from pinned memory (a copy from pageable memory
  is a host sync, which the executor's eager first step refuses under
  ``torch.cuda.set_sync_debug_mode("error")``), asynchronously, on a
  side stream of its own, and records a CUDA event after the batch;
* the consumer's stream waits on that event before the batch is handed
  out (before the executor reads it), and each tensor is marked as used
  on the consumer's stream (``record_stream``), so the caching allocator
  does not give its memory to another tensor while the step still reads
  it;
* the producer issues no work while the executor captures a step in a
  CUDA graph (``executor.CAPTURE_LOCK``): an allocation by another thread
  would break the capture.

Consumption is a plain iterator of feed dicts whose values are already
on the device, which ``Executor.run`` takes as they are, so the results
equal the plain loop's bit for bit.  Producer exceptions re-raise at the
consuming ``next()`` (``utils.reader.PrefetchIterator``): a failing
reader is an error, not a short epoch.  Meshes are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..utils.reader import PrefetchIterator
from ..utils.sync import RANK_LOADER, OrderedLock
from .executor import CAPTURE_LOCK, _feed_value, _staged, _tensors

__all__ = ["DataLoader", "device_put_feed"]


def _put_value(v, device: torch.device):
    """One feed value on ``device``, normalised as the executor
    normalises a feed (``_feed_value``: dtype narrowing, SeqArray with
    int32 lengths) and copied as ``run_steps`` stages one (``_staged``:
    through pinned memory, asynchronously on the current stream), so a
    prefetched feed is what the synchronous path would have copied."""
    return _staged(_feed_value(v), device)


def device_put_feed(feed: dict, mesh=None, place=None) -> dict:
    """Put a whole feed dict on ``place``'s device (the card by default)
    ahead of the step that consumes it: asynchronous copies on the
    current stream."""
    if mesh is not None:
        raise NotImplementedError("device_put_feed: meshes are not ported "
                                  "to paddle_tpu_torch (ROADMAP A15)")
    device = resolve_device(None if place is None else place.device)
    return {n: _put_value(v, device) for n, v in feed.items()}


class _Staged:
    """A batch copied on the producer's stream, with the event after it."""

    __slots__ = ("feed", "event")

    def __init__(self, feed, event):
        self.feed = feed
        self.event = event


class DataLoader:
    """Bounded device-prefetch input pipeline.

    Parameters
    ----------
    reader: the data source — a zero-arg callable returning an iterator
        (the reference reader convention; re-invoked on every epoch) or
        a plain iterable.  Yields either ready feed dicts, or raw
        batches when ``feeder`` is given.
    feeder: optional converter applied to each reader item on the
        producer thread — a ``fluid.DataFeeder`` (its ``.feed``) or any
        ``batch -> feed dict`` callable.
    capacity: how many converted batches the producer runs ahead.
    device_prefetch: copy each batch to the device on the producer
        thread (on the card: a side stream, pinned memory, an event the
        consumer waits on); when False the loader only overlaps reading
        and host conversion and leaves the copy to the executor.
    place: the device of the prefetch (``CUDAPlace``, ``CPUPlace``; the
        card by default, and without one a prefetching loader raises).
    """

    def __init__(self, reader, feeder=None, capacity: int = 2,
                 device_prefetch: bool = True, place=None):
        if capacity < 1:
            raise ValueError(f"DataLoader capacity must be >= 1, "
                             f"got {capacity}")
        if reader is None or not (callable(reader)
                                  or hasattr(reader, "__iter__")):
            raise ValueError(
                "DataLoader needs a reader (zero-arg callable or "
                f"iterable), got {reader!r}")
        self._reader = reader
        # a bare iterator (iter(x) is x) is one-shot: a second epoch over
        # it would be silently empty, so it raises instead
        self._one_shot = (not callable(reader)
                          and iter(reader) is reader)
        self._state_lock = OrderedLock("pipeline.loader", RANK_LOADER)
        self._exhausted = False
        self._feed_fn: Optional[Callable] = None
        if feeder is not None:
            self._feed_fn = (feeder.feed if hasattr(feeder, "feed")
                             else feeder)
        self.capacity = capacity
        self.device_prefetch = device_prefetch
        self.device = (resolve_device(None if place is None
                                      else place.device)
                       if device_prefetch else None)
        self._stream = None

    def _prepare(self, item):
        """Producer-thread transform: convert + copy one batch."""
        if self._feed_fn is not None:
            item = self._feed_fn(item)
        if not isinstance(item, dict):
            raise TypeError(
                "DataLoader expects the reader (after the feeder, if "
                f"any) to yield feed dicts, got {type(item).__name__}; "
                "pass feeder= to convert raw batches")
        if not self.device_prefetch:
            return dict(item)
        if self.device.type != "cuda":
            return {n: _put_value(v, self.device) for n, v in item.items()}
        with CAPTURE_LOCK, torch.cuda.stream(self._stream):
            feed = {n: _put_value(v, self.device) for n, v in item.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(feed, event)

    def _hand_out(self, item):
        """Consumer side: the batch, ordered after its copy on the
        consumer's stream."""
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for v in item.feed.values():
            for t in _tensors(v):
                t.record_stream(stream)
        return item.feed

    def __iter__(self):
        if self._one_shot:
            with self._state_lock:
                if self._exhausted:
                    raise RuntimeError(
                        "DataLoader reader was a one-shot iterator and "
                        "is already exhausted; pass a zero-arg callable "
                        "(or a re-iterable) for multi-epoch use")
                self._exhausted = True
        if self.device_prefetch and self.device.type == "cuda" \
                and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        src = self._reader() if callable(self._reader) else iter(self._reader)
        it = PrefetchIterator(src, self.capacity, transform=self._prepare)
        try:
            for item in it:
                yield self._hand_out(item)
        finally:
            it.close()
