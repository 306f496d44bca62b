"""Reader helpers — the port of ``paddle_tpu/utils/reader.py``, cut to
``PrefetchIterator``, the building block of the pipeline DataLoader
(fluid/pipeline_io.py).  The reference's reader decorators (``batch``,
``shuffle``, ``buffered``, ``shard`` and the rest) are not ported yet
(ROADMAP A16)."""

from __future__ import annotations

from queue import Empty, Full, Queue
from threading import Event, Thread

__all__ = ["PrefetchIterator"]


class _EndOfStream:
    """Queue sentinel carrying the producer's terminal status: ``error``
    is None on clean exhaustion, else the exception to re-raise in the
    consumer (a failing reader must NOT look like a short epoch)."""

    __slots__ = ("error",)

    def __init__(self, error=None):
        self.error = error


class PrefetchIterator:
    """Pull ``it`` from a background thread through a bounded queue.

    The building block behind ``buffered`` and the pipeline DataLoader
    (fluid/pipeline_io.py): the producer thread stays ``size`` items
    ahead of the consumer, producer exceptions are captured and
    re-raised at the consuming ``next()`` (not swallowed), and closing
    the iterator (or abandoning it) unblocks a producer stuck on a full
    queue via the stop event instead of leaking it on a ``put``.
    """

    def __init__(self, it, size, transform=None):
        self._q: Queue = Queue(maxsize=max(1, int(size)))
        self._stop = Event()
        self._done = False

        def fill():
            try:
                for item in it:
                    if transform is not None:
                        item = transform(item)
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except Full:
                            continue
                    else:
                        return          # consumer went away — drop the tail
            except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
                end = _EndOfStream(e)
            else:
                end = _EndOfStream()
            while not self._stop.is_set():
                try:
                    self._q.put(end, timeout=0.1)
                    break
                except Full:
                    continue

        self._thread = Thread(target=fill, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # producer died without posting a sentinel (should not
                    # happen; belt-and-braces against a hung epoch)
                    self._done = True
                    raise StopIteration from None
        if isinstance(item, _EndOfStream):
            self._done = True
            if item.error is not None:
                raise item.error
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        self._done = True

    def __del__(self):
        self._stop.set()
