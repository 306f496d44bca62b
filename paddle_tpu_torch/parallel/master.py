"""Elastic data dispatch — the master task-queue service; the port's
copy of ``paddle_tpu/parallel/master.py``.

The analog of the reference's Go master (go/master/service.go):
the dataset is partitioned into task chunks (SetDataset :280), workers
lease tasks (GetTask :368) under a timeout, report TaskFinished (:411) /
TaskFailed (:455), timed-out leases are re-dispatched to surviving
workers (checkTimeoutFunc :341), tasks failing more than `failure_max`
times are discarded (processFailedTask :313), and the queue state
snapshots to disk for master recovery (snapshot/recover :166-207 — etcd
in the reference, an atomic CRC'd file here since one process owns the
queue).

The executor never sees any of this: `master_reader` wraps a queue into
an ordinary record iterator, so elastic dispatch composes with
paddle.batch / DataFeeder like any other reader — the cloud_reader
contract (python/paddle/v2/reader/creator.py:91).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Iterable, List, Optional, Sequence

from ..utils.sync import RANK_MASTER_QUEUE, OrderedLock

__all__ = ["Task", "TaskQueue", "master_reader"]


class Task:
    __slots__ = ("task_id", "chunk", "epoch", "num_failures", "deadline",
                 "owner")

    def __init__(self, task_id: int, chunk, epoch: int = 0):
        self.task_id = task_id
        self.chunk = chunk
        self.epoch = epoch
        self.num_failures = 0
        self.deadline = None      # lease expiry (monotonic) while pending
        self.owner = None

    def meta(self):
        return {"task_id": self.task_id, "epoch": self.epoch,
                "num_failures": self.num_failures}


class TaskQueue:
    """Thread-safe todo/pending/done/failed task accounting with lease
    timeouts — Service in go/master/service.go:89."""

    def __init__(self, timeout_secs: float = 60.0, failure_max: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self._timeout = float(timeout_secs)
        self._failure_max = int(failure_max)
        self._clock = clock
        self._lock = OrderedLock("master.queue", RANK_MASTER_QUEUE)
        self._todo: List[Task] = []
        self._pending = {}          # task_id -> Task
        self._done: List[Task] = []
        self._failed: List[Task] = []
        self._epoch = 0
        # bumped on every change to the DURABLE image (what snapshot()
        # writes): finishes, failures/timeouts, dataset/epoch changes —
        # NOT bare leases, which snapshot as todo anyway.  Lets the
        # auto-snapshotting MasterServer skip snapshots when nothing
        # durable moved (idle polls stay fsync-free).
        self._version = 0

    # -- dataset -------------------------------------------------------------
    def set_dataset(self, chunks: Sequence) -> None:
        """Partition: one task per chunk (SetDataset :280).

        Chunks must be JSON values — queue state snapshots through JSON,
        so non-JSON payloads (numpy arrays, custom objects) are rejected
        here rather than failing later at snapshot time. Chunks are
        round-tripped through JSON immediately so read_chunk sees the
        SAME types before and after a master recovery (tuples become
        lists up front, not only on restore).
        """
        def check_keys(x):
            # json.dumps silently stringifies non-string dict keys — the
            # one lossy change allow_nan=False doesn't already reject
            if isinstance(x, dict):
                for k, v in x.items():
                    if not isinstance(k, str):
                        raise TypeError(
                            "TaskQueue chunk dicts need string keys "
                            f"(got {k!r}): JSON stringifies them, so "
                            "read_chunk would see different keys after "
                            "a master recovery")
                    check_keys(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    check_keys(v)

        original = list(chunks)
        check_keys(original)
        try:
            chunks = json.loads(json.dumps(original, allow_nan=False))
        except (TypeError, ValueError) as e:
            raise TypeError(
                "TaskQueue chunks must be JSON values (file paths, index "
                "ranges, lists of records; string dict keys, finite "
                f"floats): {e}") from e
        with self._lock:
            self._todo = [Task(i, c, self._epoch)
                          for i, c in enumerate(chunks)]
            self._pending.clear()
            self._done.clear()
            self._failed.clear()
            self._version += 1

    # -- worker protocol -----------------------------------------------------
    def get_task(self, worker: str = "") -> Optional[Task]:
        """Lease the next task (GetTask :368); None when nothing is
        dispatchable right now (pending leases may still time out and
        come back — use all_done() to distinguish exhaustion)."""
        with self._lock:
            self._check_timeouts_locked()
            if not self._todo:
                return None
            t = self._todo.pop(0)
            t.deadline = self._clock() + self._timeout
            t.owner = worker
            self._pending[t.task_id] = t
            return t

    def task_finished(self, task_id: int) -> bool:
        """TaskFinished :411; False for unknown/expired leases."""
        with self._lock:
            t = self._pending.pop(task_id, None)
            if t is None:
                return False
            t.deadline = t.owner = None
            self._done.append(t)
            self._version += 1
            return True

    def task_failed(self, task_id: int) -> bool:
        """TaskFailed :455 → processFailedTask :313: requeue until the
        failure budget is spent, then discard."""
        with self._lock:
            t = self._pending.pop(task_id, None)
            if t is None:
                return False
            self._fail_locked(t)
            return True

    def task_returned(self, task_id: int, worker: str = "") -> bool:
        """Graceful lease hand-back (a worker shutting down cleanly
        mid-chunk, e.g. a bounded ResilientTrainer run): the chunk goes
        to the FRONT of todo with NO failure charge — the worker didn't
        fail, it stopped.  False for unknown/expired leases, and for a
        lease that has since been re-dispatched to a DIFFERENT worker
        (the ``worker`` check stops a late hand-back from revoking
        someone else's live lease)."""
        with self._lock:
            t = self._pending.get(task_id)
            if t is None or (worker and t.owner != worker):
                return False
            del self._pending[task_id]
            t.deadline = t.owner = None
            self._todo.insert(0, t)
            # no version bump: pending already snapshots as todo, so the
            # durable image is unchanged
            return True

    def _fail_locked(self, t: Task) -> None:
        t.num_failures += 1
        t.deadline = t.owner = None
        self._version += 1
        if t.num_failures >= self._failure_max:
            self._failed.append(t)
        else:
            self._todo.append(t)

    def _check_timeouts_locked(self) -> None:
        now = self._clock()
        expired = [t for t in self._pending.values()
                   if t.deadline is not None and t.deadline <= now]
        for t in expired:       # checkTimeoutFunc :341
            del self._pending[t.task_id]
            self._fail_locked(t)

    def check_timeouts(self) -> int:
        with self._lock:
            before = len(self._pending)
            self._check_timeouts_locked()
            return before - len(self._pending)

    # -- state ---------------------------------------------------------------
    def all_done(self) -> bool:
        with self._lock:
            self._check_timeouts_locked()
            return not self._todo and not self._pending

    def counts(self):
        with self._lock:
            return {"todo": len(self._todo), "pending": len(self._pending),
                    "done": len(self._done), "failed": len(self._failed),
                    "epoch": self._epoch}

    @property
    def version(self) -> int:
        """Durable-image version (see __init__); compare across calls to
        detect whether a snapshot would differ from the last one."""
        with self._lock:
            return self._version

    def new_epoch(self) -> None:
        """All tasks processed → recycle done tasks for the next pass
        (the reference's epoch rollover when todo+pending drain)."""
        with self._lock:
            if self._todo or self._pending:
                # a real exception, not an assert: under python -O an
                # assert would vanish and the rollover below would
                # silently DISCARD the undispatched chunks — and the
                # master client's no-retry /new_epoch contract leans on
                # this tripping for a re-sent rollover
                raise RuntimeError("epoch rollover with undispatched "
                                   "work (todo=%d pending=%d)"
                                   % (len(self._todo), len(self._pending)))
            self._epoch += 1
            for t in self._done:
                t.epoch = self._epoch
                t.num_failures = 0
            self._todo = self._done
            self._done = []
            self._version += 1

    # -- snapshot / recover (reference: master state in etcd :166-207) -------
    def snapshot(self, path: str) -> None:
        from ..fluid.io import _atomic_write, frame_bytes

        with self._lock:
            # pending leases snapshot as todo: after a master restart the
            # worker's lease is unverifiable, so the task re-runs
            state = {
                "epoch": self._epoch,
                "timeout": self._timeout,
                "failure_max": self._failure_max,
                "todo": [t.meta() | {"chunk": t.chunk} for t in
                         self._todo + list(self._pending.values())],
                "done": [t.meta() | {"chunk": t.chunk}
                         for t in self._done],
                "failed": [t.meta() | {"chunk": t.chunk}
                           for t in self._failed],
            }
        _atomic_write(path, frame_bytes(json.dumps(state).encode()))

    @classmethod
    def recover(cls, path: str) -> "TaskQueue":
        from ..fluid.io import unframe_bytes

        with open(path, "rb") as f:
            state = json.loads(unframe_bytes(f.read(), path))
        q = cls(timeout_secs=state["timeout"],
                failure_max=state["failure_max"])
        q._epoch = state["epoch"]

        def mk(d):
            t = Task(d["task_id"], d["chunk"], d["epoch"])
            t.num_failures = d["num_failures"]
            return t

        q._todo = [mk(d) for d in state["todo"]]
        q._done = [mk(d) for d in state["done"]]
        q._failed = [mk(d) for d in state["failed"]]
        return q


def master_reader(queue: TaskQueue, read_chunk: Callable[[object], Iterable],
                  worker: str = "worker-0", poll_interval: float = 0.05,
                  max_polls: Optional[int] = None):
    """Reader over a TaskQueue — the cloud_reader analog: lease a task,
    yield its records, mark finished; a crash mid-chunk simply never
    finishes the lease, and the chunk re-dispatches after the timeout.

    Delivery is **at-least-once**: if a worker dies (or times out) after
    consuming part of a chunk, the lease expires and the whole chunk
    re-dispatches, so records of partially-consumed chunks can be
    yielded again — same contract as the reference master's timeout
    retry (go/master/service.go:341). Make per-record side effects
    idempotent, or batch at chunk granularity.

    Only read_chunk's own iteration is guarded: an exception the
    *consumer* throws into the generator (gen.throw / gen.close)
    propagates instead of being miscounted as a chunk failure.

    Chaos harness hook: each acquired lease is reported to the process
    fault injector (resilience/chaos.py), whose kill-after-N-tasks mode
    SIGKILLs the worker mid-chunk — exactly the death this reader's
    lease-timeout contract exists to survive.  Inert unless configured.
    """
    from ..resilience.chaos import injector

    def reader():
        polls = 0
        while True:
            task = queue.get_task(worker)
            if task is None:
                if queue.all_done():
                    return
                polls += 1
                if max_polls is not None and polls > max_polls:
                    return
                time.sleep(poll_interval)   # leases outstanding elsewhere
                continue
            polls = 0
            injector().note_lease()
            try:
                it = iter(read_chunk(task.chunk))
            except Exception:
                queue.task_failed(task.task_id)
                continue
            while True:
                try:
                    record = next(it)
                except StopIteration:
                    queue.task_finished(task.task_id)
                    break
                except Exception:
                    queue.task_failed(task.task_id)
                    break
                yield record    # consumer exceptions propagate from here

    return reader
