"""Shared append-only jsonl journal plumbing — the port's copy of
``paddle_tpu/utils/journal.py``.

The gateway's ``RequestJournal`` is an append-only jsonl file whose
replay tolerates a torn final line (the crash happened mid-append).
Tolerating the torn line on READ is not enough: a successor process
appending onto it would MERGE its first record into the garbage and
lose both — a silently lost request on the following replay.
``terminate_torn_tail`` terminates the torn line once, before the
successor's first append.

``JournalFile`` is the append side: torn-tail sealing on first touch,
line-at-a-time appends with optional fsync, and replay reads — all
serialized by ONE dedicated ``OrderedLock`` (rank ``RANK_JOURNAL_FILE``,
innermost of the journal layer).  The blocking file I/O inside that lock
is the lock's entire purpose: appends must hit the file in submission
order or replay reorders history.  Callers hold no other lock below
rank 52 while appending.

The OrderedLock is per-process only, and one journal file can have
writers in two processes (a respawned replica's ``recover()`` ->
``compact()`` beside another process appending done records).  Every
append/compact/read therefore also holds an exclusive ``flock`` on a
sidecar ``<path>.lock`` file (the sidecar, not the journal itself,
because ``os.replace`` swaps the journal's inode out from under any lock
held on it).  The flock is acquired inside the OrderedLock, so
in-process ordering stays rank-decided and the flock only arbitrates
between processes.  The file format is the reference's, so either
package reads the other's journals.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from .sync import RANK_JOURNAL_FILE, OrderedLock

try:
    import fcntl
except ImportError:             # pragma: no cover - non-POSIX fallback
    fcntl = None

__all__ = ["JournalFile", "terminate_torn_tail"]


def terminate_torn_tail(path: str) -> bool:
    """If ``path`` exists and does not end with a newline, append one
    so the torn final line is sealed off as its own (skippable) record.
    Returns True when a torn tail was terminated.  Callers gate this to
    once per journal instance; the caller holds any write lock."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() == 0:
                return False
            f.seek(-1, os.SEEK_END)
            torn = f.read(1) != b"\n"
    except OSError:
        return False
    if torn:
        with open(path, "a", encoding="utf-8") as f:
            f.write("\n")
    return torn


class JournalFile:
    """The file half of an append-only jsonl journal: ordered appends
    (optionally fsynced), torn-tail sealing before the first append,
    and whole-file reads for replay — all under one dedicated lock."""

    def __init__(self, path: str, fsync: bool = False,
                 name: str = "journal"):
        self.path = str(path)
        self.fsync = bool(fsync)
        self._lock = OrderedLock(f"{name}.file", RANK_JOURNAL_FILE)
        self._lock_path = self.path + ".lock"
        self._tail_checked = False
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    @contextmanager
    def _oslock(self):
        """The cross-process half of the journal lock: an exclusive
        flock on the sidecar lock file, held for the duration of one
        append/compact/read.  See the module docstring for why the
        in-process OrderedLock alone is not enough."""
        if fcntl is None:               # pragma: no cover - non-POSIX
            yield
            return
        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)        # closing the fd releases the flock

    def append(self, entry: Dict, stamp: Optional[str] = None) -> Dict:
        """Append one JSON record as a single line (``stamp`` adds a
        wall-clock field of that name); returns the written entry.  The
        append — including the optional fsync — runs under the journal
        lock so concurrent writers can never interleave bytes or
        reorder lines relative to their lock acquisition order."""
        if stamp:
            entry = dict(entry)
            entry[stamp] = time.time()
        line = json.dumps(entry, separators=(",", ":")) + "\n"
        with self._lock:  # syncheck: ok — dedicated journal I/O lock
            with self._oslock():
                if not self._tail_checked:
                    # a predecessor that died mid-append leaves a torn
                    # final line; appending onto it would merge this
                    # record into the garbage and lose both
                    self._tail_checked = True
                    terminate_torn_tail(self.path)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                    f.flush()
                    if self.fsync:
                        os.fsync(f.fileno())
        return entry

    def compact(self, transform) -> List[str]:
        """Atomically rewrite the journal as ``transform(lines)`` (a
        pure function over raw lines, each newline-terminated): sibling
        temp file, flush+fsync, rename over.  The compaction primitive:
        a crash at ANY point leaves either the old
        complete journal or the new one, never a half-written mix, and
        the rename publishes only what was fsynced (the
        CheckpointManager plain-write rule).  Read, filter, and swap
        all run under ONE acquisition of the journal lock AND one
        continuous flock, so a concurrent append — from another thread
        or another PROCESS (a router migrating this journal while its
        owner respawns) — can never land in the window between the
        snapshot read and the swap-in and be silently rewritten away.
        Returns the kept lines."""
        tmp = self.path + ".compact"
        with self._lock:  # syncheck: ok — dedicated journal I/O lock
            with self._oslock():
                if os.path.exists(self.path):
                    with open(self.path, "r", encoding="utf-8") as f:
                        lines = f.readlines()
                else:
                    lines = []
                kept = list(transform(lines))
                with open(tmp, "w", encoding="utf-8") as f:
                    f.writelines(kept)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                # the rewrite wrote whole lines only — a predecessor's
                # torn tail (if any) dropped with the rest of the file
                self._tail_checked = True
        return kept

    def read_lines(self) -> List[str]:
        """Raw journal lines for replay (missing file = empty).  Held
        under the lock (and the cross-process flock) so a reader never
        observes a torn in-flight append from a concurrent writer."""
        with self._lock:  # syncheck: ok — dedicated journal I/O lock
            with self._oslock():
                if not os.path.exists(self.path):
                    return []
                with open(self.path, "r", encoding="utf-8") as f:
                    return f.readlines()
