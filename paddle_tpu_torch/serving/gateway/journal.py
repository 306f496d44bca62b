"""Durable request journal: the gateway's no-lost-requests contract —
the port's copy of ``paddle_tpu/serving/gateway/journal.py``.

Every ACCEPTED request is appended to a jsonl journal
before it enters the scheduler queue, and marked done when its response
is delivered.  A gateway process that wedges and is restarted by the
supervised launcher replays the journal on startup and
resubmits every entry without a ``done`` record — queued and in-flight
requests ride across the restart instead of vanishing with the process.

Entries are self-contained (tenant, model alias, prompt tokens,
max_new), so replay needs nothing but the journal file and a registry
with the same model aliases loaded.  Writes are append-only single
lines through the shared ``utils.journal.JournalFile`` (one
audited home for journal I/O-under-its-own-lock); ``fsync=True`` makes
each append durable at the cost of one fsync per request (the
CheckpointManager plain-write rule: publish nothing you have not
flushed).  The file format is the reference's: each package's
``pending()`` reads the other's journals."""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ...utils.journal import JournalFile
from ...utils.sync import RANK_JOURNAL_CV, OrderedCondition

__all__ = ["RequestJournal"]


class RequestJournal:
    """Append-only jsonl of request lifecycles with replay.

    ``record_submit`` is synchronous — the durability point is BEFORE
    the request queues.  ``record_done`` is asynchronous (a background
    writer drains a queue): it is called from the scheduler's
    completion callback, which runs under the scheduler lock, and a
    file write there would stall admission behind the filesystem.  The
    at-least-once model absorbs the weaker ordering: a done record lost
    to a crash merely replays one already-answered request.  A ``done``
    can never precede its ``submit`` in the file: the submit is
    appended synchronously before the request enters the scheduler, so
    the completion callback — the only producer of the done record —
    cannot run until the submit line is durable (the race harness
    asserts this under seeded preemption)."""

    _uniq = itertools.count(1)

    def __init__(self, path: str, fsync: bool = False,
                 compact_bytes: Optional[int] = 1 << 20):
        self._file = JournalFile(path, fsync=fsync,
                                 name="gateway.journal")
        # size threshold for opportunistic compaction: the jsonl
        # otherwise grows without bound across restarts (done records
        # are never pruned).  None disables; recover() compacts anyway.
        self._compact_bytes = (None if compact_bytes is None
                               else int(compact_bytes))
        # pid-qualified ids: rids restart at 1 in a respawned process,
        # and a replayed entry must never collide with a fresh one
        self._prefix = f"{os.getpid()}"
        # async done-record writer state
        self._cv = OrderedCondition(name="gateway.journal.cv",
                                    rank=RANK_JOURNAL_CV)
        self._done_q: deque = deque()
        self._writing = False
        self._writer: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return self._file.path

    @property
    def fsync(self) -> bool:
        return self._file.fsync

    def new_jid(self) -> str:
        return f"{self._prefix}-{next(RequestJournal._uniq)}"

    # -- lifecycle records ---------------------------------------------------
    def record_submit(self, jid: str, tenant: str, model: str,
                      prompt, max_new: int,
                      decode: Optional[Dict] = None,
                      tag: Optional[str] = None,
                      session: Optional[str] = None) -> None:
        entry = {"op": "submit", "jid": jid, "tenant": tenant,
                 "model": model, "prompt": [int(t) for t in prompt],
                 "max_new": int(max_new)}
        if session is not None:
            # tiered-KV session id: replay re-attaches the
            # request to its suspended KV — resumed when the artifact
            # survived the restart, a plain re-prefill when it did not
            entry["session"] = str(session)
        if decode is not None:
            # per-request decode options (draft on/off +
            # constraint spec) are plain JSON, so a replayed request
            # decodes under the SAME grammar it was admitted with
            entry["decode"] = decode
        if tag is not None:
            # opaque caller correlation id (the fleet router
            # stamps its own tag so a migration can tell which journal
            # entries belong to proxy calls it is already retrying)
            entry["tag"] = str(tag)
        self._file.append(entry, stamp="t")

    def record_done(self, jid: str, ok: bool = True,
                    error: Optional[str] = None) -> None:
        """Queue a done record for the background writer (non-blocking —
        safe under the scheduler lock).  ``flush()`` waits it out."""
        entry: Dict = {"op": "done", "jid": jid, "ok": bool(ok)}
        if error:
            entry["error"] = str(error)
        with self._cv:
            self._done_q.append(entry)
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._drain, daemon=True,
                    name="journal-writer")
                self._writer.start()
            self._cv.notify_all()

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._done_q:
                    self._cv.notify_all()     # flushers: queue is dry
                    self._cv.wait()
                batch = list(self._done_q)
                self._done_q.clear()
                self._writing = True
            # file I/O OUTSIDE the cv: appends go through the journal's
            # own file lock; the cv only hands batches over
            for entry in batch:
                try:
                    self._file.append(entry)
                except Exception:
                    pass    # a failed done-append = one extra replay
            with self._cv:
                self._writing = False
                self._cv.notify_all()
            # opportunistic compaction at the size threshold — here in
            # the writer (never under the cv, never on the submit path)
            # so a long-lived gateway prunes its own done-record churn
            # instead of growing the file one line per request forever
            if self._compact_bytes is not None:
                try:
                    if os.path.getsize(self.path) >= self._compact_bytes:
                        self._compact_file()
                except OSError:
                    pass

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until queued done records hit the file (False on
        timeout).  ``pending()`` flushes first, so replay decisions and
        stats always see a settled journal."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._done_q or self._writing:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
        return True

    # -- compaction ----------------------------------------------------------
    @staticmethod
    def _keep_incomplete(lines: List[str]) -> List[str]:
        """The compaction filter: keep only submit lines with no done
        record, in submission order.  Garbage lines (the torn tail a
        crash left) and settled submit/done pairs drop together."""
        done = set()
        parsed = []
        for line in lines:
            s = line.strip()
            if not s:
                continue
            try:
                entry = json.loads(s)
            except ValueError:
                continue
            parsed.append((s, entry))
            if entry.get("op") == "done":
                done.add(entry.get("jid"))
        kept, seen = [], set()
        for s, entry in parsed:
            jid = entry.get("jid")
            if (entry.get("op") == "submit" and jid is not None
                    and jid not in done and jid not in seen):
                seen.add(jid)
                kept.append(s + "\n")
        return kept

    def _compact_file(self) -> Dict[str, int]:
        before = len(self._file.read_lines())
        kept = self._file.compact(RequestJournal._keep_incomplete)
        return {"kept": len(kept), "dropped": max(0, before - len(kept))}

    def compact(self) -> Dict[str, int]:
        """Atomically rewrite the journal keeping only incomplete
        entries: replay input is unchanged, the unbounded
        done-record history is gone.  Called by ``Gateway.recover()``
        and from the background writer past ``compact_bytes``.  Returns
        ``{"kept", "dropped"}`` line counts."""
        self.flush()
        return self._compact_file()

    # -- recovery ------------------------------------------------------------
    def pending(self) -> List[Dict]:
        """Submit entries with no matching done record, in submission
        order — what a restarted gateway resubmits.  A torn final line
        (crash mid-append) is skipped, not fatal: the journal must be
        readable at exactly the moments the process died badly."""
        self.flush()
        submits: Dict[str, Dict] = {}
        order: List[str] = []
        for line in self._file.read_lines():
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            jid = entry.get("jid")
            if entry.get("op") == "submit" and jid is not None:
                if jid not in submits:
                    order.append(jid)
                submits[jid] = entry
            elif entry.get("op") == "done" and jid in submits:
                del submits[jid]
        return [submits[j] for j in order if j in submits]

    def stats(self) -> Dict[str, object]:
        return {"path": self.path, "pending": len(self.pending()),
                "fsync": self.fsync}
