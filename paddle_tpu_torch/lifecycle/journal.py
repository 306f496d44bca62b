"""ReleaseJournal — the controller's durable state-machine record; the
port's copy of ``paddle_tpu/lifecycle/journal.py``.

Every release-pipeline transition (candidate discovered, quality-gate
verdict, canary armed, promoted, rolled back, operator directive) is
one appended JSON line, fsynced by default: the journal is what makes
the controller RESTARTABLE.  A controller that comes back after a crash
folds the journal into a ``ReleaseState`` and resumes exactly where it
was — mid-canary means re-arm the canary, never re-promote blind.

Replay follows the gateway-journal discipline (serving/gateway/
journal.py): a torn final line — the crash happened mid-append — is
skipped, not fatal, because the file must be readable at exactly the
moments the process died badly.  Undecodable mid-file lines (a poison
entry) are likewise skipped; every decoded entry carries its line
index as ``_seq`` so directives can be matched to their
``directive-done`` acknowledgements.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..utils.journal import JournalFile

__all__ = ["ReleaseJournal", "ReleaseState", "fold_state"]


class ReleaseJournal:
    """Append-only jsonl of release transitions with fold-based replay.
    The file side (torn-tail sealing, ordered fsynced appends, replay
    reads) is the shared ``utils.journal.JournalFile``, as the gateway's
    RequestJournal's is."""

    def __init__(self, path: str, fsync: bool = True):
        self._file = JournalFile(path, fsync=fsync,
                                 name="lifecycle.journal")

    @property
    def path(self) -> str:
        return self._file.path

    @property
    def fsync(self) -> bool:
        return self._file.fsync

    def append(self, event: str, **fields) -> Dict:
        """Durably record one transition; returns the written entry."""
        entry: Dict = {"event": str(event)}
        entry.update(fields)
        return self._file.append(entry, stamp="t")

    def replay(self) -> List[Dict]:
        """Decoded entries in append order, each with ``_seq`` = its
        line index; torn/poison lines are skipped."""
        out: List[Dict] = []
        for i, line in enumerate(self._file.read_lines()):
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            if not isinstance(entry, dict):
                continue
            entry["_seq"] = i
            out.append(entry)
        return out

    def state(self) -> "ReleaseState":
        return fold_state(self.replay())


class ReleaseState:
    """The journal folded down to what a restarted controller needs."""

    def __init__(self):
        # the version serving as the alias target the last time the
        # loop settled (initial adoption or the latest promotion)
        self.last_good: Optional[str] = None
        self.last_good_score: Optional[float] = None
        # versions that failed a gate or were rolled back: never
        # re-considered (a crash-looping candidate must not be retried
        # forever by a restart-looping controller)
        self.bad: set = set()
        # every version that entered the pipeline (so discovery never
        # re-offers one, whatever its outcome)
        self.seen: set = set()
        # non-None while a canary is (journal says: was) in flight:
        # {"version", "fraction", "seed", "score"}
        self.canary: Optional[Dict] = None
        # operator directives not yet acknowledged by a directive-done
        self.directives: List[Dict] = []

    def to_dict(self) -> Dict:
        return {"last_good": self.last_good,
                "last_good_score": self.last_good_score,
                "bad": sorted(self.bad), "seen": sorted(self.seen),
                "canary": dict(self.canary) if self.canary else None,
                "pending_directives": [dict(d) for d in self.directives]}


def fold_state(entries: List[Dict]) -> ReleaseState:
    """Replay entries into a ReleaseState (pure; order matters)."""
    st = ReleaseState()
    done_directives = set()
    for e in entries:
        ev = e.get("event")
        version = e.get("version")
        if ev == "init":
            if e.get("last_good") is not None:
                st.last_good = str(e["last_good"])
                st.last_good_score = e.get("score")
                st.seen.add(st.last_good)
        elif ev == "candidate" and version is not None:
            st.seen.add(str(version))
        elif ev == "rejected" and version is not None:
            st.bad.add(str(version))
            if st.canary and st.canary.get("version") == str(version):
                st.canary = None
        elif ev == "canary-start" and version is not None:
            st.canary = {"version": str(version),
                         "fraction": float(e.get("fraction", 0.0)),
                         "seed": int(e.get("seed", 0)),
                         "score": e.get("score")}
        elif ev == "promoted" and version is not None:
            st.last_good = str(version)
            if "score" in e:
                st.last_good_score = e["score"]
            st.seen.add(st.last_good)
            st.canary = None
        elif ev == "rollback":
            if version is not None:
                st.bad.add(str(version))
            # rollback always converges the alias onto its target
            # (the stable version for auto-rollback — a no-op — or an
            # operator-chosen older version)
            if e.get("to") is not None:
                st.last_good = str(e["to"])
            st.canary = None
        elif ev == "directive-done":
            done_directives.add(e.get("seq"))
    st.directives = [e for e in entries
                     if e.get("event") == "directive"
                     and e.get("_seq") not in done_directives]
    return st
