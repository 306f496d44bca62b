"""Session KV persistence — the port of ``paddle_tpu/serving/sessions.py``:
suspended conversations as checksummed artifacts.

A suspended lane's pages, lengths and position become ONE framed,
fingerprint-keyed, sha256-checksummed artifact (magic + JSON header +
blob, written tmp file + fsync + atomic rename), held in a bytes-capped
host-RAM LRU and optionally mirrored to disk so sessions survive a
process restart.  The framing is the reference's byte for byte: an
artifact written by either package loads in the other.

Integrity contract: a torn, flipped or truncated artifact — including
one torn by the seeded ``kv.spill_corrupt`` chaos point — fails the
checksum and loads as a MISS.  The scheduler then degrades the resume
to a fresh prefill of the recorded prompt: greedy decoding is
deterministic, so a corrupt spill costs latency, never wrong tokens.

Array framing is dtype-faithful: each array serializes as (name,
dtype name, shape, raw bytes) with the index in the JSON header.  numpy
has no bfloat16 of its own, and the port does not need ``ml_dtypes``: a
bf16 slab is a CPU ``torch.bfloat16`` tensor here, framed as its 16-bit
patterns under the dtype name ``"bfloat16"`` (what the reference writes
for an ``ml_dtypes`` array), and a ``"bfloat16"`` array loads back as
such a tensor.  An ``ml_dtypes`` bfloat16 array (a JAX caller's) frames
the same way.

Locking: one ``serving.sessions`` OrderedLock (RANK_SESSIONS, above the
scheduler's rank, but never nested inside it: the scheduler only
touches this store from its serve-loop maintenance slice, outside its
own lock) guards the host dict and counters.  All disk I/O happens
outside the lock.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fluid.io import _array_from, _host_array
from ..utils.sync import RANK_COLLECTOR_INIT, RANK_SESSIONS, OrderedLock

__all__ = ["SessionStore", "SESSION_MAGIC"]

SESSION_MAGIC = b"PDLKVS1\n"
_SUFFIX = ".kvs"

_LIVE_STORES: "weakref.WeakSet[SessionStore]" = weakref.WeakSet()
_collector_lock = OrderedLock("obs.collector_init", RANK_COLLECTOR_INIT)
_collector_registered = [False]


def _encode(a) -> Tuple[str, List[int], bytes]:
    """One array's (dtype name, shape, raw bytes), by ``fluid.io``'s
    encoding (a CPU bf16 tensor as its 16-bit patterns under
    ``"bfloat16"``); any other value as the reference's ``_frame`` takes
    it, through ``np.ascontiguousarray`` (which makes a 0-d array 1-d)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return _host_array(a)
        a = a.detach().cpu().numpy()
    return _host_array(np.ascontiguousarray(a))


def _frame(sid: str, fingerprint: str, meta: Dict[str, Any],
           arrays: Dict[str, Any]) -> bytes:
    """One self-contained artifact: magic + JSON header + raw blob.
    The header carries the array index (name/dtype/shape/nbytes) and
    the sha256 of the blob; the blob is the arrays' bytes concatenated
    in index order — bitwise-exact for any dtype."""
    index: List[List[Any]] = []
    parts: List[bytes] = []
    for name in sorted(arrays):
        dtype, shape, raw = _encode(arrays[name])
        index.append([name, dtype, shape, len(raw)])
        parts.append(raw)
    blob = b"".join(parts)
    header = json.dumps({
        "sid": sid, "fingerprint": fingerprint, "meta": meta,
        "arrays": index, "sha256": hashlib.sha256(blob).hexdigest(),
        "blob_bytes": len(blob), "created": time.time(),
    }, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return SESSION_MAGIC + header + b"\n" + blob


def _unframe(raw: bytes, sid: str, fingerprint: str
             ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Verify + decode one artifact; None on ANY integrity or identity
    failure (bad magic, torn header, sid/fingerprint mismatch, length
    or checksum mismatch) — the caller treats None as a miss."""
    if not raw.startswith(SESSION_MAGIC):
        return None
    try:
        head_end = raw.index(b"\n", len(SESSION_MAGIC))
        header = json.loads(raw[len(SESSION_MAGIC):head_end].decode("utf-8"))
        blob = raw[head_end + 1:]
    except (ValueError, UnicodeDecodeError):
        return None
    if header.get("sid") != sid:
        return None
    if len(blob) != header.get("blob_bytes"):
        return None
    if hashlib.sha256(blob).hexdigest() != header.get("sha256"):
        return None
    arrays: Dict[str, Any] = {}
    off = 0
    try:
        for name, dtype, shape, nbytes in header["arrays"]:
            arrays[name] = _array_from(blob[off:off + nbytes], dtype, shape)
            off += nbytes
    except Exception:
        return None
    if off != len(blob):
        return None
    if header.get("fingerprint") != fingerprint:
        # integrity is fine but the artifact belongs to a different
        # model/geometry — a stale-config miss, distinct from corruption
        return "stale", {}
    return dict(header.get("meta") or {}), arrays


class SessionStore:
    """Suspended-session artifacts: host-RAM LRU + optional disk mirror.

    ``put`` frames and checksums the lane state, keeps the raw bytes in
    a ``host_bytes``-capped LRU, and (when ``dirname`` is set) durably
    mirrors them to disk — so an LRU- or idle-spilled host copy is a
    *demotion to disk*, not a loss.  ``get`` re-verifies the frame on
    every load (host copies included: one integrity contract for both
    tiers) and returns ``(meta, arrays)`` or None.
    """

    def __init__(self, dirname: Optional[str] = None,
                 host_bytes: int = 256 << 20,
                 idle_spill_s: Optional[float] = None):
        self.dirname = str(dirname) if dirname else None
        self.host_bytes = int(host_bytes)
        self.idle_spill_s = idle_spill_s
        # sid -> (raw bytes, last-touch monotonic); insertion order = LRU
        self._host: "OrderedDict[str, Tuple[bytes, float]]" = OrderedDict()
        self._host_used = 0
        self._lock = OrderedLock("serving.sessions", RANK_SESSIONS)
        self._stats = {"suspends": 0, "resumes": 0, "resume_misses": 0,
                       "corrupt": 0, "idle_spills": 0, "host_evictions": 0,
                       "deletes": 0, "spilled_bytes": 0, "fetched_bytes": 0}
        _LIVE_STORES.add(self)
        _register_session_collector()

    # -- paths ---------------------------------------------------------------
    def _path(self, sid: str) -> Optional[str]:
        if not self.dirname:
            return None
        safe = hashlib.sha256(sid.encode("utf-8")).hexdigest()
        return os.path.join(self.dirname, safe + _SUFFIX)

    # -- store ---------------------------------------------------------------
    def put(self, sid: str, fingerprint: str, meta: Dict[str, Any],
            arrays: Dict[str, Any]) -> bool:
        """Suspend: frame + checksum the lane state under ``sid``.
        Host copy always; disk mirror when a directory is mounted.
        Framing and disk I/O run outside the store lock."""
        raw = _frame(sid, fingerprint, meta, arrays)
        with self._lock:
            if sid in self._host:
                self._host_used -= len(self._host.pop(sid)[0])
            while (self._host and
                   self._host_used + len(raw) > self.host_bytes):
                _, (old_raw, _) = self._host.popitem(last=False)
                self._host_used -= len(old_raw)
                self._stats["host_evictions"] += 1
            if len(raw) <= self.host_bytes:
                self._host[sid] = (raw, time.monotonic())
                self._host_used += len(raw)
            self._stats["suspends"] += 1
            self._stats["spilled_bytes"] += len(raw)
        # LRU-evicted sessions keep their disk mirror (demote, not drop);
        # without a disk tier they are genuinely gone — sized by knob.
        path = self._path(sid)
        if path is None:
            return True
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            os.makedirs(self.dirname, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        return True

    # -- load ----------------------------------------------------------------
    def get(self, sid: str, fingerprint: str
            ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Resume: load + verify the artifact.  None on miss OR on any
        integrity failure (the corrupt copy is dropped from both tiers
        so the session degrades to re-prefill exactly once)."""
        with self._lock:
            entry = self._host.get(sid)
            if entry is not None:
                self._host.move_to_end(sid)
                self._host[sid] = (entry[0], time.monotonic())
            raw = entry[0] if entry is not None else None
        from_disk = False
        path = self._path(sid)
        if raw is None and path is not None:
            try:
                with open(path, "rb") as f:
                    raw = f.read()
                from_disk = True
            except OSError:
                raw = None
        if raw is None:
            with self._lock:
                self._stats["resume_misses"] += 1
            return None
        # chaos point (`kv.spill_corrupt`): a seeded torn artifact —
        # the checksum must turn it into a miss (degrade to re-prefill),
        # never into wrong KV bytes on the device
        from ..resilience.chaos import injector

        if injector().should("kv.spill_corrupt") and \
                len(raw) > len(SESSION_MAGIC):
            raw = raw[:len(raw) // 2]
        decoded = _unframe(raw, sid, fingerprint)
        if decoded is None:
            self._drop(sid, path)
            with self._lock:
                self._stats["corrupt"] += 1
                self._stats["resume_misses"] += 1
            return None
        if decoded[0] == "stale":
            with self._lock:
                self._stats["resume_misses"] += 1
            return None
        with self._lock:
            self._stats["resumes"] += 1
            self._stats["fetched_bytes"] += len(raw)
            if from_disk:       # promote the disk copy back to host RAM
                if sid not in self._host and len(raw) <= self.host_bytes:
                    self._host[sid] = (raw, time.monotonic())
                    self._host_used += len(raw)
        return decoded

    def _drop(self, sid: str, path: Optional[str]) -> None:
        with self._lock:
            entry = self._host.pop(sid, None)
            if entry is not None:
                self._host_used -= len(entry[0])
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def delete(self, sid: str) -> None:
        self._drop(sid, self._path(sid))
        with self._lock:
            self._stats["deletes"] += 1

    def has(self, sid: str) -> bool:
        with self._lock:
            if sid in self._host:
                return True
        path = self._path(sid)
        return path is not None and os.path.exists(path)

    # -- idle spill ----------------------------------------------------------
    def spill_idle(self, max_idle_s: Optional[float] = None) -> int:
        """Drop host-RAM copies idle longer than ``max_idle_s`` (default:
        the ctor's ``idle_spill_s``).  With a disk mirror this demotes to
        disk; without one the idle session is gone (re-prefill on next
        turn).  Returns the number spilled — the gateway's suspend-on-
        idle sweep calls this from its stats/maintenance path."""
        limit = self.idle_spill_s if max_idle_s is None else max_idle_s
        if limit is None:
            return 0
        now = time.monotonic()
        with self._lock:
            stale = [sid for sid, (_, t) in self._host.items()
                     if now - t > limit]
            for sid in stale:
                self._host_used -= len(self._host.pop(sid)[0])
            self._stats["idle_spills"] += len(stale)
        return len(stale)

    # -- accounting ----------------------------------------------------------
    def check_invariants(self) -> None:
        with self._lock:
            assert self._host_used == sum(
                len(r) for r, _ in self._host.values())
            assert self._host_used >= 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["host_sessions"] = len(self._host)
            out["host_bytes_used"] = self._host_used
        out["host_bytes"] = self.host_bytes
        if self.dirname and os.path.isdir(self.dirname):
            try:
                out["disk_sessions"] = sum(
                    1 for n in os.listdir(self.dirname)
                    if n.endswith(_SUFFIX))
            except OSError:
                out["disk_sessions"] = 0
        else:
            out["disk_sessions"] = 0
        return out


# -- telemetry ----------------------------------------------------------------
def _collect_session_metrics():
    from ..observability.metrics import Sample

    tiers = {"host": 0, "disk": 0}
    events = {"suspend": 0, "resume": 0, "resume_miss": 0, "corrupt": 0,
              "idle_spill": 0, "host_evict": 0, "delete": 0}
    moved = {"spill": 0, "fetch": 0}
    for s in list(_LIVE_STORES):
        try:
            st = s.stats()
        except Exception:
            continue
        tiers["host"] += st["host_sessions"]
        tiers["disk"] += st["disk_sessions"]
        events["suspend"] += st["suspends"]
        events["resume"] += st["resumes"]
        events["resume_miss"] += st["resume_misses"]
        events["corrupt"] += st["corrupt"]
        events["idle_spill"] += st["idle_spills"]
        events["host_evict"] += st["host_evictions"]
        events["delete"] += st["deletes"]
        moved["spill"] += st["spilled_bytes"]
        moved["fetch"] += st["fetched_bytes"]
    for tier, v in tiers.items():
        yield Sample("paddle_kv_sessions", "gauge", (("tier", tier),),
                     float(v), "Suspended KV sessions resident per tier")
    for ev, v in events.items():
        yield Sample("paddle_kv_session_events_total", "counter",
                     (("event", ev),), float(v),
                     "Session suspend/resume lifecycle events")
    for d, v in moved.items():
        yield Sample("paddle_kv_session_bytes_total", "counter",
                     (("dir", d),), float(v),
                     "Bytes moved suspending/resuming session KV")


def _register_session_collector() -> None:
    with _collector_lock:
        if _collector_registered[0]:
            return
        from ..observability.metrics import registry

        registry().register_collector(_collect_session_metrics)
        _collector_registered[0] = True
