"""Persistent compile cache: what a step signature needs, as an artifact —
the port of ``paddle_tpu/fluid/compile_cache.py``, redesigned for the
card.

The reference stores PJRT-serialized executables.  A captured CUDA graph
cannot be stored: its kernel addresses, the caching allocator's pools
and the buffers it reads belong to one process.  What the port can ship
is what its one true compile produces, and what a signature's dispatch
is derived from:

* **per entry**, a checksummed record of the dispatch signature and its
  plan: the mode, the feed and state shapes and dtypes, the fetch list
  (the executor's in-memory cache key), the executor's ``BlockPlan``
  classification (live ops, state in and out, seed salts, host ops,
  host loops, prints) and the kernel libraries the step launched;
* **per kernel library** the step launches, a checksummed copy of the
  ``nvcc``-built ``lib<name>-<digest>.so`` (``kernels/_build``), which
  ``_build.load_library`` restores before it would run ``nvcc``.

**Keys** are sha256 over canonical JSON of the executor's in-memory key
and the salt.  The **salt** holds the torch version and
``torch.version.cuda``, the device's name, compute capability and
count, the kernel sources' digests, and ``extra_salt``.  A stale salt,
a torn or corrupt entry, or a library copy whose checksum does not
match is a **miss**: the step runs and captures as without a cache, the
library is rebuilt, and both are stored over the bad ones.  Nothing
unchecked is ever loaded, and a miss never falls back to a plain kernel.

**Hit, miss and compile** (``Executor.cache_stats()["persistent"]``):
a hit loads the record (checked against the plan the executor derives)
and every library it names from disk; a miss — the count
``tools/aot_compile`` reports as compiles and
``InferenceEngine.preresolve(stop_on_compile=True)`` stops at — is a
signature whose record was not on disk or not sound, or a step that had
to build a library.  A warm start still runs one eager step and one
capture per signature, which cannot be persisted: ``preresolve`` and
``aot_warm`` do those before traffic.

**Writes** are tmp file, fsync, atomic rename, and never run under an
ordered lock: concurrent writers of one key are last-wins safe.  The
``aot.corrupt`` chaos point truncates an entry's bytes as they are
read.  **Eviction**: ``max_bytes`` (ctor or
``PADDLE_TPU_AOT_MAX_BYTES``) bounds the directory, entries and library
copies alike, least recently used (atime, else mtime) first; 0 / None =
unbounded — a model version's ``compiled/`` holds a closed set.
``default_cache()`` is the process default (``PADDLE_TPU_AOT_CACHE``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional

from ..kernels import _build

__all__ = ["CompileCache", "backend_salt", "default_cache",
           "set_default_cache", "plan_record"]

_MAGIC = b"PDLPLAN1\n"
_SUFFIX = ".plan"

# process-default cache (PADDLE_TPU_AOT_CACHE env, or set_default_cache):
# executors with no explicit cache consult this; None disables the tier.
_default: List[Optional["CompileCache"]] = [None]
_default_resolved = [False]


def backend_salt() -> Dict[str, Any]:
    """Everything that invalidates a stored record or library besides the
    dispatch signature: the torch and CUDA versions, the device's name,
    compute capability and count, and the kernel sources' digests.
    Keyed INTO the entry name: a change addresses a different entry (a
    miss), so one directory can serve heterogeneous readers."""
    import torch

    salt: Dict[str, Any] = {"torch": torch.__version__,
                            "cuda": torch.version.cuda,
                            "device_name": "none", "capability": None,
                            "device_count": 0,
                            "kernels": _build.source_digests()}
    try:
        if torch.cuda.is_available():
            salt["device_name"] = torch.cuda.get_device_name(0)
            salt["capability"] = list(torch.cuda.get_device_capability(0))
            salt["device_count"] = torch.cuda.device_count()
    except RuntimeError:            # no usable CUDA runtime: still hashable
        pass
    return salt


def plan_record(plan) -> Dict[str, Any]:
    """The executor's ``BlockPlan`` classification as JSON-able lists:
    what a stored entry records and a hit checks."""
    return {"ops": [op.type for op in plan.ops],
            "pre_host": [op.type for op in plan.pre_host],
            "post_host": [op.type for op in plan.post_host],
            "state_in": list(plan.state_in),
            "state_out": list(plan.state_out),
            "salts": list(plan.salts),
            "host_rng_ops": list(plan.host_rng_ops),
            "host_loops": list(plan.host_loops),
            "prints": list(plan.prints)}


def _canon(obj):
    """Canonicalize a key part into something JSON-stable: tuples/lists
    -> lists, dict -> sorted items, everything exotic -> repr."""
    if isinstance(obj, (tuple, list)):
        return [_canon(x) for x in obj]
    if isinstance(obj, dict):
        return [[_canon(k), _canon(v)] for k, v in sorted(obj.items())]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


class CompileCache:
    """One directory of checksum-framed step records and kernel library
    copies."""

    def __init__(self, dirname: str, extra_salt: Optional[Dict] = None,
                 max_bytes: Optional[int] = None):
        self.dirname = str(dirname)
        # extra_salt: anything a deployment wants to additionally
        # invalidate on (a cluster config epoch, a toolchain build id)
        self.extra_salt = dict(extra_salt or {})
        if max_bytes is None:
            max_bytes = int(os.environ.get("PADDLE_TPU_AOT_MAX_BYTES",
                                           "0")) or None
        self.max_bytes = max_bytes
        self._salt: Optional[Dict] = None
        self._stats = {"hits": 0, "misses": 0, "stores": 0,
                       "corrupt": 0, "errors": 0, "evictions": 0,
                       "lib_loads": 0, "lib_stores": 0,
                       "bytes_read": 0, "bytes_written": 0,
                       "load_ms": 0.0}
        _register_cache_collector(self)

    # -- keys ----------------------------------------------------------------
    def salt(self) -> Dict[str, Any]:
        if self._salt is None:
            s = backend_salt()
            s.update(self.extra_salt)
            self._salt = s
        return self._salt

    def entry_key(self, parts) -> str:
        """Content-addressed entry name: sha256 over the canonical JSON
        of (dispatch-signature parts, salt).  The parts are the
        executor's in-memory cache key (program fingerprint, mode,
        feed/state signatures, fetch names) and its device type, so any
        dispatch the in-memory tier would capture anew addresses a
        distinct persistent entry too."""
        doc = json.dumps([_canon(parts), _canon(self.salt())],
                         sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(doc.encode("utf-8")).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.dirname, key + _SUFFIX)

    def keys(self) -> List[str]:
        """Entry keys currently on disk (sorted, so byte-stable across
        runs)."""
        if not os.path.isdir(self.dirname):
            return []
        return sorted(n[:-len(_SUFFIX)] for n in os.listdir(self.dirname)
                      if n.endswith(_SUFFIX))

    def libraries(self) -> List[str]:
        """File names of the library copies on disk (sorted)."""
        if not os.path.isdir(self.dirname):
            return []
        return sorted(n[:-len(_build.LIB_SUFFIX)]
                      for n in os.listdir(self.dirname)
                      if n.endswith(_build.LIB_SUFFIX))

    # -- load ----------------------------------------------------------------
    def load(self, key: str) -> Optional[Dict[str, Any]]:
        """The record stored under ``key``, or None on a miss or an
        integrity failure (the corrupt entry is deleted, so the next
        store writes it cleanly)."""
        path = self._path(key)
        t0 = time.perf_counter()
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            self._stats["misses"] += 1
            return None
        # chaos point (`aot.corrupt`): a seeded torn read — the
        # integrity check must turn it into a miss, never load garbage
        from ..resilience.chaos import injector

        if injector().should("aot.corrupt") and len(raw) > len(_MAGIC):
            raw = raw[:len(raw) // 2]
        blob = self._checked_blob(raw, key)
        record = None
        if blob is not None:
            try:
                record = json.loads(blob.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                record = None
        if not isinstance(record, dict):
            self._stats["corrupt"] += 1
            self._stats["misses"] += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self._stats["hits"] += 1
        self._stats["bytes_read"] += len(raw)
        self._stats["load_ms"] += (time.perf_counter() - t0) * 1e3
        return record

    def _checked_blob(self, raw: bytes, key: str) -> Optional[bytes]:
        """Parse + verify one entry file; None on any integrity failure
        (bad magic, torn header, checksum mismatch, a salt in the header
        that is not ours)."""
        if not raw.startswith(_MAGIC):
            return None
        try:
            head_end = raw.index(b"\n", len(_MAGIC))
            header = json.loads(raw[len(_MAGIC):head_end].decode("utf-8"))
            blob = raw[head_end + 1:]
        except (ValueError, UnicodeDecodeError):
            return None
        if header.get("key") != key:
            return None
        if header.get("salt") != _canon(self.salt()):
            return None
        if len(blob) != header.get("blob_bytes"):
            return None
        if hashlib.sha256(blob).hexdigest() != header.get("sha256"):
            return None
        return blob

    def load_libraries(self, names) -> bool:
        """Restore every named kernel library from this directory into
        ``kernels/build/`` (those already built stay) and load it; False
        as soon as one would have to be compiled (no sound copy here).
        This directory is mounted for ``_build.load_library`` first."""
        _build.mount(self.dirname)
        for name in names:
            how, copy = _build.library_plan(name, [self.dirname])
            if how == "nvcc":
                return False
            if how == "cache":
                if not _build.restore_library(name, copy):
                    self._stats["corrupt"] += 1
                    return False
                self._stats["lib_loads"] += 1
            _build.load_library(name)
        return True

    # -- store ---------------------------------------------------------------
    def store(self, key: str, compiled: Dict[str, Any]) -> bool:
        """Durably publish one signature's record (``compiled``, the
        reference's name for what a store publishes) under ``key``: tmp
        file + fsync + atomic rename, so a crash mid-store leaves the old
        entry or no entry, never a torn one (and the checksum catches
        torn anyway).  False (counted) when the write fails."""
        blob = json.dumps(compiled, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        header = json.dumps({
            "key": key, "salt": _canon(self.salt()),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "blob_bytes": len(blob), "created": time.time(),
        }, sort_keys=True, separators=(",", ":")).encode("utf-8")
        raw = _MAGIC + header + b"\n" + blob
        try:
            os.makedirs(self.dirname, exist_ok=True)
            _build.atomic_write(self._path(key), raw)
        except OSError:
            self._stats["errors"] += 1
            return False
        self._stats["stores"] += 1
        self._stats["bytes_written"] += len(raw)
        if self.max_bytes:
            self._evict(keep=self._path(key))
        return True

    def store_libraries(self, names) -> int:
        """Copy every named built library into this directory (a sound
        copy already there stays); returns the number written."""
        n = 0
        for name in names:
            try:
                wrote = _build.store_library(name, self.dirname)
            except OSError:
                self._stats["errors"] += 1
                continue
            if wrote:
                n += 1
                self._stats["lib_stores"] += 1
                self._stats["bytes_written"] += wrote
        if n and self.max_bytes:
            self._evict()
        return n

    def _evict(self, keep: Optional[str] = None) -> None:
        """Drop least-recently-used entries and library copies until the
        directory fits ``max_bytes`` (``keep`` is exempt)."""
        entries = []
        total = 0
        try:
            names = os.listdir(self.dirname)
        except OSError:
            return
        for n in names:
            if not n.endswith((_SUFFIX, _build.LIB_SUFFIX)):
                continue
            p = os.path.join(self.dirname, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            total += st.st_size
            entries.append((max(st.st_atime, st.st_mtime), st.st_size, p))
        entries.sort()
        for _, size, p in entries:
            if total <= self.max_bytes:
                break
            if p == keep:
                continue
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= size
            self._stats["evictions"] += 1

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        out = dict(self._stats)
        out["load_ms"] = round(out["load_ms"], 3)
        out["entries"] = len(self.keys())
        out["libraries"] = len(self.libraries())
        out["dir"] = self.dirname
        return out


# -- process default ---------------------------------------------------------
def default_cache() -> Optional[CompileCache]:
    """The process-default persistent tier: a ``CompileCache`` set via
    ``set_default_cache``, else one mounted at ``PADDLE_TPU_AOT_CACHE``
    when that env var names a directory, else None (tier disabled)."""
    if not _default_resolved[0]:
        _default_resolved[0] = True
        path = os.environ.get("PADDLE_TPU_AOT_CACHE", "")
        if path:
            _default[0] = CompileCache(path)
    return _default[0]


def set_default_cache(cache) -> Optional[CompileCache]:
    """Install (or with None, clear) the process-default cache; accepts
    a CompileCache or a directory path.  Returns the installed cache."""
    if isinstance(cache, str):
        cache = CompileCache(cache)
    _default[0] = cache
    _default_resolved[0] = True
    return cache


# -- telemetry ----------------------------------------------------------------
_LIVE_CACHES: "weakref.WeakSet[CompileCache]" = weakref.WeakSet()
_collector_registered = [False]


def _register_cache_collector(cache: CompileCache) -> None:
    _LIVE_CACHES.add(cache)
    if _collector_registered[0]:
        return
    _collector_registered[0] = True
    from ..observability.metrics import registry as _obs_registry

    _obs_registry().register_collector(_collect_aot_metrics)


def _collect_aot_metrics():
    """paddle_aot_* series: per-event counters + bytes moved, summed
    over every live cache (the scrape-time collector idiom)."""
    from ..observability.metrics import Sample

    for cache in list(_LIVE_CACHES):
        st = cache._stats
        for ev in ("hits", "misses", "stores", "corrupt", "errors",
                   "evictions", "lib_loads", "lib_stores"):
            yield Sample("paddle_aot_cache_events_total", "counter",
                         (("event", ev),), float(st[ev]),
                         "Persistent compile cache events")
        for direction in ("read", "written"):
            yield Sample("paddle_aot_cache_bytes_total", "counter",
                         (("direction", direction),),
                         float(st[f"bytes_{direction}"]),
                         "Compile cache bytes moved")
        yield Sample("paddle_aot_cache_load_ms_total", "counter", (),
                     float(st["load_ms"]),
                     "Milliseconds spent loading cached step records")
