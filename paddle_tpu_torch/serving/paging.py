"""Host-side paged-KV bookkeeping — the port's copy of
``paddle_tpu/serving/paging.py``: allocator, refcounts, prefix cache.

The device half of the paged cache is ONE pooled tensor (see
``fluid/ops/cache_ops.paged_cache_write`` for the layout); everything
here is the host half: which logical pages are free, who holds
references to the rest, and which full prompt-prefix chunks are cached
for reuse.  It must agree with the reference bit for bit: the same
calls give the same page ids, refcounts, chain hashes and stats.

* **Pages** come from one free list; logical page 0 is the reserved
  trash page (dead lanes write there) and is never handed out.
* **Refcounts** make sharing safe: prefix-cache hits share prompt pages
  across requests.
* **Prefix chunks**: a *chunk* is one full page of prompt tokens, keyed
  by a chain hash (the chunk's tokens and the previous chunk's hash), so
  a hit guarantees the whole prefix matches; each cached chunk owns an
  (encoder-KV page, cross-KV page) pair.  Chunks whose refcount drops to
  zero move to an LRU *evictable* list: still hittable, reclaimed only
  under pool pressure.

The reference's host-RAM demotion tier (``HostPool``, ``set_pager``,
``promote_chunk``) is not ported yet; its counters stay in ``stats()``
at zero so the two allocators report the same schema.

Soundness note: prefix K/V only depends on the prefix because the paged
serving path encodes the source CAUSALLY
(``models/transformer.paged_prefill_chunk``).
"""

from __future__ import annotations

import hashlib
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.sync import RANK_COLLECTOR_INIT, OrderedLock

__all__ = ["PageAllocator", "PoolCapacityError", "TRASH_PAGE",
           "chunk_hashes"]

TRASH_PAGE = 0

# -- telemetry ------------------------------------------------------------
# ONE module-level collector aggregates every live allocator: per-pool
# series would need unstable instance labels, and summing utilization
# across pools is meaningless — so the collector emits summable page
# counts per state plus ONE aggregate utilization over all live pools.
# Allocators register weakly; a GC'd pool drops out of the rollup.
_LIVE_ALLOCATORS: "weakref.WeakSet[PageAllocator]" = weakref.WeakSet()
_collector_lock = OrderedLock("obs.collector_init", RANK_COLLECTOR_INIT)
_collector_registered = False


def _collect_pool_metrics():
    from ..observability.metrics import Sample

    allocs = list(_LIVE_ALLOCATORS)
    states = {"free": 0, "in_use": 0, "evictable": 0, "total": 0}
    counters = {"allocs": 0, "frees": 0, "evictions": 0, "cow_copies": 0}
    prefix = {"lookups": 0, "hits": 0}
    chunks = 0
    tier_pages = {"hbm": 0, "host": 0}          # capacity per tier
    tier_chunks = {"hbm": 0, "host": 0}
    tier_events = {"demote": 0, "promote": 0, "host_evict": 0}
    tier_bytes = {"spill": 0, "fetch": 0}
    for a in allocs:
        try:
            st = a.stats()
        except Exception:
            continue            # a mid-mutation pool must not kill the scrape
        for k in states:
            states[k] += st[k]
        for k in counters:
            counters[k] += st[k]
        prefix["lookups"] += st["prefix_lookups"]
        prefix["hits"] += st["prefix_hits"]
        chunks += st["cached_chunks"]
        tier_pages["hbm"] += st["total"]
        tier_pages["host"] += st["host_pages"]
        tier_chunks["hbm"] += st["cached_chunks"]
        tier_chunks["host"] += st["host_chunks"]
        tier_events["demote"] += st["demotes"]
        tier_events["promote"] += st["promotes"]
        tier_events["host_evict"] += st["host_evictions"]
        tier_bytes["spill"] += st["spilled_bytes"]
        tier_bytes["fetch"] += st["fetched_bytes"]
    for state, v in states.items():
        yield Sample("paddle_kv_pages", "gauge", (("state", state),),
                     float(v), "KV-pool pages by state, all live pools")
    yield Sample("paddle_kv_page_utilization", "gauge", (),
                 states["in_use"] / max(1, states["total"]),
                 "in_use / total pages across all live KV pools")
    for ev, v in counters.items():
        yield Sample("paddle_kv_page_events_total", "counter",
                     (("event", ev),), float(v),
                     "Page allocator events (alloc/free/evict/COW)")
    for ev, v in prefix.items():
        yield Sample("paddle_kv_prefix_events_total", "counter",
                     (("event", ev),), float(v),
                     "Prefix-chunk cache lookups and hits")
    yield Sample("paddle_kv_cached_chunks", "gauge", (), float(chunks),
                 "Prompt-prefix chunks resident in the cache")
    for tier, v in tier_pages.items():
        yield Sample("paddle_kv_tier_pages", "gauge", (("tier", tier),),
                     float(v), "KV page capacity per tier (HBM vs host RAM)")
    for tier, v in tier_chunks.items():
        yield Sample("paddle_kv_tier_chunks", "gauge", (("tier", tier),),
                     float(v), "Prefix chunks resident per tier")
    for ev, v in tier_events.items():
        yield Sample("paddle_kv_tier_events_total", "counter",
                     (("event", ev),), float(v),
                     "Tier transitions (demote/promote/host-LRU-evict)")
    for d, v in tier_bytes.items():
        yield Sample("paddle_kv_tier_bytes_total", "counter",
                     (("dir", d),), float(v),
                     "Bytes moved across the HBM<->host KV tier boundary")


def _register_pool_collector() -> None:
    global _collector_registered
    with _collector_lock:
        if _collector_registered:
            return
        from ..observability.metrics import registry

        registry().register_collector(_collect_pool_metrics)
        _collector_registered = True


class PoolCapacityError(RuntimeError):
    """The page pool cannot satisfy an allocation — either transiently
    (pool momentarily full; the scheduler keeps the request queued) or
    structurally (the prompt alone exceeds total pool capacity; the
    scheduler rejects the request with this error)."""


def chunk_hashes(tokens: Sequence[int], page_size: int) -> List[str]:
    """Chain hashes of the FULL page_size-token chunks of a prompt.
    Chunk i's hash commits to every token in chunks 0..i, so equal hash
    => equal whole prefix (modulo hash collisions of sha1, which we
    accept the way content-addressed stores do)."""
    toks = np.asarray(tokens).reshape(-1)
    out: List[str] = []
    prev = b""
    for i in range(len(toks) // page_size):
        chunk = toks[i * page_size:(i + 1) * page_size]
        h = hashlib.sha1(
            prev + np.ascontiguousarray(chunk, np.int64).tobytes())
        out.append(h.hexdigest())
        prev = out[-1].encode()
    return out


class PageAllocator:
    """Free-list + refcount allocator over ``num_pages`` logical pages
    (page 0 reserved as trash), with a chunk-level prefix cache."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PageAllocator needs >= 2 pages (page 0 is "
                             "the reserved trash page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}          # page -> refcount (> 0)
        # chunk cache: chain_hash -> [enc_page, cross_page, refcount]
        self._chunks: Dict[str, List] = {}
        self._evictable: "OrderedDict[str, None]" = OrderedDict()
        self._stats = {"allocs": 0, "frees": 0, "evictions": 0,
                       "prefix_lookups": 0, "prefix_hits": 0,
                       "cow_copies": 0, "demotes": 0, "promotes": 0,
                       "spilled_bytes": 0, "fetched_bytes": 0}
        _LIVE_ALLOCATORS.add(self)
        _register_pool_collector()

    # -- raw pages -----------------------------------------------------------
    @property
    def total_usable(self) -> int:
        return self.num_pages - 1

    def available(self) -> int:
        """Pages allocatable right now: the free list plus every page
        held only by evictable (refcount-0) cached chunks."""
        return len(self._free) + 2 * len(self._evictable)

    def in_use(self) -> int:
        return self.total_usable - self.available()

    def alloc(self, n: int = 1) -> List[int]:
        """Allocate ``n`` pages with refcount 1; evicts LRU refcount-0
        prefix chunks under pressure.  All-or-nothing: on exhaustion the
        partial allocation is rolled back and PoolCapacityError raised."""
        got: List[int] = []
        for _ in range(n):
            if not self._free and self._evictable:
                self._evict_lru()
            if not self._free:
                for p in got:
                    self.unref(p)
                raise PoolCapacityError(
                    f"page pool exhausted: wanted {n} pages, "
                    f"{self.available()} available of {self.total_usable}")
            p = self._free.pop()
            self._ref[p] = 1
            got.append(p)
            self._stats["allocs"] += 1
        return got

    def ref(self, page: int) -> None:
        if page == TRASH_PAGE:
            return
        if page not in self._ref:
            raise ValueError(f"ref of unallocated page {page}")
        self._ref[page] += 1

    def unref(self, page: int) -> None:
        """Drop one reference; the last reference frees the page."""
        if page == TRASH_PAGE:
            return
        rc = self._ref.get(page)
        if rc is None:
            raise ValueError(f"unref of unallocated page {page} "
                             "(double free?)")
        if rc > 1:
            self._ref[page] = rc - 1
            return
        del self._ref[page]
        self._free.append(page)
        self._stats["frees"] += 1

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    # -- prefix chunk cache --------------------------------------------------
    def lookup_chain(self, hashes: Sequence[str], count: bool = True
                     ) -> List[Tuple[str, int, int]]:
        """Longest cached prefix of the hash chain; returns
        [(hash, enc_page, cross_page), ...] WITHOUT taking references
        (``ref_chunk`` each entry you decide to use).  Counts one lookup
        per chunk asked and one hit per chunk found — unless
        ``count=False`` (admission probes that would otherwise skew the
        reported prefix_hit_rate)."""
        out: List[Tuple[str, int, int]] = []
        for h in hashes:
            if count:
                self._stats["prefix_lookups"] += 1
            entry = self._chunks.get(h)
            if entry is None:
                break
            if count:
                self._stats["prefix_hits"] += 1
            out.append((h, entry[0], entry[1]))
        return out

    def ref_chunk(self, h: str) -> None:
        entry = self._chunks[h]
        if entry[2] == 0:
            self._evictable.pop(h, None)
        entry[2] += 1

    def unref_chunk(self, h: str) -> None:
        entry = self._chunks.get(h)
        if entry is None:
            return                     # chunk was evicted while we held
                                       # pages -> pages were plain-freed
        entry[2] -= 1
        if entry[2] < 0:
            raise ValueError(f"unref_chunk below zero for {h[:12]}")
        if entry[2] == 0:
            self._evictable[h] = None  # LRU tail

    def insert_chunk(self, h: str, enc_page: int, cross_page: int) -> bool:
        """Register a freshly computed full chunk.  The caller's page
        references transfer to the chunk entry (refcount 1 == the
        inserting request; released via ``unref_chunk``).  Returns False
        (caller keeps plain ownership) if the hash is already cached —
        two identical prompts raced; the first wins."""
        if h in self._chunks:
            return False
        self._chunks[h] = [int(enc_page), int(cross_page), 1]
        return True

    def _evict_lru(self) -> None:
        # a chunk only reaches the evictable list at request refcount 0,
        # so the entry's own page hold (taken over at insert_chunk) is
        # the last reference and unref frees both pages
        h, _ = self._evictable.popitem(last=False)
        enc, cross, rc = self._chunks.pop(h)
        assert rc == 0, (h, rc)
        self.unref(enc)
        self.unref(cross)
        self._stats["evictions"] += 1

    # -- accounting ----------------------------------------------------------
    def check_invariants(self) -> None:
        """free + in-use partitions the non-trash pages exactly once —
        the no-leak / no-double-free invariant the property test drives."""
        free = set(self._free)
        held = set(self._ref)
        assert len(free) == len(self._free), "duplicate page in free list"
        assert not (free & held), f"page both free and held: {free & held}"
        assert free | held == set(range(1, self.num_pages)), \
            "page leak: some page is neither free nor referenced"
        for h in self._evictable:
            assert self._chunks[h][2] == 0
        for h, (enc, cross, rc) in self._chunks.items():
            assert enc in held and cross in held, f"cached chunk {h[:8]} " \
                "points at freed pages"

    def stats(self) -> Dict[str, object]:
        lk = self._stats["prefix_lookups"]
        return dict(self._stats,
                    total=self.total_usable,
                    free=len(self._free),
                    evictable=2 * len(self._evictable),
                    in_use=self.in_use(),
                    cached_chunks=len(self._chunks),
                    # the host tier is not ported: its fields stay 0
                    host_pages=0, host_pages_used=0, host_chunks=0,
                    host_evictions=0,
                    utilization=round(self.in_use()
                                      / max(1, self.total_usable), 4),
                    prefix_hit_rate=round(
                        self._stats["prefix_hits"] / lk, 4) if lk else None)

    def note_cow(self) -> None:
        self._stats["cow_copies"] += 1
