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
* **Refcounts** make sharing safe: beam lanes share a parent's pages
  (copy-on-write before a shared page is written), and prefix-cache hits
  share prompt pages across requests.
* **Prefix chunks**: a *chunk* is one full page of prompt tokens, keyed
  by a chain hash (the chunk's tokens and the previous chunk's hash), so
  a hit guarantees the whole prefix matches; each cached chunk owns an
  (encoder-KV page, cross-KV page) pair.  Chunks whose refcount drops to
  zero move to an LRU *evictable* list: still hittable, reclaimed only
  under pool pressure.

Tiered states.  With a host tier attached (``host_pages > 0`` plus a
pager through ``set_pager``), a chunk moves through five states instead
of three:

    in-use (rc>0)  --unref_chunk-->  evictable (rc==0, on the card)
    evictable      --pressure----->  demoted   (bytes in host RAM, the
                                               card's pages freed)
    demoted        --promote_chunk-> evictable (fresh pages, bytes
                                               uploaded; the host copy
                                               dropped: a hash lives in
                                               exactly ONE tier)
    demoted        --host pressure-> gone      (host-LRU evicted)
    evictable      --pressure------> gone      (no tier attached, or
                                               the pager failed)

Demotion happens inside ``alloc`` (the admission path, which the
scheduler runs outside its lock) and in the generator's
``tier_maintenance`` slice, never under the scheduler lock.  The pager
callables do the device<->host copies; the allocator only moves
bookkeeping and opaque payloads, so ``check_invariants`` can assert the
cross-tier exclusivity and accounting without touching the device.

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

__all__ = ["PageAllocator", "HostPool", "PoolCapacityError", "TRASH_PAGE",
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


class HostPool:
    """Second KV tier: demoted prefix-chunk payloads in host RAM.

    Holds OPAQUE payload blobs (whatever the pager's download produced —
    host KV rows plus the int8 scale sidecar when quantized) keyed by
    chain hash, with LRU eviction against a page-count capacity.  The
    pool never touches the device; the owning :class:`PageAllocator`
    moves bytes through the pager and only hands finished payloads here.
    """

    def __init__(self, capacity_pages: int):
        self.capacity_pages = int(capacity_pages)
        # hash -> (payload, n_pages); insertion order == LRU order
        self._entries: "OrderedDict[str, Tuple[object, int]]" = OrderedDict()
        self._pages_used = 0
        self.evictions = 0

    def __contains__(self, h: str) -> bool:
        return h in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages_used(self) -> int:
        return self._pages_used

    def put(self, h: str, payload: object, n_pages: int) -> bool:
        """Insert (or refresh) a demoted chunk, evicting LRU entries to
        fit.  Returns False when the payload alone exceeds capacity —
        the chunk is simply lost, exactly as an untiered evict."""
        n_pages = int(n_pages)
        if n_pages > self.capacity_pages:
            return False
        if h in self._entries:
            _, old = self._entries.pop(h)
            self._pages_used -= old
        while self._pages_used + n_pages > self.capacity_pages:
            _, (_, np_) = self._entries.popitem(last=False)
            self._pages_used -= np_
            self.evictions += 1
        self._entries[h] = (payload, n_pages)
        self._pages_used += n_pages
        return True

    def get(self, h: str) -> Optional[object]:
        """Peek a payload (refreshes LRU recency); None on miss."""
        entry = self._entries.get(h)
        if entry is None:
            return None
        self._entries.move_to_end(h)
        return entry[0]

    def pop(self, h: str) -> Optional[object]:
        entry = self._entries.pop(h, None)
        if entry is None:
            return None
        self._pages_used -= entry[1]
        return entry[0]

    def check_invariants(self) -> None:
        assert self._pages_used == sum(n for _, n in self._entries.values())
        assert 0 <= self._pages_used <= self.capacity_pages, \
            f"host pool over capacity: {self._pages_used} pages of " \
            f"{self.capacity_pages}"


class PageAllocator:
    """Free-list + refcount allocator over ``num_pages`` logical pages
    (page 0 reserved as trash), with a chunk-level prefix cache and an
    optional host-RAM demotion tier (``host_pages`` + ``set_pager``)."""

    def __init__(self, num_pages: int, page_size: int,
                 host_pages: int = 0):
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
        # second tier: host-RAM pool for demoted refcount-0 chunks.
        # Opt-in (host_pages=0 keeps the pre-tier destroy-on-evict
        # semantics); bytes move through the pager callables installed
        # by the generator via set_pager().
        self.host = HostPool(host_pages) if host_pages > 0 else None
        self._download = None           # (pages: List[int]) -> payload
        self._upload = None             # (pages: List[int], payload) -> None
        self._page_bytes = 0
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
        if self.host is not None and self._download is not None:
            try:
                payload = self._download([enc, cross])
            except Exception:
                payload = None          # pager failure degrades to destroy
            if payload is not None and self.host.put(h, payload, 2):
                self._stats["demotes"] += 1
                self._stats["spilled_bytes"] += 2 * self._page_bytes
        self.unref(enc)
        self.unref(cross)
        self._stats["evictions"] += 1

    def free_count(self) -> int:
        """Pages on the free list RIGHT NOW (excludes evictable-chunk
        pages ``available()`` counts) — the eager-demotion watermark's
        measure of immediately allocatable headroom."""
        return len(self._free)

    def demote_one(self) -> bool:
        """Evict the LRU refcount-0 chunk (demoting it to the host tier
        when one is attached); False when nothing is evictable.  The
        generator's ``tier_maintenance`` drains toward its watermark
        with this so admissions find free pages instead of paying the
        demotion DMA inline."""
        if not self._evictable:
            return False
        self._evict_lru()
        return True

    # -- host tier -----------------------------------------------------------
    def set_pager(self, download, upload, page_bytes: int = 0) -> None:
        """Install the device<->host copy callables (generator-owned
        compiled programs).  ``download(pages) -> payload`` pulls the
        listed pages' KV rows (+ scale sidecar) to host numpy;
        ``upload(pages, payload)`` scatters a payload back into fresh
        pages.  Both run device work — callers of ``alloc`` /
        ``promote_chunk`` must therefore be off the scheduler lock."""
        self._download = download
        self._upload = upload
        self._page_bytes = int(page_bytes)

    @property
    def tiered(self) -> bool:
        return self.host is not None and self._download is not None \
            and self._upload is not None

    def host_lookup_chain(self, hashes: Sequence[str]) -> List[str]:
        """Longest prefix of ``hashes`` resident across BOTH tiers —
        what the chain could hit after promotion.  Admission uses this
        to decide prefetch-back; takes no references, moves no bytes."""
        out: List[str] = []
        for h in hashes:
            if h in self._chunks or (self.host is not None
                                     and h in self.host):
                out.append(h)
            else:
                break
        return out

    def promote_chunk(self, h: str) -> bool:
        """Pull a demoted chunk back into HBM: allocate a fresh
        (enc, cross) page pair, upload the host payload, and re-register
        the chunk as refcount-0 *evictable* (hittable; ``ref_chunk`` pins
        it).  The host copy is dropped — a hash lives in exactly one
        tier.  Returns False when the chunk is not demoted, already
        resident, or HBM cannot fit the pair right now."""
        if h in self._chunks:
            return False
        if not self.tiered or h not in self.host:
            return False
        payload = self.host.get(h)
        try:
            enc, cross = self.alloc(2)
        except PoolCapacityError:
            return False
        try:
            self._upload([enc, cross], payload)
        except Exception:
            self.unref(enc)
            self.unref(cross)
            return False
        self.host.pop(h)
        self._chunks[h] = [enc, cross, 0]
        self._evictable[h] = None
        self._stats["promotes"] += 1
        self._stats["fetched_bytes"] += 2 * self._page_bytes
        return True

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
        if self.host is not None:
            self.host.check_invariants()
            both = set(self._chunks) & set(self.host._entries)
            assert not both, \
                f"chunk resident in both tiers: {sorted(both)[:3]}"

    def stats(self) -> Dict[str, object]:
        lk = self._stats["prefix_lookups"]
        return dict(self._stats,
                    total=self.total_usable,
                    free=len(self._free),
                    evictable=2 * len(self._evictable),
                    in_use=self.in_use(),
                    cached_chunks=len(self._chunks),
                    # ``is not None``: an EMPTY host tier is falsy
                    host_pages=(self.host.capacity_pages
                                if self.host is not None else 0),
                    host_pages_used=(self.host.pages_used
                                     if self.host is not None else 0),
                    host_chunks=(len(self.host)
                                 if self.host is not None else 0),
                    host_evictions=(self.host.evictions
                                    if self.host is not None else 0),
                    utilization=round(self.in_use()
                                      / max(1, self.total_usable), 4),
                    prefix_hit_rate=round(
                        self._stats["prefix_hits"] / lk, 4) if lk else None)

    def note_cow(self) -> None:
        self._stats["cow_copies"] += 1
