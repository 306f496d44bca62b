"""Host-side paging and admission of the port, against the JAX package.

The allocator is host-only, so the port's copy must make the reference's
decisions bit for bit: the same random interleaving of alloc / ref /
prefix insert / hit / retire gives the same page ids, refcounts, chunk
table, LRU order, stats and errors.  The admission paths of the port's
generator and scheduler (pinned prefix hits under pressure, infeasible
prompts, backpressure, cancellation) are checked on the CPU at the tiny
sizes of ``tests/test_paged_serving.py``.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.serving import PageAllocator as JaxAllocator
from paddle_tpu.serving import PoolCapacityError as JaxPoolCapacityError
from paddle_tpu.serving.paging import chunk_hashes as jax_chunk_hashes
from paddle_tpu_torch import fluid
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PageAllocator,
                                      PagedTransformerGenerator,
                                      PoolCapacityError, RequestCancelled,
                                      chunk_hashes)

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 8, 8, 4, 4


def _gen(num_pages, max_out_len=OUT, prefix_sharing=True, seed=2):
    gen = PagedTransformerGenerator(
        V, V, n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
        d_inner_hid=DI, max_length=64, src_len=SRC,
        max_out_len=max_out_len, place=fluid.CPUPlace(), page_size=PS,
        chunk_size=CHUNK, num_pages=num_pages,
        prefix_sharing=prefix_sharing)
    gen.init_params(seed=seed)
    return gen


def _state(alloc):
    return (list(alloc._free), dict(alloc._ref),
            {h: list(e) for h, e in alloc._chunks.items()},
            list(alloc._evictable), alloc.stats())


def test_chunk_hashes_match_jax():
    rng = np.random.RandomState(1)
    for n in (0, 3, PS, 3 * PS + 1):
        toks = rng.randint(0, 1000, n)
        assert chunk_hashes(toks, PS) == jax_chunk_hashes(toks, PS)


@pytest.mark.parametrize("seed", [42, 7])
def test_allocator_random_interleavings_match_jax(seed):
    """Random interleavings of admit-like alloc with prefix hits, page
    share/unshare, chunk inserts and retires, applied to both
    allocators: identical results, errors and state after every op."""
    rng = np.random.RandomState(seed)
    ours, ref = PageAllocator(24, PS), JaxAllocator(24, PS)
    live = []          # [pages, hit hashes, inserted hashes]
    for step in range(400):
        op = rng.rand()
        ent = live[int(rng.randint(len(live)))] if live else None
        if op < 0.45 or ent is None:                 # admit
            # a two-letter alphabet makes prefix hits common
            hashes = chunk_hashes(rng.randint(0, 2, int(
                rng.randint(PS, 4 * PS))), PS)
            n = int(rng.randint(1, 4))

            def do(alloc):
                hits = [h for h, _, _ in alloc.lookup_chain(hashes)]
                for h in hits:
                    alloc.ref_chunk(h)
                try:
                    return ("admit", alloc.alloc(n), hits)
                except (PoolCapacityError, JaxPoolCapacityError) as e:
                    for h in hits:                   # as admit_slot does
                        alloc.unref_chunk(h)
                    return ("full", str(e))
        elif op < 0.6:                               # share + unshare
            p = ent[0][int(rng.randint(len(ent[0])))] if ent[0] else 0

            def do(alloc):
                alloc.ref(p)
                rc = alloc.refcount(p)
                alloc.unref(p)
                return ("share", rc)
        elif op < 0.75 and len(ent[0]) >= 2:         # insert a chunk pair
            h = chunk_hashes(rng.randint(0, 2, PS), PS)[0]

            def do(alloc):
                return ("insert", alloc.insert_chunk(h, ent[0][0],
                                                     ent[0][1]))
        else:                                        # retire
            def do(alloc):
                for h in ent[1] + ent[2]:
                    alloc.unref_chunk(h)
                for p in ent[0]:
                    alloc.unref(p)
                return ("retire",)
        got = do(ours)
        assert got == do(ref), step
        assert _state(ours) == _state(ref), step
        ours.check_invariants()
        if got[0] == "admit":
            live.append([got[1], got[2], []])
        elif got[0] == "insert" and got[1]:
            ent[2].append(h)
            del ent[0][:2]
        elif got[0] == "retire":
            live.remove(ent)
    assert ours.stats()["evictions"] > 0 and ours.stats()["prefix_hits"] > 0


def test_allocator_double_free_and_exhaustion():
    alloc = PageAllocator(num_pages=4, page_size=PS)
    pages = alloc.alloc(3)
    with pytest.raises(PoolCapacityError):
        alloc.alloc(1)
    alloc.unref(pages[0])
    with pytest.raises(ValueError, match="double free"):
        alloc.unref(pages[0])
    with pytest.raises(PoolCapacityError):         # all-or-nothing
        alloc.alloc(2)
    assert alloc.available() == 1
    alloc.check_invariants()


def test_admit_under_pressure_pins_hit_chunks():
    """admit_slot refs its prefix-cache hits BEFORE allocating, so an
    allocation that must evict under pressure never evicts the hit it
    just counted."""
    gen = _gen(num_pages=12, max_out_len=4)
    rng = np.random.RandomState(21)
    a = rng.randint(2, V, PS)          # one FULL chunk -> cached
    d = rng.randint(2, V, PS)
    gen.greedy(a[None], [PS], max_new=2, stop_at_end=False)
    gen.greedy(d[None], [PS], max_new=2, stop_at_end=False)
    assert gen.alloc.stats()["free"] == 7
    gen.open_slots(5)
    gen.admit_slot(0, rng.randint(2, V, 2), max_new=4)      # 3 pages
    gen.admit_slot(1, rng.randint(2, V, 2), max_new=0)      # 2 pages
    gen.admit_slot(2, rng.randint(2, V, 2), max_new=0)      # 2 pages
    assert gen.alloc.stats()["free"] == 0
    gen.admit_slot(3, a, max_new=4)
    assert gen._lanes[3].hit_hashes == [chunk_hashes(a, PS)[0]]
    assert gen.alloc.stats()["evictions"] == 1       # d's chunk went
    assert gen.alloc.lookup_chain(chunk_hashes(d, PS), count=False) == []
    for i in range(4):
        gen.clear_slot(i)
    gen.alloc.check_invariants()
    assert gen.alloc.stats()["in_use"] == 0


def test_scheduler_rejects_infeasible_prompt():
    """A prompt whose pages can NEVER fit the pool raises at submit, and
    again at admission if it slipped into the queue, instead of hanging
    the queue."""
    tiny = _gen(num_pages=6, prefix_sharing=False)
    sched = ContinuousBatchingScheduler(tiny, n_slots=2, max_new_tokens=OUT)
    rng = np.random.RandomState(13)
    with pytest.raises(PoolCapacityError):
        sched.submit(rng.randint(2, V, SRC), max_new_tokens=OUT)
    bad = sched.submit(rng.randint(2, V, 2), max_new_tokens=2)
    sched._queue[0].src = rng.randint(2, V, SRC)
    sched._queue[0].max_new_tokens = OUT
    sched.run_until_idle()
    assert bad.done and isinstance(bad.error, PoolCapacityError)
    assert tiny.cache_stats()["pages"]["in_use"] == 0


def test_scheduler_backpressure_and_cancel():
    """Two requests that cannot fit together: the second waits and is
    admitted when the first retires; a cancelled queued request leaves
    without touching the pool."""
    tiny = _gen(num_pages=8, prefix_sharing=False, seed=5)
    sched = ContinuousBatchingScheduler(tiny, n_slots=2, max_new_tokens=4)
    rng = np.random.RandomState(17)
    r1 = sched.submit(rng.randint(2, V, SRC), max_new_tokens=4)
    r2 = sched.submit(rng.randint(2, V, SRC), max_new_tokens=4)
    r3 = sched.submit(rng.randint(2, V, 3), max_new_tokens=4)
    sched.step_once()
    assert r1.slot is not None and r2.slot is None      # r2 waits
    r3.cancel()
    sched.run_until_idle()
    assert r1.done and r1.error is None
    assert r2.done and r2.error is None and len(r2.tokens) >= 1
    assert r3.done and isinstance(r3.error, RequestCancelled)
    assert sched.stats()["peak_in_flight"] == 1
    assert tiny.cache_stats()["pages"]["in_use"] == 0
    tiny.alloc.check_invariants()


def test_load_params_refuses_incomplete_or_misshapen_weights():
    """The parameter set is the unified program's persistable vars less
    the pool: every one must come with its shape, and a refused call
    loads nothing."""
    gen = _gen(num_pages=8)
    params = list(gen._param_vars())
    arrays = {n: v * 2 for n, v in
              fluid.scope_to_numpy(gen.scope, params).items()}
    arrays["tf@kv_pool"] = np.zeros(3)              # cache vars: skipped
    arrays["other.enc0.self.q.w"] = np.zeros(3)     # another model: skipped
    w = gen.scope.find_var("tf.vocab_proj.w").clone()
    with pytest.raises(KeyError, match="no value"):
        gen.load_params({k: v for k, v in arrays.items()
                         if k != "tf.vocab_proj.w"})
    with pytest.raises(ValueError, match="shape"):
        gen.load_params(dict(arrays, **{"tf.vocab_proj.w": np.zeros((2, 2))}))
    with pytest.raises(KeyError, match="names no parameter"):
        gen.load_params(dict(arrays, **{"tf.enc9.self.q.w": np.zeros(1)}))
    assert torch.equal(gen.scope.find_var("tf.vocab_proj.w"), w)
    assert gen.load_params(arrays) == len(params)
    assert torch.equal(gen.scope.find_var("tf.vocab_proj.w"),
                       torch.from_numpy(arrays["tf.vocab_proj.w"]))
