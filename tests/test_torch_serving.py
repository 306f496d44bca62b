"""The port's paged serving path against the JAX package, on the CPU.

Both packages serve the same small Transformer (V=24, 2 layers, 2 heads,
d_key=4, d_model=16, page 4, chunk 4) through their own
``build_unified_program`` and Executor (the port's on ``CPUPlace``,
where it keeps the card's caches and buffers and runs the step eagerly
in place of the graph replay): the JAX generator is initialized with
``init_params(seed=7)`` and the port takes its scope through
``load_params``.  Prompts are longer than a chunk, so prefill interleaves
with decode, and two of them share their first page, so prefix sharing
runs.  Checked:

* the port's unified program serializes to the reference's bytes for
  float32, bfloat16 and int8 pools, verify_tokens 1 and 3, with and
  without logit masks, and ``bucket_set`` equals the reference's;
* one unified step (prefill tower + decode step) of the port's Executor
  on the port's program against the JAX Executor on the reference's
  program, from the same pool and feeds: logits within 1e-4 (float32
  throughout, summation order differs), next ids equal, the written pool
  within 1e-5 off the trash page (page 0, rows 0 .. 2L-1, which dead
  lanes and dead chunk positions all write in one unordered scatter and
  no lane reads);
* ``greedy`` token for token for float32, bfloat16 and int8 pools, with
  page tables, refcounts and allocator stats equal bit for bit;
* the same 4 requests through both packages' schedulers give equal
  tokens, and after ``aot_warm(4)`` serving them adds executable hits
  and no misses, as in the reference;
* the pool is one tensor at one address across steps of both
  signatures (``lane_step`` and ``run_feed``);
* ``copy_weights`` from a JAX scope (through numpy) and from port to
  port under another prefix (``dst_prefix``) serve the same tokens.
"""

import itertools

import numpy as np
import pytest
import torch

from paddle_tpu import fluid
from paddle_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving import PagedTransformerGenerator as JaxGenerator
from paddle_tpu.serving import copy_weights
from paddle_tpu.serving import paged_decoder as jax_paged
from paddle_tpu.serving.decoder import _Cfg as JaxCfg
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.observability import registry, tracer
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PagedTransformerGenerator)
from paddle_tpu_torch.serving import paged_decoder as torch_paged
from paddle_tpu_torch.serving.decoder import _Cfg as TorchCfg

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 12, 8, 4, 4
KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
          d_inner_hid=DI, max_length=64, src_len=SRC, max_out_len=OUT,
          page_size=PS, chunk_size=CHUNK, num_pages=64, param_prefix="tf")
KV_DTYPES = ["float32", "bfloat16", "int8"]
POOL = "tf@kv_pool"
CPU = tfluid.CPUPlace()


def _jax_arrays(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.vars
            if scope.find_var(n) is not None}


@pytest.fixture(scope="module")
def pairs():
    """kv_dtype -> (JAX generator, port generator) with equal weights."""
    made = {}
    src_scope = []

    def get(kv_dtype):
        if kv_dtype not in made:
            scope = fluid.Scope()
            jg = JaxGenerator(V, V, scope=scope, kv_dtype=kv_dtype,
                              executor=fluid.Executor(fluid.CPUPlace()),
                              **KW)
            if src_scope:
                copy_weights(src_scope[0], scope, prefix="tf")
            else:
                jg.init_params(seed=7)
                src_scope.append(scope)
            tg = PagedTransformerGenerator(V, V, place=CPU,
                                           kv_dtype=kv_dtype, **KW)
            arrays = _jax_arrays(scope)
            assert tg.load_params(arrays) == \
                len([n for n in arrays if n.startswith("tf.")])
            made[kv_dtype] = (jg, tg)
        return made[kv_dtype]

    return get


def _prompts():
    rng = np.random.RandomState(0)
    shared = rng.randint(2, V, PS)
    seqs = [np.concatenate([shared, rng.randint(2, V, 3)]),
            np.concatenate([shared, rng.randint(2, V, 8)]),
            rng.randint(2, V, 6), rng.randint(2, V, SRC)]
    tok = np.zeros((len(seqs), SRC), np.int64)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = s
    return seqs, tok, np.asarray([len(s) for s in seqs], np.int32)


def _jax_feed(jg):
    """The reference's lane_step feed, built by its own helpers."""
    feed = jg._prefill_arrays()
    dec = jg._decode_arrays()
    for slot, lane in enumerate(jg._lanes):
        if lane.phase == "decode" and lane.self_table:
            jg._fill_decode_lane(dec, slot, lane, [lane.cur], lane.pos)
    feed.update(dec)
    return feed


def _lane_state(gen):
    return [(ln.phase, list(ln.enc_table), list(ln.cross_table),
             list(ln.self_table), ln.enc_done, ln.pos, ln.cur)
            for ln in gen._lanes]


def _alloc_state(alloc):
    return (list(alloc._free), dict(alloc._ref),
            {h: list(e) for h, e in alloc._chunks.items()},
            list(alloc._evictable), alloc.stats())


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_unified_step_matches_jax_executor(pairs, kv_dtype):
    jg, tg = pairs(kv_dtype)
    seqs, _, _ = _prompts()
    for g in (jg, tg):
        g.open_slots(len(seqs))
        g.admit_slot(0, seqs[2], max_new=OUT)        # 6 tokens: 2 chunks
    for _ in range(3):                              # lane 0 decodes ...
        assert jg.lane_step() == tg.lane_step()
    for g in (jg, tg):
        g.admit_slot(1, seqs[3], max_new=OUT)        # ... lane 1 prefills
    # both pools from the reference's state, the port's in place
    pool = tg.scope.find_var(POOL)
    pool.copy_(torch.from_numpy(
        np.asarray(jg.scope.find_var(POOL)).astype(np.float32))
        .to(pool.dtype))
    if kv_dtype == "int8":
        tg.scope.find_var("tf@kv_scales").copy_(torch.tensor(
            np.asarray(jg.scope.find_var("tf@kv_scales"))))
    feed = tg.step_feed()
    jfeed = _jax_feed(jg)
    assert feed.keys() == jfeed.keys()
    for k in feed:
        np.testing.assert_array_equal(feed[k], jfeed[k], err_msg=k)
    prog, _, next_ids, logits = jg._unified
    with fluid.scope_guard(jg.scope):
        j_ids, j_logits = jg.exe.run(prog, feed=jfeed,
                                     fetch_list=[next_ids, logits],
                                     mode="infer")
    t_ids, t_logits = tg.run_feed(feed)
    assert tg.scope.find_var(POOL) is pool          # written in place
    live = [0]                                      # the decoding lane
    np.testing.assert_allclose(t_logits.numpy()[live],
                               np.asarray(j_logits)[live],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_ids.numpy()[live],
                                  np.asarray(j_ids)[live])
    # every page but the trash page (rows 0 .. 2L-1) written alike
    j_pool = np.asarray(jg.scope.find_var(POOL)).astype(np.float32)
    t_pool = pool.to(torch.float32).numpy()
    tol = 1e-5 if kv_dtype == "float32" else 0
    if kv_dtype == "float32":
        np.testing.assert_allclose(t_pool[:, 2 * NL:], j_pool[:, 2 * NL:],
                                   rtol=tol, atol=tol)
    else:
        # rounded on write: a 1e-7 difference before the rounding may
        # still move an element to the neighbouring bf16 value / int8 step
        diff = np.abs(t_pool[:, 2 * NL:] - j_pool[:, 2 * NL:])
        assert (diff > 0).mean() < 0.01
    for g in (jg, tg):
        for slot in range(len(seqs)):
            g.clear_slot(slot)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_greedy_matches_jax_token_for_token(pairs, kv_dtype):
    jg, tg = pairs(kv_dtype)
    _, tok, lens = _prompts()
    for stop_at_end in (False, True):
        want = jg.greedy(tok, lens, max_new=OUT, stop_at_end=stop_at_end)
        got = tg.greedy(tok, lens, max_new=OUT, stop_at_end=stop_at_end)
        np.testing.assert_array_equal(got, want)
        assert _alloc_state(tg.alloc) == _alloc_state(jg.alloc)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_lane_step_page_tables_match_jax(pairs, kv_dtype):
    """Admit, step and retire in lockstep: every step emits the same
    tokens and leaves the same lane tables and allocator state.  Run
    twice, so the second pass admits on prefix-cache hits."""
    jg, tg = pairs(kv_dtype)
    seqs, _, _ = _prompts()
    for _ in range(2):
        for g in (jg, tg):
            g.open_slots(3)
        queue = list(range(len(seqs)))
        counts = {}
        while queue or counts:
            for slot in range(3):
                if slot not in counts.values() and queue:
                    i = queue.pop(0)
                    for g in (jg, tg):
                        g.admit_slot(slot, seqs[i], max_new=OUT)
                    counts[i] = slot
            assert _lane_state(tg) == _lane_state(jg)
            assert _alloc_state(tg.alloc) == _alloc_state(jg.alloc)
            emitted = jg.lane_step()
            assert tg.lane_step() == emitted
            done = [i for i, slot in counts.items()
                    if tg._lanes[slot].pos >= 3]
            for i in done:
                for g in (jg, tg):
                    g.clear_slot(counts[i])
                del counts[i]
        assert _alloc_state(tg.alloc) == _alloc_state(jg.alloc)
    assert tg.cache_stats()["pages"]["prefix_hits"] > 0


def test_scheduler_matches_jax():
    """4 requests through 2 slots (so retirement backfills) in each
    package's ContinuousBatchingScheduler: the same tokens per request."""
    scope = fluid.Scope()
    jg = JaxGenerator(V, V, scope=scope,
                      executor=fluid.Executor(fluid.CPUPlace()), **KW)
    jg.init_params(seed=11)
    tg = PagedTransformerGenerator(V, V, place=CPU, **KW)
    tg.load_params(_jax_arrays(scope))
    seqs, _, _ = _prompts()
    out = []
    for sched_cls, gen in ((JaxScheduler, jg),
                           (ContinuousBatchingScheduler, tg)):
        sched = sched_cls(gen, n_slots=2, max_new_tokens=6)
        reqs = [sched.submit(s) for s in seqs]
        sched.run_until_idle()
        assert all(r.done and r.error is None for r in reqs)
        out.append([r.tokens for r in reqs])
        st = sched.stats()
        assert st["finished"] == len(seqs) and st["failed"] == 0
    assert out[1] == out[0]
    assert all(len(t) > 0 for t in out[1])
    # the port's metrics and trace sinks saw the same lifecycle
    series = {m["name"]: m for m in registry().snapshot()["metrics"]}
    finished = [s["value"] for s in
                series["paddle_serving_requests_total"]["samples"]
                if s["labels"] == {"event": "finished"}]
    assert finished and finished[0] >= len(seqs)
    assert "paddle_kv_pages" in series
    assert len(tracer().events(name="request/retired")) >= len(seqs)


@pytest.mark.parametrize("kv_dtype,verify_tokens,logit_masks",
                         list(itertools.product(KV_DTYPES, [1, 3],
                                                [False, True])))
def test_unified_program_bytes_match_reference(kv_dtype, verify_tokens,
                                               logit_masks):
    """The canonical-JSON contract: the port's serving program and its
    startup program are the reference's, byte for byte."""
    dims = (V, V, NL, NH, DK, DK, DM, DI, 64)
    kw = dict(src_len=SRC, max_out_len=OUT, page_size=PS, num_pages=64,
              chunk_size=CHUNK, param_prefix="tf", kv_dtype=kv_dtype,
              verify_tokens=verify_tokens, logit_masks=logit_masks)
    want = jax_paged.build_unified_program(JaxCfg(*dims), **kw)
    got = torch_paged.build_unified_program(TorchCfg(*dims), **kw)
    for w, g in zip(want[:2], got[:2]):
        assert g.desc.serialize_to_string() == w.desc.serialize_to_string()
    assert (got[2].name, got[3].name) == (want[2].name, want[3].name)


@pytest.mark.parametrize("n_slots", [1, 4, 8])
def test_bucket_set_matches_reference(pairs, n_slots):
    jg, tg = pairs("float32")
    got = tg.bucket_set(n_slots)
    assert got == jg.bucket_set(n_slots)
    assert len(got) == 1 and got[0]["closed"]
    assert got[0]["feeds"]["trg_word"]["shape"] == [n_slots, 1]


def test_aot_warm_then_serving_only_hits():
    """After ``aot_warm(4)`` the executable cache holds the step at 4
    lanes: serving 4 requests through 4 slots adds hits and no misses,
    in both packages alike, and the warm-up changes no page."""
    scope = fluid.Scope()
    jg = JaxGenerator(V, V, scope=scope,
                      executor=fluid.Executor(fluid.CPUPlace()), **KW)
    jg.init_params(seed=5)
    tg = PagedTransformerGenerator(V, V, place=CPU, **KW)
    tg.load_params(_jax_arrays(scope))
    seqs, _, _ = _prompts()
    deltas, tokens = [], []
    for sched_cls, gen in ((JaxScheduler, jg),
                           (ContinuousBatchingScheduler, tg)):
        pages = gen.cache_stats()["pages"]
        gen.aot_warm(4)
        assert gen.cache_stats()["pages"] == pages
        assert all(lane.phase == "idle" for lane in gen._lanes)
        before = gen.cache_stats()["executable"]
        sched = sched_cls(gen, n_slots=4, max_new_tokens=4)
        reqs = [sched.submit(s) for s in seqs]
        sched.run_until_idle()
        assert all(r.done and r.error is None for r in reqs)
        after = gen.cache_stats()["executable"]
        deltas.append({k: after[k] - before[k]
                       for k in ("hits", "misses")})
        tokens.append([r.tokens for r in reqs])
    assert tokens[1] == tokens[0]
    assert deltas[1] == deltas[0]
    assert deltas[1]["misses"] == 0 and deltas[1]["hits"] > 0


def test_pool_keeps_one_address_across_both_signatures():
    """``lane_step`` (fetch: ids) and ``run_feed`` (ids and logits) are
    two executable entries over one pool: stepping them in turns leaves
    the scope's pool one tensor at one address, written in place, and
    gives the tokens of ``lane_step`` alone."""
    scope = fluid.Scope()
    jg = JaxGenerator(V, V, scope=scope,
                      executor=fluid.Executor(fluid.CPUPlace()), **KW)
    jg.init_params(seed=3)
    seqs, _, _ = _prompts()
    gens = []
    for _ in range(2):
        g = PagedTransformerGenerator(V, V, place=CPU, **KW)
        g.load_params(_jax_arrays(scope))
        g.open_slots(2)
        g.admit_slot(0, seqs[1], max_new=OUT)
        g.admit_slot(1, seqs[3], max_new=OUT)
        gens.append(g)
    mixed, alone = gens
    pool = mixed.scope.find_var(POOL)
    ptr = pool.data_ptr()
    for i in range(8):
        if i % 2:
            ids, _ = mixed.run_feed(mixed.step_feed())
            got = mixed.absorb_step(ids.numpy())
        else:
            got = mixed.lane_step()
        assert got == alone.lane_step()
        assert mixed.scope.find_var(POOL) is pool
        assert pool.data_ptr() == ptr
    np.testing.assert_array_equal(mixed.scope.find_var(POOL).numpy(),
                                  alone.scope.find_var(POOL).numpy())
    assert mixed.cache_stats()["executable"]["size"] == 2


def test_scope_tensors_are_the_steps_buffers():
    """Every scope tensor the step reads, or writes in place, becomes the
    executor's buffer as it is, as the reference donates its state: no
    var moves at the first step, and a pool the caller holds is the one
    every later step writes."""
    tg = PagedTransformerGenerator(V, V, place=CPU, **KW)
    tg.init_params(seed=1)
    held = tg.scope.find_var(POOL)
    ptrs = {n: v.data_ptr() for n, v in tg.scope.vars.items()
            if isinstance(v, torch.Tensor)}
    tg.open_slots(1)
    tg.admit_slot(0, _prompts()[0][0], max_new=OUT)
    tg.lane_step()
    assert {n: tg.scope.find_var(n).data_ptr() for n in ptrs} == ptrs
    before = held.clone()
    tg.lane_step()
    assert tg.scope.find_var(POOL) is held
    assert not torch.equal(held, before)


def test_copy_weights_from_jax_and_port_to_port():
    """``copy_weights`` carries a JAX scope into the port's generator (as
    numpy arrays the executor uploads) and a port scope into another
    generator under ``dst_prefix``; cache vars stay behind.  All serve
    the reference's tokens."""
    scope = fluid.Scope()
    jg = JaxGenerator(V, V, scope=scope,
                      executor=fluid.Executor(fluid.CPUPlace()), **KW)
    jg.init_params(seed=9)
    _, tok, lens = _prompts()
    want = jg.greedy(tok, lens, max_new=OUT, stop_at_end=False)
    tg = PagedTransformerGenerator(V, V, place=CPU, **KW)
    n = torch_paged.copy_weights(scope, tg.scope, prefix="tf")
    assert n == len([k for k in _jax_arrays(scope)
                     if k.startswith("tf.")])
    np.testing.assert_array_equal(
        tg.greedy(tok, lens, max_new=OUT, stop_at_end=False), want)
    assert isinstance(tg.scope.find_var("tf.vocab_proj.w"), torch.Tensor)
    other = PagedTransformerGenerator(V, V, place=CPU,
                                      **dict(KW, param_prefix="tg2"))
    assert torch_paged.copy_weights(tg.scope, other.scope, prefix="tf",
                                    dst_prefix="tg2") == n
    assert other.scope.find_var("tg2@kv_pool") is not None
    assert not any(k.startswith("tf") for k in other.scope.vars)
    np.testing.assert_array_equal(
        other.greedy(tok, lens, max_new=OUT, stop_at_end=False), want)
    with pytest.raises(ValueError, match="dst_prefix requires prefix"):
        torch_paged.copy_weights(tg.scope, other.scope, dst_prefix="x")
