"""The port's tiered KV cache and sessions against the JAX package, on
the CPU, at the reference tests' sizes (``tests/test_kv_tier.py``: V=24,
2 layers, 2 heads, d_key=4, d_model=16, page 4, chunk 4, 64 pages, 16
host pages).

* The four transfer ops (``paged_page_gather`` / ``paged_page_scatter``
  and their int8 forms) against the JAX emitters for float32, bfloat16
  and int8 pools: gathers bit for bit, scatters bit for bit off the
  trash page (the padding entries' rows, written in one unordered
  scatter), the pool and the scales written in place.
* The transfer programs serialize to the reference's bytes, and the
  host tier's allocator (a ``HostPool`` behind ``set_pager``) makes the
  reference's decisions under random interleavings.
* Per pool dtype, a tiered generator of each package from the same
  weights: suspend and resume give the tokens of the JAX package's run
  and of an uninterrupted decode; evicted chunks demote and promote
  back bitwise; ``session_fingerprint`` is the reference's; an artifact
  written by either package loads in the other and resumes to the same
  tokens; a full tier cycle after warm-up adds no executable miss; the
  scheduler's session lifecycle, with a seeded ``kv.spill_corrupt``
  degrading to re-prefill, gives the JAX package's tokens and the
  stats schema.
* The session store's framing is the reference's byte for byte (bf16
  as a ``torch.bfloat16`` tensor, no ``ml_dtypes`` needed), and its
  integrity semantics (stale fingerprint, torn artifact, host LRU, idle
  spill) are the reference's.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.ops import cache_ops as jax_cache_ops
from paddle_tpu.resilience import chaos as jax_chaos
from paddle_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving import PageAllocator as JaxAllocator
from paddle_tpu.serving import PagedTransformerGenerator as JaxGenerator
from paddle_tpu.serving import SessionStore as JaxStore
from paddle_tpu.serving import TransformerGenerator as JaxDense
from paddle_tpu.serving import sessions as jax_sessions
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.core.desc import OpDesc
from paddle_tpu_torch.fluid.core.registry import EmitCtx, get_op_info
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PageAllocator,
                                      PagedTransformerGenerator,
                                      SessionStore, sessions)

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 8, 16, 4, 4
HOST_PAGES = 16
# greedy decode of this prompt under the seed-7 weights emits no end_id
# for 12 steps (the reference test's probed prompt)
PROMPT = np.array([14, 17, 23, 2, 5, 5], np.int64)
KV_DTYPES = ["float32", "bfloat16", "int8"]
KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
          d_inner_hid=DI, max_length=64, src_len=SRC, max_out_len=OUT,
          page_size=PS, chunk_size=CHUNK, num_pages=64,
          host_pages=HOST_PAGES)


@pytest.fixture(autouse=True)
def _inert_chaos():
    prev, jprev = chaos.install(chaos.FaultInjector()), \
        jax_chaos.install(jax_chaos.FaultInjector())
    yield
    chaos.install(prev)
    jax_chaos.install(jprev)


# -- the transfer ops -------------------------------------------------------

H, D, L, NPAGES, W = 2, 4, 2, 6, 4
R = NPAGES * 2 * L
TRASH_ROWS = 2 * L


class _Ctx:
    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _emit(op_type, ins, **attrs):
    ctx = EmitCtx(OpDesc(op_type, attrs=attrs))
    return get_op_info(op_type).emit(ctx, {k: [v] for k, v in ins.items()})


def _rand(kv_dtype, rng, shape):
    """(numpy for JAX, tensor for the port) holding the same values."""
    f = rng.randn(*shape).astype(np.float32)
    if kv_dtype == "float32":
        return f, torch.from_numpy(f.copy())
    if kv_dtype == "bfloat16":
        b = f.astype(ml_dtypes.bfloat16)
        return b, torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)
    q = rng.randint(-127, 128, shape).astype(np.int8)
    return q, torch.from_numpy(q.copy())


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_transfer_ops_match_jax(kv_dtype):
    rng = np.random.RandomState(3)
    pool_np, pool = _rand(kv_dtype, rng, (H, R, PS, D))
    pages_np = np.array([3, 1, 0, 0], np.int32)      # two pages, padded
    pages = torch.from_numpy(pages_np)
    data_np, data = _rand(kv_dtype, rng, (H, W * 2 * L, PS, D))
    attrs = dict(n_layer=L)
    if kv_dtype == "int8":
        sc_np = rng.rand(1, R, PS).astype(np.float32)
        sc = torch.from_numpy(sc_np.copy())
        sdata_np = rng.rand(1, W * 2 * L, PS).astype(np.float32)
        want = jax_cache_ops.quantized_paged_page_gather(
            _Ctx(**attrs), jnp.asarray(pool_np), jnp.asarray(sc_np),
            jnp.asarray(pages_np))
        got = _emit("quantized_paged_page_gather",
                    {"Pool": pool, "Scales": sc, "Pages": pages}, **attrs)
        gathered = [(got["Out"][0], want[0]), (got["ScalesOut"][0], want[1])]
        want_w = jax_cache_ops.quantized_paged_page_scatter(
            _Ctx(**attrs), jnp.asarray(pool_np), jnp.asarray(sc_np),
            jnp.asarray(data_np), jnp.asarray(sdata_np),
            jnp.asarray(pages_np))
        got_w = _emit("quantized_paged_page_scatter",
                      {"Pool": pool, "Scales": sc, "Data": data,
                       "ScaleData": torch.from_numpy(sdata_np),
                       "Pages": pages}, **attrs)
        assert got_w["Out"][0] is pool and got_w["ScalesOut"][0] is sc
        written = [(pool, want_w[0]), (sc, want_w[1])]
    else:
        want = jax_cache_ops.paged_page_gather(
            _Ctx(**attrs), jnp.asarray(pool_np), jnp.asarray(pages_np))
        got = _emit("paged_page_gather", {"Pool": pool, "Pages": pages},
                    **attrs)
        gathered = [(got["Out"][0], want)]
        want_w = jax_cache_ops.paged_page_scatter(
            _Ctx(**attrs), jnp.asarray(pool_np), jnp.asarray(data_np),
            jnp.asarray(pages_np))
        got_w = _emit("paged_page_scatter",
                      {"Pool": pool, "Data": data, "Pages": pages}, **attrs)
        assert got_w["Out"][0] is pool                # written in place
        written = [(pool, want_w)]
    for g, w in gathered:
        # the padding entries gather the trash page as it was: all equal
        np.testing.assert_array_equal(_f32(g), _f32(w))
    for g, w in written:
        np.testing.assert_array_equal(_f32(g)[:, TRASH_ROWS:],
                                      _f32(w)[:, TRASH_ROWS:])


def _xfer_bytes(gen):
    progs = gen._xfer()
    return [progs["down"][0].desc.serialize_to_string(),
            progs["up"].desc.serialize_to_string()]


class _FakePager:
    """A pager whose payload records what was downloaded."""

    def __init__(self):
        self.up = []

    def download(self, pages):
        return {"pages": list(pages)}

    def upload(self, pages, payload):
        self.up.append((list(pages), payload["pages"]))


def _tier_state(a):
    host = a.host
    return (list(a._free), dict(a._ref),
            {h: list(e) for h, e in a._chunks.items()},
            list(a._evictable), a.stats(),
            list(host._entries.items()) if host is not None else None)


@pytest.mark.parametrize("seed", [5, 11])
def test_tiered_allocator_random_interleavings_match_jax(seed):
    """Admissions, prefix inserts and hits, retires, demotions,
    promotions and host-LRU evictions in one random order on both
    allocators (12 pages, 6 host pages): the same states, payloads and
    errors after every operation, and both tiers' invariants."""
    rng = np.random.RandomState(seed)
    ours, ref = PageAllocator(12, PS, host_pages=6), \
        JaxAllocator(12, PS, host_pages=6)
    pagers = [_FakePager(), _FakePager()]
    for a, p in zip((ours, ref), pagers):
        a.set_pager(p.download, p.upload, page_bytes=100)
    held = []                      # (hash or None, pages) per "request"
    hashes = [f"h{i}" for i in range(10)]
    for _ in range(300):
        op = rng.randint(6)
        h = hashes[rng.randint(len(hashes))]
        n = int(rng.randint(1, 4))
        outs = []
        for a in (ours, ref):
            try:
                if op == 0:
                    outs.append(a.alloc(n))
                elif op == 1 and not a.host_lookup_chain([h]):
                    # a fresh chunk (a demoted one: see the next test)
                    outs.append(a.insert_chunk(h, *a.alloc(2)))
                elif op == 2 and a.lookup_chain([h]):
                    a.ref_chunk(h)
                    outs.append("ref")
                elif op == 3:
                    outs.append(a.demote_one())
                elif op == 4:
                    outs.append(a.promote_chunk(h))
                else:
                    outs.append(a.host_lookup_chain(hashes[:4]))
            except Exception as e:            # the same error on both
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (op, outs)
        if op == 0 and isinstance(outs[0], list):
            held.append((None, outs[0]))
        elif (op == 1 and outs[0] is True) or (op == 2 and outs[0] == "ref"):
            held.append((h, []))
        if held and rng.rand() < 0.35:
            hh, pages = held.pop(rng.randint(len(held)))
            for a in (ours, ref):
                if hh is not None:
                    a.unref_chunk(hh)
                for p in pages:
                    a.unref(p)
        assert _tier_state(ours) == _tier_state(ref)
        ours.check_invariants()
    assert pagers[0].up == pagers[1].up
    assert ours.stats()["demotes"] > 0 and ours.stats()["promotes"] > 0


def test_insert_of_a_demoted_hash_leaves_it_in_both_tiers():
    """Inherited from the reference: admission looks up the prefix cache
    on the card only, so a prompt whose chunk was demoted (and not
    prefetched back) prefills it again, and ``insert_chunk`` registers
    the hash while the host tier still holds its old payload.  Both
    allocators then hold the hash in both tiers, and both packages'
    ``check_invariants`` refuse that state alike."""
    states = []
    for a in (PageAllocator(8, PS, host_pages=4),
              JaxAllocator(8, PS, host_pages=4)):
        p = _FakePager()
        a.set_pager(p.download, p.upload, page_bytes=100)
        assert a.insert_chunk("h", *a.alloc(2))
        a.unref_chunk("h")
        assert a.demote_one() and "h" in a.host
        assert a.lookup_chain(["h"]) == []       # the admission's probe
        assert a.insert_chunk("h", *a.alloc(2))
        assert "h" in a._chunks and "h" in a.host
        with pytest.raises(AssertionError, match="both tiers"):
            a.check_invariants()
        states.append(_tier_state(a))
    assert states[0] == states[1]


# -- the tiered generator -----------------------------------------------------

def _jax_arrays(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.vars
            if scope.find_var(n) is not None}


@pytest.fixture(scope="module")
def tiered(tmp_path_factory):
    """kv_dtype -> (JAX generator, port generator, their stores, the
    uninterrupted greedy decode of PROMPT, 12 tokens)."""
    made = {}

    def get(kv_dtype):
        if kv_dtype in made:
            return made[kv_dtype]
        d = tmp_path_factory.mktemp(f"kvs-{kv_dtype}")
        jstore = JaxStore(dirname=str(d / "jax"))
        tstore = SessionStore(dirname=str(d / "port"))
        scope = jfluid.Scope()
        jg = JaxGenerator(V, V, scope=scope, kv_dtype=kv_dtype,
                          executor=jfluid.Executor(jfluid.CPUPlace()),
                          session_store=jstore, param_prefix="tft", **KW)
        # the reference test's weights: its dense decoder's init over the
        # shared parameter names
        JaxDense(V, V, scope=scope, executor=jg.exe, param_prefix="tft",
                 causal_encoder=True,
                 **{k: v for k, v in KW.items()
                    if k not in ("page_size", "chunk_size", "num_pages",
                                 "host_pages")}).init_params(seed=7)
        tg = PagedTransformerGenerator(V, V, kv_dtype=kv_dtype,
                                       place=fluid.CPUPlace(),
                                       session_store=tstore,
                                       param_prefix="tft", **KW)
        tg.load_params(_jax_arrays(scope))
        srcp = np.zeros((1, SRC), np.int64)
        srcp[0, :len(PROMPT)] = PROMPT
        ref = [int(t) for t in tg.greedy(srcp, [len(PROMPT)], max_new=12,
                                         stop_at_end=False)[0]]
        assert tg.end_id not in ref[:10]
        made[kv_dtype] = (jg, tg, jstore, tstore, ref)
        return made[kv_dtype]

    return get


def _decode(gen, slot, want, toks):
    for _ in range(4 * OUT):
        if len(toks) >= want:
            return
        out = gen.lane_step()
        if slot in out:
            toks.append(int(out[slot]))
    raise AssertionError(f"lane never produced {want} tokens: {toks}")


def _suspend_resume(gen, sid):
    """Decode 4 tokens, suspend, resume into the other slot, decode to
    10: the tokens and the tier counters."""
    gen.open_slots(2)
    gen.admit_slot(0, PROMPT, max_new=10)
    toks = []
    _decode(gen, 0, 4, toks)
    assert gen.detach_slot(0, sid)
    assert gen.tier_maintenance()
    res = gen.resume_slot(1, sid)
    assert res is not None and res["pos"] == 4
    _decode(gen, 1, 10, toks)
    gen.clear_slot(1)
    return toks


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_suspend_resume_matches_jax(tiered, kv_dtype):
    jg, tg, jstore, tstore, ref = tiered(kv_dtype)
    assert _xfer_bytes(tg) == _xfer_bytes(jg)
    assert tg.session_fingerprint() == jg.session_fingerprint()
    want = _suspend_resume(jg, f"p-{kv_dtype}")
    got = _suspend_resume(tg, f"p-{kv_dtype}")
    assert got == want == ref[:10]
    meta, arrays = tstore.get(f"p-{kv_dtype}", tg.session_fingerprint())
    jmeta, jarrays = jstore.get(f"p-{kv_dtype}", jg.session_fingerprint())
    assert meta == jmeta and sorted(arrays) == sorted(jarrays)
    if kv_dtype == "int8":
        assert "cross_scales" in arrays and "self_scales" in arrays
    if kv_dtype == "bfloat16":
        assert arrays["self_kv"].dtype == torch.bfloat16
    # the KV of the written tokens (a page's later slots hold whatever
    # the pool held there): float32 to summation order, the rounded
    # pools to a step of their rounding (bf16 ulp, int8 step)
    tol = {"float32": 1e-5, "bfloat16": 2 ** -7, "int8": 1.0}[kv_dtype]
    n_tok = {"cross": meta["s_true"], "self": meta["pos"]}
    for name in arrays:
        n = n_tok[name.split("_")[0]]
        np.testing.assert_allclose(_live(_f32(arrays[name]), n),
                                   _live(_f32(jarrays[name]), n),
                                   atol=tol * 4, rtol=tol)
    stats = tg.cache_stats()["tiers"]
    assert stats == jg.cache_stats()["tiers"]
    assert gen_misses(tg, "never-stored") == gen_misses(jg, "never-stored")


def _live(a, n_tokens):
    """An artifact slab [h, pages*2L, ps, ...] with the slots of tokens
    at or past ``n_tokens`` zeroed."""
    a = a.copy()
    pages = a.shape[1] // (2 * NL)
    tok = (np.arange(pages)[:, None] * PS
           + np.arange(PS)[None, :])                    # [pages, ps]
    dead = np.repeat(tok >= n_tokens, 2 * NL, axis=0)    # [pages*2L, ps]
    a[:, dead] = 0
    return a


def gen_misses(gen, sid):
    gen.open_slots(1)
    before = gen._tier_stats["resume_misses"]
    assert gen.resume_slot(0, sid) is None
    return gen._tier_stats["resume_misses"] - before


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_artifacts_load_across_packages(tiered, kv_dtype):
    """A session the JAX package suspended resumes in the port (and the
    reverse) to the uninterrupted decode's tokens: same fingerprint, the
    same framing."""
    jg, tg, jstore, tstore, ref = tiered(kv_dtype)
    for src_gen, dst_gen, dst_store, sid in (
            (jg, tg, tstore, f"x-{kv_dtype}-a"),
            (tg, jg, jstore, f"x-{kv_dtype}-b")):
        src_gen.open_slots(1)
        src_gen.admit_slot(0, PROMPT, max_new=10)
        toks = []
        _decode(src_gen, 0, 5, toks)
        assert src_gen.detach_slot(0, sid) and src_gen.tier_maintenance()
        raw = open(src_gen.sessions._path(sid), "rb").read()
        dst = dst_store._path(sid)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(raw)
        dst_gen.open_slots(1)
        assert dst_gen.resume_slot(0, sid) is not None
        _decode(dst_gen, 0, 10, toks)
        dst_gen.clear_slot(0)
        assert toks == ref[:10], (src_gen, toks)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_evict_spill_reload_bitwise(tiered, kv_dtype):
    """Chunks demoted to the host tier and promoted back land on fresh
    pages with the same bytes (pool rows and, for int8, the scale rows),
    and the allocator makes the JAX package's moves."""
    jg, tg, _, _, _ = tiered(kv_dtype)
    for g in (jg, tg):
        g.open_slots(1)
        g.admit_slot(0, PROMPT, max_new=2)
        _decode(g, 0, 2, [])
        g.clear_slot(0)
    a = tg.alloc
    h = next(iter(a._chunks))
    before = tg._tier_download(a._chunks[h][:2])
    moves = []
    for g in (jg, tg):
        n = 0
        while g.alloc.demote_one():
            n += 1
        promoted = g.alloc.promote_chunk(h)
        st = g.alloc.stats()
        moves.append((n, promoted, [st[k] for k in (
            "free", "in_use", "evictable", "cached_chunks", "host_chunks",
            "host_pages_used")]))
    assert moves[0] == moves[1] and moves[1][0] >= 1 and moves[1][1]
    after = tg._tier_download(a._chunks[h][:2])
    for k in ("kv", "scales"):
        if before[k] is None:
            assert after[k] is None
            continue
        assert torch.equal(torch.as_tensor(_bits(before[k])),
                           torch.as_tensor(_bits(after[k])))
    a.check_invariants()


def _bits(x):
    return x.view(torch.int16) if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_no_executable_miss_after_warm_up(tiered, kv_dtype):
    """A full admit / decode / suspend / resume / demote / prefetch cycle
    after a first one adds no executable miss: the transfer programs
    are two fixed-width entries."""
    _, tg, _, _, _ = tiered(kv_dtype)
    tg.open_slots(1)

    def cycle(sid):
        tg.admit_slot(0, PROMPT, max_new=6)
        toks = []
        _decode(tg, 0, 3, toks)
        assert tg.detach_slot(0, sid)
        tg.tier_maintenance()
        assert tg.resume_slot(0, sid) is not None
        _decode(tg, 0, 6, toks)
        tg.clear_slot(0)
        while tg.alloc.demote_one():
            pass
        tg.tier_maintenance(prefetch=PROMPT)

    cycle("warm-1")
    warm = tg.exe.cache_stats()["executable"]["misses"]
    cycle("warm-2")
    assert tg.exe.cache_stats()["executable"]["misses"] == warm
    assert tg._tier_stats["prefetches"] >= 1


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_scheduler_sessions_and_spill_corrupt_match_jax(tiered, kv_dtype):
    """The scheduler's session lifecycle in both packages: a retire
    suspends, a same-session submit resumes with the continuation
    tokens, a lost artifact and a torn one (the seeded
    ``kv.spill_corrupt`` point) degrade to re-prefill with the same
    tokens; the stats schema carries the tier and spill blocks."""
    out = []
    for sched_cls, gen, inst in (
            (JaxScheduler, tiered(kv_dtype)[0], jax_chaos.install),
            (ContinuousBatchingScheduler, tiered(kv_dtype)[1],
             chaos.install)):
        inj = jax_chaos.FaultInjector if sched_cls is JaxScheduler \
            else chaos.FaultInjector
        sched = sched_cls(gen, n_slots=2, max_new_tokens=OUT)
        sid = f"conv-{kv_dtype}"
        rows = []
        r = sched.submit(PROMPT, max_new_tokens=4, session=sid)
        sched.run_until_idle()
        rows.append((r.tokens, r.resumed, r.error))
        r = sched.submit(PROMPT, max_new_tokens=6, session=sid)
        sched.run_until_idle()
        rows.append((r.tokens, r.resumed, r.error))
        gen.sessions.delete(sid)
        r = sched.submit(PROMPT, max_new_tokens=4, session=sid)
        sched.run_until_idle()
        rows.append((r.tokens, r.resumed, r.error))
        corrupt0 = gen.sessions.stats()["corrupt"]
        inst(inj(spec="kv.spill_corrupt=1.0", seed=3))
        r = sched.submit(PROMPT, max_new_tokens=4, session=sid)
        sched.run_until_idle()
        inst(inj())
        rows.append((r.tokens, r.resumed, r.error))
        rows.append(gen.sessions.stats()["corrupt"] - corrupt0)
        st = sched.stats()["kv"]
        assert isinstance(st["kv_bytes_per_token"], float)
        assert st["tiers"]["host_pages"] == HOST_PAGES
        # the reference's schema less its mesh block ("shard")
        rows.append(sorted(set(st) - {"shard"}) + sorted(st["tiers"])
                    + sorted(st["spills"]))
        out.append(rows)
    assert out[1] == out[0]
    ref = tiered(kv_dtype)[4]
    assert out[1][:5] == [(ref[:4], False, None), (ref[4:10], True, None),
                          (ref[:4], False, None), (ref[:4], False, None), 1]


# -- the session store --------------------------------------------------------

def test_chaos_draws_match_jax():
    for seed in (0, 3, 7):
        for point in ("kv.spill_corrupt", "master.http"):
            assert [chaos.FaultInjector.decision(seed, point, i)
                    for i in range(50)] == \
                [jax_chaos.FaultInjector.decision(seed, point, i)
                 for i in range(50)]
    ours = chaos.FaultInjector(spec="kv.spill_corrupt=0.3", seed=9)
    ref = jax_chaos.FaultInjector(spec="kv.spill_corrupt=0.3", seed=9)
    assert [ours.should("kv.spill_corrupt") for _ in range(64)] == \
        [ref.should("kv.spill_corrupt") for _ in range(64)]


def test_framing_is_the_references_byte_for_byte(monkeypatch):
    """The same arrays frame to the same bytes in both packages (the
    clock pinned: the header records the time); a bf16 slab as a
    ``torch.bfloat16`` tensor frames as the reference frames an
    ``ml_dtypes`` array, and each package reads the other's artifact."""
    for mod in (sessions, jax_sessions):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    f = np.arange(48, dtype=np.float32).reshape(2, 3, 8) / 7
    b = f.astype(ml_dtypes.bfloat16)
    q = (np.arange(24) - 12).astype(np.int8).reshape(2, 12)
    meta = {"pos": 4, "src": [3, 4]}
    theirs = jax_sessions._frame("s", "fp", meta, {"f": f, "b": b, "q": q})
    ours = sessions._frame("s", "fp", meta, {
        "f": f, "q": q,
        "b": torch.from_numpy(f).to(torch.bfloat16)})
    assert ours == theirs
    assert sessions._frame("s", "fp", meta, {"f": f, "b": b, "q": q}) \
        == theirs
    got_meta, got = sessions._unframe(theirs, "s", "fp")
    assert got_meta == meta and got["b"].dtype == torch.bfloat16
    assert got["b"].view(torch.int16).numpy().tobytes() == b.tobytes()
    assert got["f"].tobytes() == f.tobytes() and got["q"].dtype == np.int8
    _, back = jax_sessions._unframe(ours, "s", "fp")
    assert back["b"].tobytes() == b.tobytes()
    assert sessions._unframe(theirs, "s", "other") == ("stale", {})
    assert sessions._unframe(theirs[:-1], "s", "fp") is None


def test_session_store_integrity_semantics(tmp_path):
    """The reference's store contract: bf16 round-trips bitwise, a stale
    fingerprint is a miss that keeps the artifact, a torn disk artifact
    drops from both tiers, host RAM is LRU-bounded, and idle sessions
    spill their RAM copy to disk only."""
    store = SessionStore(dirname=str(tmp_path / "a"), host_bytes=1 << 20)
    kv = np.arange(64, dtype=np.float32).reshape(2, 32)
    bf = torch.from_numpy(kv).to(torch.bfloat16)
    assert store.put("s", "fp-A", {"pos": 3}, {"kv": kv, "bf": bf})
    meta, arrays = store.get("s", "fp-A")
    assert meta["pos"] == 3
    assert arrays["kv"].tobytes() == kv.tobytes()
    assert torch.equal(arrays["bf"].view(torch.int16), bf.view(torch.int16))
    assert store.get("s", "fp-B") is None
    assert store.stats()["resume_misses"] == 1
    assert store.get("s", "fp-A") is not None
    store.spill_idle(0.0)
    path = store._path("s")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])
    assert store.get("s", "fp-A") is None
    assert store.stats()["corrupt"] == 1
    assert not store.has("s")
    store.check_invariants()
    small = SessionStore(dirname=str(tmp_path / "b"),
                         host_bytes=kv.nbytes + 512)
    small.put("one", "fp", {}, {"kv": kv})
    small.put("two", "fp", {}, {"kv": kv})
    st = small.stats()
    assert st["host_sessions"] == 1 and st["disk_sessions"] == 2
    assert st["host_evictions"] == 1
    assert small.get("one", "fp") is not None
    small.check_invariants()


def test_refuses_the_mesh_only():
    """The sharded mesh is the one generator option left unported; the
    tier's options build an untiered generator when host_pages is 0."""
    with pytest.raises(NotImplementedError, match="mesh"):
        PagedTransformerGenerator(V, V, place=fluid.CPUPlace(),
                                  mesh_axes={"model": 2})
    g = PagedTransformerGenerator(V, V, place=fluid.CPUPlace(),
                                  **dict(KW, host_pages=0), xfer_width=2,
                                  demote_watermark=3)
    g.init_params(seed=1)
    assert not g.alloc.tiered and g.xfer_width == 2
    assert g.cache_stats()["tiers"]["host_pages"] == 0
    assert g.cache_stats()["sessions"] is None
    g.open_slots(1)
    g.admit_slot(0, PROMPT, max_new=2)
    _decode(g, 0, 1, [])
    assert not g.detach_slot(0, "no-store")      # sessions off
