"""Beam search on the port's paged engine against the JAX package, on
the CPU.

Ops, through the port's registry against the JAX emitters on the same
numpy inputs:

* ``top_k`` and ``beam_search`` with planted ties (equal probabilities,
  finished beams whose other candidates all sit at -1e9, and the first
  step's -1e9 beams, where ``-1e9 + log p`` collapses): equal ids,
  indices and parents, the lower index first as ``jax.lax.top_k``
  orders ties; scores within 1e-6 (``log`` may round differently);
* ``beam_search_decode``: ``data``, ``outer_lengths`` and
  ``inner_lengths`` equal, scores within 1e-6, over trajectories with
  ``end_id`` at several depths;
* ``batch_gather`` forward, and its gradient through a program's
  ``append_backward`` (the scatter-add transpose autograd derives);
* ``paged_page_copy`` / ``quantized_paged_page_copy`` for float32,
  bfloat16 and int8 pools: bit for bit, the pool (and scales) written
  in place, the no-copy lanes (trash page to trash page) included.

Programs: the paged beam step for float32, bfloat16 and int8 pools at
W = 2 and 3, and the backtrace program, serialize to the reference's
bytes.

Paths (V=24, 2 layers, 2 heads, d_key 4, d_model 16, page 4, chunk 4;
the port's generator on ``CPUPlace`` with the JAX generator's weights):
``PagedTransformerGenerator.beam`` at b = 2, W = 3 on float32 and int8
pools gives the reference's ids and parents at every step, scores
within 1e-4, the same backtrace, ``cow_copies`` and allocator state,
and leaves no page in use; an error inside the beam loop leaves none
either; the int8 pool's beam agrees with the float32 pool's on at least
0.9 of its ids (as the reference holds it); a second beam at the same
(b, W) adds no executable miss, and the beam step holds the scope's
pool as its buffer, the unified step's tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core.lod import SeqArray as JSeqArray
from paddle_tpu.fluid.ops import beam_ops as jax_beam_ops
from paddle_tpu.fluid.ops import cache_ops as jax_cache_ops
from paddle_tpu.fluid.ops import tensor_ops as jax_tensor_ops
from paddle_tpu.serving import PagedTransformerGenerator as JaxGenerator
from paddle_tpu.serving import copy_weights
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core.desc import OpDesc
from paddle_tpu_torch.fluid.core.lod import NestedSeqArray, SeqArray
from paddle_tpu_torch.fluid.core.registry import EmitCtx, get_op_info
from paddle_tpu_torch.serving import PagedTransformerGenerator

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 12, 8, 4, 4
KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
          d_inner_hid=DI, max_length=64, src_len=SRC, max_out_len=OUT,
          page_size=PS, chunk_size=CHUNK, num_pages=64, param_prefix="tf")
KV_DTYPES = ["float32", "bfloat16", "int8"]
CPU = tfluid.CPUPlace()
W = 3
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)


class _Ctx:
    """The attribute surface a JAX op emitter reads."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _emit(op_type, ins, **attrs):
    """The port's registered emitter of ``op_type`` on ``ins``."""
    ctx = EmitCtx(OpDesc(op_type, attrs=attrs))
    return get_op_info(op_type).emit(
        ctx, {k: [v] for k, v in ins.items() if v is not None})


# -- ops -------------------------------------------------------------------

def _tied_probs(rng, B, Wb, V_):
    """Softmax rows with planted ties: each row repeats its top values
    at several indices, and one row is uniform."""
    p = rng.rand(B, Wb, V_).astype(np.float32)
    p[..., 3] = p[..., 7] = p[..., 11] = p.max() + 0.5   # a three-way tie
    p[0, 1] = 1.0                                        # all equal
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("k", [1, 4, 6])
def test_top_k_breaks_ties_as_jax(k):
    rng = np.random.RandomState(k)
    x = _tied_probs(rng, 2, 3, 16)
    x[1, 2, :] = -1e9 + np.float32(rng.randn(16)) * 10   # collapses to -1e9
    want_v, want_i = jax_tensor_ops.top_k(_Ctx(k=k), jnp.asarray(x))
    out = _emit("top_k", {"X": torch.from_numpy(x)}, k=k)
    assert out["Indices"][0].dtype == torch.int32
    np.testing.assert_array_equal(out["Indices"][0].numpy(),
                                  np.asarray(want_i))
    np.testing.assert_array_equal(out["Out"][0].numpy(), np.asarray(want_v))


def _beam_inputs(case, rng, B=3, K=4):
    """(pre_ids, pre_scores, ids, scores) of one step in ``case``."""
    probs = _tied_probs(rng, B, W, V)
    scores = -np.sort(-probs, axis=-1)[..., :K]
    ids = np.argsort(-probs, axis=-1, kind="stable")[..., :K] \
        .astype(np.int32)
    pre_ids = rng.randint(2, V, (B, W)).astype(np.int64)
    pre_scores = -rng.rand(B, W).astype(np.float32) * 3
    if case == "first_step":
        pre_ids[:] = 0
        pre_scores[:, 1:] = -1e9
    elif case == "finished":
        pre_ids[0, 1] = pre_ids[1, 0] = pre_ids[1, 2] = 1   # end_id
        pre_scores[1, 0] = pre_scores[1, 2]                 # a tied pair
        pre_ids[2, :] = 1                                   # all finished
    elif case == "accumulated":
        scores = pre_scores[..., None] + np.log(scores)
        scores[0, 1, 2] = scores[0, 2, 0]                   # a planted tie
    return pre_ids, pre_scores, ids, scores.astype(np.float32)


@pytest.mark.parametrize("case", ["plain", "first_step", "finished",
                                  "accumulated"])
def test_beam_search_matches_jax(case):
    rng = np.random.RandomState(len(case))
    pre_ids, pre_scores, ids, scores = _beam_inputs(case, rng)
    attrs = dict(beam_size=W, end_id=1,
                 is_accumulated=case == "accumulated")
    want = jax_beam_ops.beam_search(
        _Ctx(**attrs), *(jnp.asarray(a) for a in (pre_ids.astype(np.int32),
                                                   pre_scores, ids, scores)))
    out = _emit("beam_search", {
        "pre_ids": torch.from_numpy(pre_ids).to(torch.int32),
        "pre_scores": torch.from_numpy(pre_scores),
        "ids": torch.from_numpy(ids), "scores": torch.from_numpy(scores)},
        **attrs)
    got = [out[s][0] for s in ("selected_ids", "selected_scores",
                               "parent_idx")]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    if case == "finished":      # a finished beam keeps its frozen score
        assert (got[0][2] == 1).all()


def _trajectory(rng, T, B=2, Wb=3, end_at=()):
    """Decode-loop arrays [T, B, W]: step 0 the start tokens; ``end_at``
    (t, b, w) entries emit end_id 1."""
    ids = rng.randint(2, V, (T, B, Wb)).astype(np.int32)
    ids[0] = 0
    for t, b, w in end_at:
        ids[t, b, w] = 1
    parents = rng.randint(0, Wb, (T, B, Wb)).astype(np.int32)
    parents[0] = 0
    scores = -np.cumsum(rng.rand(T, B, Wb), axis=0).astype(np.float32)
    scores[-1, 0, :2] = scores[-1, 0, 2]            # tied final scores
    return ids, scores, parents


@pytest.mark.parametrize("T,end_at", [(2, ()), (6, ((2, 0, 1), (4, 1, 0))),
                                      (9, ((1, 0, 0), (1, 0, 2), (5, 1, 1),
                                           (8, 1, 2)))])
def test_beam_search_decode_matches_jax(T, end_at):
    rng = np.random.RandomState(T)
    arrs = _trajectory(rng, T, end_at=end_at)
    lens = np.ones(T, np.int32)
    want_ids, want_scores = jax_beam_ops.beam_search_decode(
        _Ctx(end_id=1), *(JSeqArray(jnp.asarray(a), jnp.asarray(lens))
                          for a in arrs))
    out = _emit("beam_search_decode", {
        s: SeqArray(torch.from_numpy(a), torch.from_numpy(lens))
        for s, a in zip(("Ids", "Scores", "Parents"), arrs)}, end_id=1)
    got = out["SentenceIds"][0]
    assert isinstance(got, NestedSeqArray)
    for f in ("data", "outer_lengths", "inner_lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want_ids, f)))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want_ids))
    np.testing.assert_allclose(out["SentenceScores"][0].numpy(),
                               np.asarray(want_scores), rtol=1e-6, atol=1e-6)


def _gather_program(fluid):
    """loss = mean(w * batch_gather(fc(x), idx)): the gradient of the fc
    weight flows back through batch_gather."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [W, 5], "float32")
        idx = fluid.layers.data("idx", [W], "int32")
        wt = fluid.layers.data("wt", [W, 6], "float32")
        h = fluid.layers.fc(x, 6, num_flatten_dims=2,
                            param_attr=fluid.ParamAttr(name="g.w"),
                            bias_attr=False)
        g = fluid.layers.batch_gather(h, idx)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(g, wt))
        fluid.append_backward(loss)
    return main, startup, g


def test_batch_gather_and_its_gradient_match_jax():
    rng = np.random.RandomState(5)
    feed = {"x": rng.randn(4, W, 5).astype(np.float32),
            "idx": rng.randint(0, W, (4, W)).astype(np.int32),
            "wt": rng.randn(4, W, 6).astype(np.float32)}
    feed["idx"][0] = [2, 2, 2]                     # one row gathered thrice
    jmain, jstart, jg = _gather_program(jfluid)
    tmain, _, tg = _gather_program(tfluid)
    assert jmain.desc.serialize_to_string() == \
        tmain.desc.serialize_to_string()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed, fetch_list=[jg, "g.w@GRAD"])
    tscope = tfluid.scope_from_numpy(
        {"g.w": np.asarray(jscope.find_var("g.w"))}, CPU)
    with tfluid.scope_guard(tscope):
        got = tfluid.Executor(CPU).run(tmain, feed=feed,
                                       fetch_list=[tg, "g.w@GRAD"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_page_copy_matches_jax_bit_for_bit(kv_dtype):
    rng = np.random.RandomState(3)
    shape = (NH, 8 * NL * 2, PS, DK)
    f = rng.randn(*shape).astype(np.float32)
    pool_np = {"float32": f,
               "bfloat16": np.asarray(jnp.asarray(f, jnp.bfloat16)),
               "int8": rng.randint(-127, 128, shape).astype(np.int8)}[
                   kv_dtype]
    src = np.array([3, 0, 5, 0], np.int32)         # lanes 1, 3: no copy
    dst = np.array([6, 0, 7, 0], np.int32)
    pool = torch.from_numpy(np.asarray(pool_np, np.float32)).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int8": torch.int8}[kv_dtype]) if kv_dtype != "int8" \
        else torch.from_numpy(pool_np.copy())
    before = pool.clone()
    if kv_dtype == "int8":
        scales_np = rng.rand(1, shape[1], PS).astype(np.float32)
        want, want_sc = jax_cache_ops.quantized_paged_page_copy(
            _Ctx(n_layer=NL), jnp.asarray(pool_np), jnp.asarray(scales_np),
            jnp.asarray(src), jnp.asarray(dst))
        scales = torch.from_numpy(scales_np.copy())
        out = _emit("quantized_paged_page_copy",
                    {"Pool": pool, "Scales": scales,
                     "Src": torch.from_numpy(src),
                     "Dst": torch.from_numpy(dst)}, n_layer=NL)
        assert out["ScalesOut"][0] is scales
        np.testing.assert_array_equal(scales.numpy(), np.asarray(want_sc))
    else:
        want = jax_cache_ops.paged_page_copy(
            _Ctx(n_layer=NL), jnp.asarray(pool_np), jnp.asarray(src),
            jnp.asarray(dst))
        out = _emit("paged_page_copy", {"Pool": pool,
                                        "Src": torch.from_numpy(src),
                                        "Dst": torch.from_numpy(dst)},
                    n_layer=NL)
    assert out["Out"][0] is pool                   # written in place
    np.testing.assert_array_equal(pool.to(torch.float32).numpy(),
                                  np.asarray(want).astype(np.float32))
    rows = 2 * NL
    assert torch.equal(pool[:, 6 * rows:7 * rows], before[:, 3 * rows:4 * rows])


# -- programs --------------------------------------------------------------

@pytest.fixture(scope="module")
def pairs():
    """kv_dtype -> (JAX generator, port generator) with equal weights."""
    made = {}
    src_scope = []

    def get(kv_dtype):
        if kv_dtype not in made:
            scope = jfluid.Scope()
            jg = JaxGenerator(V, V, scope=scope, kv_dtype=kv_dtype,
                              executor=jfluid.Executor(jfluid.CPUPlace()),
                              **KW)
            if src_scope:
                copy_weights(src_scope[0], scope, prefix="tf")
            else:
                jg.init_params(seed=7)
                src_scope.append(scope)
            tg = PagedTransformerGenerator(V, V, place=CPU,
                                           kv_dtype=kv_dtype, **KW)
            tg.load_params({n: np.asarray(scope.find_var(n))
                            for n in scope.vars
                            if scope.find_var(n) is not None})
            made[kv_dtype] = (jg, tg)
        return made[kv_dtype]

    return get


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("beam", [2, 3])
def test_beam_step_program_bytes_match_reference(pairs, kv_dtype, beam):
    jg, tg = pairs(kv_dtype)
    assert tg._build_beam_step(beam)[0].serialize_to_string() == \
        jg._build_beam_step(beam)[0].serialize_to_string()


def test_backtrace_program_bytes_match_reference(pairs):
    jg, tg = pairs("float32")
    jprog, tprog = jg._build_backtrace()[0], tg._build_backtrace()[0]
    assert tprog.serialize_to_string() == jprog.serialize_to_string()
    out = tprog.global_block().var(tg._decode_prog[1].name)
    assert out.lod_level == 2


# -- paths -----------------------------------------------------------------

def _sources(seed=2, n=2):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(2, V, rng.randint(3, SRC + 1)) for _ in range(n)]
    tok = np.zeros((n, SRC), np.int64)
    for i, s in enumerate(seqs):
        tok[i, :len(s)] = s
    return tok, np.asarray([len(s) for s in seqs], np.int32)


def _alloc_state(alloc):
    return (list(alloc._free), dict(alloc._ref),
            {h: list(e) for h, e in alloc._chunks.items()},
            list(alloc._evictable), alloc.stats())


def _assert_same_beam(a, b):
    """Two (ids, scores, trace) beam results: ids and parents equal at
    every step, scores close, the same backtrace."""
    (ai, as_, (ti, ts, tp)), (bi, bs, (ui, us, up)) = a, b
    assert len(ti) == len(ui)
    for t in range(len(ti)):
        np.testing.assert_array_equal(ti[t], ui[t])
        np.testing.assert_array_equal(tp[t], up[t])
        np.testing.assert_allclose(ts[t], us[t], **SCORE_TOL)
    for f in ("data", "outer_lengths", "inner_lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(ai, f)),
                                      np.asarray(getattr(bi, f)))
    np.testing.assert_allclose(as_, bs, **SCORE_TOL)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_paged_beam_matches_jax(pairs, kv_dtype):
    jg, tg = pairs(kv_dtype)
    tok, lens = _sources()
    cow = (jg.cache_stats()["pages"]["cow_copies"],
           tg.cache_stats()["pages"]["cow_copies"])
    want = jg.beam(tok, lens, beam_size=W, max_new=OUT, return_trace=True)
    got = tg.beam(tok, lens, beam_size=W, max_new=OUT, return_trace=True)
    assert isinstance(got[0], NestedSeqArray)
    _assert_same_beam(got, want)
    assert tg.cache_stats()["pages"]["cow_copies"] - cow[1] == \
        jg.cache_stats()["pages"]["cow_copies"] - cow[0] > 0
    assert tg.cache_stats()["pages"]["in_use"] == 0
    tg.alloc.check_invariants()
    assert _alloc_state(tg.alloc) == _alloc_state(jg.alloc)


def test_int8_beam_agrees_with_the_float32_pool(pairs):
    _, fp = pairs("float32")
    _, i8 = pairs("int8")
    tok, lens = _sources()
    f_ids, f_scores = fp.beam(tok, lens, beam_size=W, max_new=OUT)
    q_ids, q_scores = i8.beam(tok, lens, beam_size=W, max_new=OUT)
    assert (np.asarray(f_ids) == np.asarray(q_ids)).mean() >= 0.9
    np.testing.assert_allclose(q_scores, f_scores, rtol=0.05, atol=0.2)


def test_beam_error_mid_loop_releases_every_page(pairs, monkeypatch):
    _, tg = pairs("float32")
    tok, lens = _sources(seed=4)
    tg.beam(tok, lens, beam_size=W, max_new=OUT)        # the step exists
    prog = tg._beam_steps[W][0]
    run, calls = tg.exe.run, []

    def failing(program, *a, **kw):
        if program is prog:
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected")
        return run(program, *a, **kw)

    monkeypatch.setattr(tg.exe, "run", failing)
    with pytest.raises(RuntimeError, match="injected"):
        tg.beam(tok, lens, beam_size=W, max_new=OUT)
    assert tg.cache_stats()["pages"]["in_use"] == 0
    assert all(ln.phase == "idle" for ln in tg._lanes)
    tg.alloc.check_invariants()


def test_beam_step_is_cached_and_holds_the_scope_pool(pairs):
    _, tg = pairs("float32")
    tok, lens = _sources(seed=6)
    tg.beam(tok, lens, beam_size=W, max_new=OUT)
    misses = tg.cache_stats()["executable"]["misses"]
    hits = tg.cache_stats()["executable"]["hits"]
    _, _, (ids, _, _) = tg.beam(tok, lens, beam_size=W, max_new=OUT,
                                return_trace=True)
    st = tg.cache_stats()["executable"]
    assert st["misses"] == misses
    assert st["hits"] > hits + len(ids) - 2
    fp = tg._beam_steps[W][0].desc.fingerprint()
    beam_entries = [e for k, e in tg.exe._cache.items() if k[0] == fp]
    assert len(beam_entries) == 1
    pool = tg.scope.find_var(tg._pool_name)
    holders = [e for e in tg.exe._cache.values()
               if tg._pool_name in e.state]
    assert len(holders) >= 2                       # unified and beam steps
    assert all(e.state[tg._pool_name] is pool for e in holders)
