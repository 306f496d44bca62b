"""The port's dense decoders against the JAX package, on the CPU.

Ops, through the port's registry against the JAX emitters on the same
numpy inputs:

* ``cache_write``: one shared offset (clamped where the value would run
  past the cache, as ``lax.dynamic_update_slice`` clamps it) and one
  position a row; bit for bit, the cache written in place;
* ``decode_attention``: within 1e-5, rows past each lane's length
  masked;
* the unfused ``multi_head_attention`` (split heads, scale, matmul, the
  bias, softmax, matmul, merge) built in a program by both packages:
  the same bytes, the output within 1e-5 and every parameter's gradient
  within 1e-4 (through ``append_backward``), from the same weights.

Programs: the dense generator's prefill, step and beam-step programs
(W = 2, 3) and ``FullRerunDecoder``'s pruned program serialize to the
reference's bytes.

Paths (V=24, 2 layers, 2 heads, d_key 4, d_model 16; the port's scope
holds the JAX scope's weights): ``TransformerGenerator.greedy`` / ``.beam``
and ``FullRerunDecoder.greedy`` / ``.beam`` give the reference's tokens,
ids and parents at every step, scores within 1e-4; the port's own
dense-against-full-re-run parity and paged-against-dense parity (causal
encoder, shared pages, copy-on-write) hold as the reference's tests
hold them; the dense generator behind the port's
``ContinuousBatchingScheduler`` emits the reference scheduler's tokens;
a second request at the same batch reads its own caches, never the last
one's; without a card the decoders refuse to run unless given the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.ops import cache_ops as jax_cache_ops
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving import ContinuousBatchingScheduler as JaxScheduler
from paddle_tpu.serving import FullRerunDecoder as JaxFull
from paddle_tpu.serving import TransformerGenerator as JaxDense
from paddle_tpu.serving import decoder as jax_decoder
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core.desc import OpDesc
from paddle_tpu_torch.fluid.core.registry import EmitCtx, get_op_info
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      FullRerunDecoder,
                                      PagedTransformerGenerator,
                                      TransformerGenerator)
from paddle_tpu_torch.serving.decoder import pack_sources, trim_at_end

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT = 8, 10
KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
          d_inner_hid=DI, max_length=64, src_len=SRC, param_prefix="tfs")
CPU = tfluid.CPUPlace()
W = 3
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)


class _Ctx:
    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _emit(op_type, ins, **attrs):
    ctx = EmitCtx(OpDesc(op_type, attrs=attrs))
    return get_op_info(op_type).emit(
        ctx, {k: [v] for k, v in ins.items() if v is not None})


def _arrays(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.vars
            if scope.find_var(n) is not None}


# -- ops -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["shared", "clamped", "per_row"])
def test_cache_write_matches_jax_bit_for_bit(case):
    rng = np.random.RandomState(1)
    cache_np = rng.randn(3, 6, 2, 4).astype(np.float32)
    k = 2 if case == "clamped" else 1
    value = rng.randn(3, k, 2, 4).astype(np.float32)
    index = {"shared": np.array([2], np.int32),
             "clamped": np.array([5], np.int32),
             "per_row": np.array([0, 5, 3], np.int32)}[case]
    want = jax_cache_ops.cache_write(_Ctx(axis=1), jnp.asarray(cache_np),
                                     jnp.asarray(value), jnp.asarray(index))
    cache = torch.from_numpy(cache_np.copy())
    got, = _emit("cache_write", {"Cache": cache,
                                 "Value": torch.from_numpy(value),
                                 "Index": torch.from_numpy(index)},
                 axis=1)["Out"]
    assert got is cache                            # written in place
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))


def test_decode_attention_matches_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(3, 1, 2, 4).astype(np.float32)
    kc = rng.randn(3, 7, 2, 4).astype(np.float32)
    vc = rng.randn(3, 7, 2, 4).astype(np.float32)
    lengths = np.array([1, 7, 4], np.int32)
    want = jax_cache_ops.decode_attention(
        _Ctx(sm_scale=0.5), *(jnp.asarray(a) for a in (q, kc, vc, lengths)))
    got, = _emit("decode_attention", {
        "Q": torch.from_numpy(q), "KCache": torch.from_numpy(kc),
        "VCache": torch.from_numpy(vc),
        "Lengths": torch.from_numpy(lengths)}, sm_scale=0.5)["Out"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # lane 0 sees its first row only
    np.testing.assert_allclose(got[0, 0].numpy(), vc[0, 0], rtol=1e-6)


def _mha_program(fluid, T):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        q = fluid.layers.data("q", [5, DM], "float32")
        kv = fluid.layers.data("kv", [7, DM], "float32")
        bias = fluid.layers.data("bias", [NH, 5, 7], "float32")
        wt = fluid.layers.data("wt", [5, DM], "float32")
        out = T.multi_head_attention(q, kv, kv, bias, DK, DK, DM,
                                     n_head=NH, prefix="mha")
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(out, wt))
        fluid.append_backward(loss)
    return main, startup, out


def test_unfused_attention_and_its_gradients_match_jax():
    rng = np.random.RandomState(3)
    feed = {"q": rng.randn(2, 5, DM).astype(np.float32),
            "kv": rng.randn(2, 7, DM).astype(np.float32),
            "bias": JT.make_attn_bias(np.array([7, 4]), 7, NH)[:, :, :5],
            "wt": rng.randn(2, 5, DM).astype(np.float32)}
    jmain, jstart, jout = _mha_program(jfluid, JT)
    tmain, _, tout = _mha_program(tfluid, TT)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    ops = [op.type for op in tmain.global_block().ops]
    assert "fused_attention" not in ops and ops.count("matmul") == 2
    params = [p.name for p in tmain.global_block().all_parameters()]
    fetch = [jout.name] + [p + "@GRAD" for p in params]
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
    tscope = tfluid.scope_from_numpy(
        {p: np.asarray(jscope.find_var(p)) for p in params}, CPU)
    with tfluid.scope_guard(tscope):
        got = tfluid.Executor(CPU).run(tmain, feed=feed, fetch_list=fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


# -- programs and paths ------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """((JAX dense, JAX full), (port dense, port full)): the JAX pair
    shares one scope initialized from seed 7, the port pair a scope of
    its weights."""
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    jd = JaxDense(V, V, max_out_len=OUT, scope=scope, executor=exe, **KW)
    jf = JaxFull(V, V, trg_len=OUT, scope=scope, executor=exe, **KW)
    jf.init_params(seed=7)
    tscope = tfluid.scope_from_numpy(_arrays(scope), CPU)
    texe = tfluid.Executor(CPU)
    td = TransformerGenerator(V, V, max_out_len=OUT, scope=tscope,
                              executor=texe, **KW)
    tf_ = FullRerunDecoder(V, V, trg_len=OUT, scope=tscope, executor=texe,
                           **KW)
    return (jd, jf), (td, tf_)


def _sources(seed=0, n=4):
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(2, V, rng.randint(3, SRC + 1)) for _ in range(n)]
    return seqs, pack_sources(seqs, bucket=4)


@pytest.mark.parametrize("which", ["step", "prefill", "beam2", "beam3",
                                   "full"])
def test_dense_program_bytes_match_reference(pair, which):
    (jd, jf), (td, tf_) = pair
    get = {"step": lambda g: g._step[0],
           "prefill": lambda g: g._build_prefill(SRC)[0],
           "beam2": lambda g: g._build_beam_step(2)[0],
           "beam3": lambda g: g._build_beam_step(3)[0]}
    if which == "full":
        j, t = jf.program, tf_.program
    else:
        j, t = get[which](jd), get[which](td)
    assert t.serialize_to_string() == j.serialize_to_string()


@pytest.mark.parametrize("stop_at_end", [False, True])
def test_greedy_matches_jax(pair, stop_at_end):
    (jd, jf), (td, tf_) = pair
    _, (tok, lens) = _sources(0)
    want = jd.greedy(tok, lens, max_new=OUT, stop_at_end=stop_at_end)
    np.testing.assert_array_equal(
        td.greedy(tok, lens, max_new=OUT, stop_at_end=stop_at_end), want)
    np.testing.assert_array_equal(
        tf_.greedy(tok, lens, max_new=OUT, stop_at_end=stop_at_end),
        jf.greedy(tok, lens, max_new=OUT, stop_at_end=stop_at_end))
    assert trim_at_end(want, 1) == jax_decoder.trim_at_end(want, 1)
    seqs, packed = _sources(0)
    for got, ref in zip(packed, jax_decoder.pack_sources(seqs, bucket=4)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype


def _same_steps(a, b):
    (ai, as_, ap), (bi, bs, bp) = a, b
    assert len(ai) == len(bi)
    for t in range(len(ai)):
        np.testing.assert_array_equal(ai[t], bi[t])
        np.testing.assert_array_equal(ap[t], bp[t])
        np.testing.assert_allclose(as_[t], bs[t], **SCORE_TOL)


def test_dense_beam_matches_jax(pair):
    (jd, _), (td, _) = pair
    _, (tok, lens) = _sources(2)
    w_ids, w_scores, w_trace = jd.beam(tok, lens, beam_size=W, max_new=OUT,
                                       return_trace=True)
    g_ids, g_scores, g_trace = td.beam(tok, lens, beam_size=W, max_new=OUT,
                                       return_trace=True)
    _same_steps(g_trace, w_trace)
    for f in ("data", "outer_lengths", "inner_lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(g_ids, f)),
                                      np.asarray(getattr(w_ids, f)))
    np.testing.assert_allclose(g_scores, w_scores, **SCORE_TOL)


def test_full_rerun_beam_matches_jax_and_the_dense_beam(pair):
    """The full-re-run beam against the reference's, and the port's dense
    beam against the port's full re-run (the reference's
    ``test_beam_score_parity``)."""
    (_, jf), (td, tf_) = pair
    _, (tok, lens) = _sources(2)
    f_trace = tf_.beam(tok, lens, beam_size=W, max_new=OUT)
    _same_steps(f_trace, jf.beam(tok, lens, beam_size=W, max_new=OUT))
    g_ids, g_scores, g_trace = td.beam(tok, lens, beam_size=W, max_new=OUT,
                                       return_trace=True)
    _same_steps(g_trace, f_trace)
    f_best, f_final = td._backtrace(*f_trace)
    np.testing.assert_array_equal(np.asarray(g_ids), np.asarray(f_best))
    np.testing.assert_allclose(g_scores, f_final, **SCORE_TOL)
    assert (np.diff(g_scores, axis=1) <= 1e-6).all()   # best first


def test_dense_greedy_matches_full_rerun_and_replays(pair):
    """The reference's greedy parity (dense against full re-run), and a
    second decode at the same batch adds no executable miss."""
    _, (td, tf_) = pair
    _, (tok, lens) = _sources(5)
    g = td.greedy(tok, lens, max_new=OUT, stop_at_end=False)
    np.testing.assert_array_equal(
        g, tf_.greedy(tok, lens, max_new=OUT, stop_at_end=False))
    misses = td.cache_stats()["executable"]["misses"]
    np.testing.assert_array_equal(
        td.greedy(tok, lens, max_new=OUT, stop_at_end=False), g)
    assert td.cache_stats()["executable"]["misses"] == misses


def test_replaced_caches_are_never_read_stale(pair):
    """Each decode puts fresh caches in the scope; the executor's cached
    step copies them into its buffers: request B after request A at the
    same batch decodes as B does on a fresh generator."""
    _, (td, _) = pair
    _, (tok_a, lens_a) = _sources(7)
    _, (tok_b, lens_b) = _sources(8)
    b_alone = TransformerGenerator(V, V, max_out_len=OUT, scope=td.scope,
                                   executor=tfluid.Executor(CPU), **KW)
    want = b_alone.greedy(tok_b, lens_b, max_new=OUT, stop_at_end=False)
    td.greedy(tok_a, lens_a, max_new=OUT, stop_at_end=False)
    np.testing.assert_array_equal(
        td.greedy(tok_b, lens_b, max_new=OUT, stop_at_end=False), want)
    fp = td._step[0].desc.fingerprint()
    entry = [e for k, e in td.exe._cache.items() if k[0] == fp
             and dict(k[2])["trg_word"][0] == len(tok_b)][0]
    for name in entry.state:
        if "@kcache" in name:
            assert td.scope.find_var(name) is entry.state[name]


def test_scheduler_over_the_dense_generator_matches_jax(pair):
    (jd, _), (td, _) = pair
    seqs, _ = _sources(9, n=5)

    def serve(sched_cls, gen):
        sched = sched_cls(gen, n_slots=2, max_new_tokens=6)
        reqs = [sched.submit(s, max_new_tokens=6) for s in seqs]
        while any(not r.done for r in reqs):
            sched.step_once()
        return [list(r.tokens) for r in reqs]

    want = serve(JaxScheduler, jd)
    assert serve(ContinuousBatchingScheduler, td) == want
    assert all(len(t) >= 1 for t in want)


def test_paged_beam_matches_the_dense_beam():
    """The port's own paged beam (shared pages, copy-on-write) against
    its dense beam with the causal encoder (the reference's
    ``test_beam_parity_with_shared_pages``), and paged greedy against
    dense greedy."""
    pkw = dict(KW, src_len=12, max_out_len=OUT, param_prefix="tf")
    paged = PagedTransformerGenerator(V, V, place=CPU, page_size=4,
                                      chunk_size=4, num_pages=64, **pkw)
    paged.init_params(seed=3)
    dense = TransformerGenerator(V, V, scope=paged.scope,
                                 executor=tfluid.Executor(CPU),
                                 causal_encoder=True, src_bucket=4, **pkw)
    rng = np.random.RandomState(2)
    seqs = [rng.randint(2, V, rng.randint(3, 13)) for _ in range(2)]
    tok, lens = pack_sources(seqs, bucket=4)
    np.testing.assert_array_equal(
        paged.greedy(tok, lens, max_new=OUT, stop_at_end=False),
        dense.greedy(tok, lens, max_new=OUT, stop_at_end=False))
    cow0 = paged.cache_stats()["pages"]["cow_copies"]
    p_ids, p_scores, p_trace = paged.beam(tok, lens, beam_size=W,
                                          max_new=OUT, return_trace=True)
    d_ids, d_scores, d_trace = dense.beam(tok, lens, beam_size=W,
                                          max_new=OUT, return_trace=True)
    _same_steps(p_trace, d_trace)
    np.testing.assert_array_equal(np.asarray(p_ids), np.asarray(d_ids))
    np.testing.assert_allclose(p_scores, d_scores, **SCORE_TOL)
    assert paged.cache_stats()["pages"]["cow_copies"] > cow0
    assert paged.cache_stats()["pages"]["in_use"] == 0
    paged.alloc.check_invariants()


def test_decoders_run_on_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, kw in ((TransformerGenerator, dict(max_out_len=4)),
                    (FullRerunDecoder, dict(trg_len=4))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(V, V, **KW, **kw)
        assert cls(V, V, place=CPU, **KW, **kw).exe.device == \
            torch.device("cpu")
    assert jax.default_backend() == "cpu"
