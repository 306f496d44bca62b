"""The book's machine-translation chapter in the port
(``models/machine_translation.py``, ``models/rnn_encoder_decoder.py``)
against the JAX package on the CPU.

* ``train_model``, ``attention_train_model`` and ``seq_to_seq_net``
  serialize to the reference's bytes before and after
  ``Adam.minimize``, with their startup programs; 4 Adam steps from the
  reference's initialized scope (copied as numpy) on the same seeded
  batches give its losses within LOSS_RTOL and its parameters and
  moments within PARAM_ATOL (float32 on both sides, summation order
  only).
* ``decode_model`` and ``attention_decode_model`` (beam 2, max_length
  6), each built after its training model so they share its weights by
  name, pruned to their outputs with ``io.prune_program``: the pruned
  programs serialize to the reference's bytes, and on the same weights
  the decoded ids and their backtrace (the nested lengths) are the
  reference's token for token, the beam scores within SCORE_TOL.
"""

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core.lod import make_seq as jmake_seq
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import rnn_encoder_decoder as jred
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import rnn_encoder_decoder as tred

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
DICT, WORD, HIDDEN = 14, 8, 16
START, END = 0, 1
PACKAGES = {"jax": (jfluid, jmt, jred), "port": (tfluid, tmt, tred)}


def _data(fluid):
    return [fluid.layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
            for n in ("src", "trg", "nxt")]


def _train(model):
    def build(fluid, mt, red):
        src, trg, nxt = _data(fluid)
        if model == "seq_to_seq_net":
            return red.seq_to_seq_net(src, trg, nxt, DICT, DICT,
                                      embedding_dim=WORD,
                                      encoder_size=HIDDEN,
                                      decoder_size=HIDDEN)[0]
        return getattr(mt, model)(src, trg, nxt, DICT, word_dim=WORD,
                                  hidden_dim=HIDDEN)[0]
    return build


TRAIN = {m: _train(m) for m in ("train_model", "attention_train_model",
                                "seq_to_seq_net")}


def build_train(pkg, model):
    """-> (main before minimize as bytes, main, startup, loss)."""
    fluid, mt, red = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = TRAIN[model](fluid, mt, red)
        before = main.serialize_to_string()
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return before, main, startup, loss


def batch(make_seq, i, n=4):
    """Seeded reversal pairs of 3-6 tokens (ids 2..DICT-1)."""
    rng = np.random.RandomState(100 + i)
    srcs = [rng.randint(2, DICT, rng.randint(3, 7)) for _ in range(n)]
    return {"src": make_seq(srcs, dtype=np.int64),
            "trg": make_seq([np.concatenate([[START], s[::-1]])
                             for s in srcs], dtype=np.int64),
            "nxt": make_seq([np.concatenate([s[::-1], [END]])
                             for s in srcs], dtype=np.int64)}


def initial_scope(fluid, startup):
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
    return scope, exe


def _arrays(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.vars
            if scope.find_var(n) is not None}


@pytest.mark.parametrize("model", sorted(TRAIN))
def test_train_program_bytes_match_reference(model):
    jb, jm, js, _ = build_train("jax", model)
    tb, tm, ts, _ = build_train("port", model)
    assert tb == jb
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    ops = [op.type for op in tm.global_block().ops]
    assert ("dynamic_recurrent" in ops and "dynamic_recurrent_grad" in ops
            and len(tm.blocks) == 2)


@pytest.mark.parametrize("model", sorted(TRAIN))
def test_model_trains_as_the_reference(model):
    steps = 4
    _, jm, js, jloss = build_train("jax", model)
    scope, exe = initial_scope(jfluid, js)
    init = _arrays(scope)
    with jfluid.scope_guard(scope):
        want = [float(np.asarray(exe.run(
            jm, feed=batch(jmake_seq, i), fetch_list=[jloss])[0]))
            for i in range(steps)]
        after = _arrays(scope)
    _, tm, _, tloss = build_train("port", model)
    cpu = tfluid.CPUPlace()
    tscope, texe = tfluid.scope_from_numpy(init, cpu), tfluid.Executor(cpu)
    got = [float(texe.run(tm, feed=batch(tfluid.make_seq, i),
                          fetch_list=[tloss], scope=tscope)[0])
           for i in range(steps)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    state = tfluid.scope_to_numpy(tscope, list(init))
    for n in init:
        np.testing.assert_allclose(state[n], after[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


DECODE = {"decode_model": "train_model",
          "attention_decode_model": "attention_train_model"}


def build_decode(pkg, model):
    """The training model, then its decoder over the same weights, and
    the decoder pruned to its outputs."""
    fluid, mt, _ = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src, trg, nxt = _data(fluid)
        getattr(mt, DECODE[model])(src, trg, nxt, DICT, word_dim=WORD,
                                   hidden_dim=HIDDEN)
        ids, scores = getattr(mt, model)(
            src, DICT, word_dim=WORD, hidden_dim=HIDDEN, beam_size=2,
            topk_size=5, max_length=6, start_id=START, end_id=END)
    return fluid.io.prune_program(main, [ids, scores]), startup, ids, scores


@pytest.mark.parametrize("model", sorted(DECODE))
def test_decode_matches_reference_token_for_token(model):
    jp, js, jids, jsc = build_decode("jax", model)
    tp, ts, tids, tsc = build_decode("port", model)
    assert tp.serialize_to_string() == jp.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert "while" in [op.type for op in tp.global_block().ops]
    scope, exe = initial_scope(jfluid, js)
    init = _arrays(scope)
    src = {"src": batch(jmake_seq, 9, n=5)["src"]}
    with jfluid.scope_guard(scope):
        want_ids, want_sc = exe.run(jp, feed=src, fetch_list=[jids, jsc],
                                    mode="infer", return_numpy=False)
    cpu = tfluid.CPUPlace()
    tscope, texe = tfluid.scope_from_numpy(init, cpu), tfluid.Executor(cpu)
    for _ in range(2):                   # a miss, then a hit
        got_ids, got_sc = texe.run(
            tp, feed={"src": batch(tfluid.make_seq, 9, n=5)["src"]},
            fetch_list=[tids, tsc], scope=tscope, mode="infer")
        for f in ("data", "outer_lengths", "inner_lengths"):
            np.testing.assert_array_equal(np.asarray(getattr(got_ids, f)),
                                          np.asarray(getattr(want_ids, f)),
                                          err_msg=f)
        assert np.asarray(got_ids.data).shape == (5, 2, 6)
        np.testing.assert_allclose(got_sc, np.asarray(want_sc), **SCORE_TOL)
    assert texe.cache_stats()["executable"] == {
        "hits": 1, "misses": 1, "evictions": 0, "size": 1}
