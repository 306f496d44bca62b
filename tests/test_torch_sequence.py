"""Sequence inputs and the LSTM text classifiers through the port's Fluid
front end and Executor, against the JAX package, on the CPU.

* ``make_seq`` and ``seq_mask`` give the reference's arrays bit for bit.
* The ops the two programs run, on the same numpy inputs through both
  packages' emitters: every ``sequence_pool`` type (outputs, and the
  gradient of Out through ``jax.vjp`` against autograd), ``lookup_table``
  and its grad on SeqArray ids, ``softmax``, ``cross_entropy``, ``mean``,
  ``top_k`` and ``accuracy``.  float32 on both sides, summation order
  only: 1e-6 on outputs of magnitude ~1; index outputs exactly.
* The RNN benchmark model (``bench.py``'s ``bench_lstm``, built step for
  step at vocab 50, emb 8, hidden 8) and the book's ``stacked_lstm_net``
  (``tests/test_book.py``'s dims) serialize to the same bytes in both
  packages, before and after ``Adam.minimize``.
* 3 Adam steps of each program from the JAX scope (copied with
  ``scope_from_numpy``) on 3 ragged batches: losses within 1e-5
  relative, every parameter within 1e-5 absolute.  float32 on both
  sides; Adam moves an element by at most lr = 2e-3 a step, so 1e-5 is
  far below a step and far above the summation-order noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import lod as jlod
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.models import sentiment as JS
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.models import sentiment as TS

OUT_TOL = dict(rtol=0, atol=1e-6)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
LENGTHS = np.array([5, 0, 3, 1, 6], np.int32)


def _seqs(rng, lengths, feat=(), dtype=np.float32, high=None):
    if high is not None:
        return [rng.randint(0, high, (n,) + feat) for n in lengths]
    return [rng.randn(n, *feat).astype(dtype) for n in lengths]


@pytest.mark.parametrize("kw", [{}, dict(bucket=4), dict(max_len=9)],
                         ids=["tight", "bucket4", "max_len9"])
def test_make_seq_and_seq_mask_match_reference(kw):
    rng = np.random.RandomState(0)
    for feat in ((), (3,)):
        seqs = _seqs(rng, LENGTHS, feat)
        want = jlod.make_seq(seqs, **kw)
        got = tlod.make_seq(seqs, **kw)
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert got.lengths.dtype == np.int32
    ids = tlod.make_seq(_seqs(rng, LENGTHS, (1,), high=50), dtype=np.int32)
    assert ids.data.dtype == np.int32 and ids.data.shape == (5, 6, 1)
    for max_len in (6, 8):
        want = np.asarray(jlod.seq_mask(jnp.asarray(LENGTHS), max_len))
        got = tlod.seq_mask(torch.tensor(LENGTHS), max_len)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def _emit(pkg, op_type, ins, attrs):
    """Run one package's emitter: ``pkg`` is "jax" or "port", ``ins``
    maps slot -> list of values built for that package."""
    reg, desc_cls = (jreg, JOpDesc) if pkg == "jax" else (treg, TOpDesc)
    desc = desc_cls(op_type, {s: [f"{s}{i}" for i in range(len(v))]
                              for s, v in ins.items()}, {}, attrs)
    return reg.get_op_info(op_type).emit(reg.EmitCtx(desc), ins)


def _seq_pair(data, lengths=LENGTHS):
    return (jlod.SeqArray(jnp.asarray(data), jnp.asarray(lengths)),
            tlod.SeqArray(torch.tensor(data), torch.tensor(lengths)))


@pytest.mark.parametrize("pooltype",
                         ["sum", "average", "sqrt", "max", "last", "first"])
def test_sequence_pool_matches_reference(pooltype):
    rng = np.random.RandomState(1)
    data = rng.randn(5, 6, 3).astype(np.float32)
    attrs = {"pooltype": pooltype}
    w = rng.randn(5, 3).astype(np.float32)

    def jf(d):
        x = jlod.SeqArray(d, jnp.asarray(LENGTHS))
        out = _emit("jax", "sequence_pool", {"X": [x]}, attrs)
        return out["Out"][0], out["MaxIndex"][0]

    want, want_idx = jf(jnp.asarray(data))
    _, vjp = jax.vjp(lambda d: jf(d)[0], jnp.asarray(data))
    want_grad, = vjp(jnp.asarray(w))
    leaf = torch.tensor(data, requires_grad=True)
    out = _emit("port", "sequence_pool",
                {"X": [tlod.SeqArray(leaf, torch.tensor(LENGTHS))]}, attrs)
    got, got_idx = out["Out"][0], out["MaxIndex"][0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **OUT_TOL)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_idx.dtype == torch.int32
    got_grad, = torch.autograd.grad(got, leaf, torch.tensor(w))
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               **OUT_TOL)


def test_lookup_table_and_its_grad_on_sequence_ids():
    rng = np.random.RandomState(2)
    table = rng.randn(20, 4).astype(np.float32)
    ids = rng.randint(0, 20, (5, 6, 1)).astype(np.int32)
    og = rng.randn(5, 6, 4).astype(np.float32)
    j_ids, t_ids = _seq_pair(ids)
    want = _emit("jax", "lookup_table",
                 {"W": [jnp.asarray(table)], "Ids": [j_ids]}, {})["Out"][0]
    got = _emit("port", "lookup_table",
                {"W": [torch.tensor(table)], "Ids": [t_ids]}, {})["Out"][0]
    assert isinstance(got, tlod.SeqArray)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.lengths.numpy(), LENGTHS)
    j_og, t_og = _seq_pair(og)
    want = _emit("jax", "lookup_table_grad",
                 {"W": [jnp.asarray(table)], "Ids": [j_ids],
                  "Out@GRAD": [j_og]}, {})["W@GRAD"][0]
    got = _emit("port", "lookup_table_grad",
                {"W": [torch.tensor(table)], "Ids": [t_ids],
                 "Out@GRAD": [t_og]}, {})["W@GRAD"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_softmax_cross_entropy_and_mean_match_reference():
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 6, 4).astype(np.float32)
    j_x, t_x = _seq_pair(logits)
    want = _emit("jax", "softmax", {"X": [j_x]}, {})["Out"][0]
    got = _emit("port", "softmax", {"X": [t_x]}, {})["Out"][0]
    assert isinstance(got, tlod.SeqArray)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               **OUT_TOL)
    prob = np.array(jax.nn.softmax(jnp.asarray(logits[:, 0]), -1))
    label = rng.randint(0, 4, (5, 1))
    prob[0, label[0, 0]] = 0.0                   # hits the 1e-8 clip
    want = _emit("jax", "cross_entropy", {"X": [jnp.asarray(prob)],
                                          "Label": [jnp.asarray(label)]},
                 {})["Out"][0]
    got = _emit("port", "cross_entropy", {"X": [torch.tensor(prob)],
                                          "Label": [torch.tensor(label)]},
                {})["Out"][0]
    assert tuple(got.shape) == (5, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    want = _emit("jax", "mean", {"X": [jnp.asarray(logits)]}, {})["Out"][0]
    got = _emit("port", "mean", {"X": [torch.tensor(logits)]}, {})["Out"][0]
    assert got.dim() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_top_k_and_accuracy_match_reference(k):
    rng = np.random.RandomState(4)
    x = rng.randn(7, 5).astype(np.float32)
    label = rng.randint(0, 5, (7, 1))
    want = _emit("jax", "top_k", {"X": [jnp.asarray(x)]}, {"k": k})
    got = _emit("port", "top_k", {"X": [torch.tensor(x)]}, {"k": k})
    np.testing.assert_array_equal(got["Out"][0].numpy(),
                                  np.asarray(want["Out"][0]))
    np.testing.assert_array_equal(got["Indices"][0].numpy(),
                                  np.asarray(want["Indices"][0]))
    assert got["Indices"][0].dtype == torch.int32
    j_acc = _emit("jax", "accuracy", {"Out": want["Out"],
                                      "Indices": want["Indices"],
                                      "Label": [jnp.asarray(label)]}, {})
    t_acc = _emit("port", "accuracy", {"Out": got["Out"],
                                       "Indices": got["Indices"],
                                       "Label": [torch.tensor(label)]}, {})
    for slot in ("Accuracy", "Correct", "Total"):
        np.testing.assert_array_equal(t_acc[slot][0].numpy(),
                                      np.asarray(j_acc[slot][0]))
        assert t_acc[slot][0].dim() == 0
    assert t_acc["Correct"][0].dtype == torch.int32


# -- the two programs ---------------------------------------------------------

BENCH = dict(vocab=50, emb=8, hidden=8, lstm_num=2)
BOOK = dict(input_dim=30, class_dim=2, emb_dim=8, hid_dim=8, stacked_num=3)


def build_bench(fluid, minimize=True):
    """bench.py's bench_lstm model (benchmark/paddle/rnn/rnn.py), step for
    step."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        net = fluid.layers.embedding(input=words,
                                     size=[BENCH["vocab"], BENCH["emb"]])
        for _ in range(BENCH["lstm_num"]):
            proj = fluid.layers.fc(input=net, size=BENCH["hidden"] * 4)
            net, _ = fluid.layers.dynamic_lstm(input=proj,
                                               size=BENCH["hidden"] * 4)
        last = fluid.layers.sequence_last_step(input=net)
        pred = fluid.layers.fc(input=last, size=2, act="softmax")
        cost = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        if minimize:
            fluid.optimizer.Adam(learning_rate=2e-3).minimize(cost)
    return main, startup, [cost]


def build_book(fluid, sentiment, minimize=True):
    """The book's stacked_lstm_net at tests/test_book.py's dims."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, acc, _ = sentiment.stacked_lstm_net(data, label, **BOOK)
        if minimize:
            fluid.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
    return main, startup, [avg_cost, acc]


# name -> (builder of (fluid, sentiment module, minimize), vocabulary)
PROGRAMS = {
    "bench_lstm": (lambda fluid, _s, minimize: build_bench(fluid, minimize),
                   BENCH["vocab"]),
    "stacked_lstm_net": (build_book, BOOK["input_dim"]),
}


@pytest.mark.parametrize("minimize", [False, True])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_program_bytes_match_reference(name, minimize):
    build, _ = PROGRAMS[name]
    jm, js, _ = build(jfluid, JS, minimize)
    tm, ts, _ = build(tfluid, TS, minimize)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm.desc.fingerprint() == jm.desc.fingerprint()
    # shape inference recorded the sequence level of every LSTM output
    lstm_outs = [op.output("Hidden")[0] for op in tm.global_block().ops
                 if op.type == "dynamic_lstm"]
    assert lstm_outs and all(tm.global_block().var(n).lod_level == 1
                             for n in lstm_outs)


def batches(make_seq, vocab, n=3, batch=6):
    """n ragged batches of word ids, padded to 10 steps, from one seed."""
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        lengths = rng.randint(1, 11, batch)
        seqs = [rng.randint(0, vocab, (m, 1)) for m in lengths]
        out.append({"words": make_seq(seqs, dtype=np.int32, max_len=10),
                    "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)})
    return out


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_three_adam_steps_match_reference(name):
    build, vocab = PROGRAMS[name]
    main, startup, fetch = build(jfluid, JS, True)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = [[float(np.asarray(v)) for v in
                 exe.run(main, feed=f, fetch_list=fetch)]
                for f in batches(jlod.make_seq, vocab)]
        after = {n: np.asarray(scope.find_var(n)) for n in init}

    main, _, fetch = build(tfluid, TS, True)
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    got = [[float(v) for v in texe.run(main, feed=f, fetch_list=fetch,
                                       scope=tscope)]
           for f in batches(tfluid.make_seq, vocab)]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=LOSS_RTOL)
    # accuracy (stacked_lstm_net) is a count over the batch: exact
    np.testing.assert_array_equal([g[1:] for g in got],
                                  [w[1:] for w in want])
    got_params = tfluid.scope_to_numpy(tscope, list(init))
    moved = 0
    for n in init:
        np.testing.assert_allclose(got_params[n], after[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        moved += not np.array_equal(after[n], init[n])
    assert moved >= 10


def test_sequence_fetch_comes_back_as_numpy():
    """A fetched sequence var is a SeqArray of numpy data and lengths."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        words = tfluid.layers.data(name="words", shape=[1], dtype="int64",
                                   lod_level=1)
        emb = tfluid.layers.embedding(input=words, size=[10, 3])
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"words": tfluid.make_seq([[[1], [2]], [[3]]], dtype=np.int64)}
    out, = exe.run(main, feed=feed, fetch_list=[emb], scope=scope)
    assert isinstance(out, tfluid.SeqArray)
    assert isinstance(out.data, np.ndarray) and out.data.shape == (2, 2, 3)
    np.testing.assert_array_equal(out.lengths, [2, 1])
    assert out.lengths.dtype == np.int32
