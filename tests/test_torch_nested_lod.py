"""Level-2 sequences and the level-2 sequence slice of the port against the
JAX package, on the CPU.

* ``make_nested_seq`` gives the reference's arrays bit for bit (buckets,
  feature dims, an empty row, an empty first sub-sequence), and
  ``outer_mask``, ``inner_mask`` and ``flatten_outer`` its masks and
  lengths.
* Every op of the slice on the same seeded numpy inputs through both
  packages' emitters, with a zero-length row (or sub-sequence) in each:
  ``sequence_context``, ``nested_sequence_pool`` (sum, average, max over
  tied maxima), ``sequence_expand`` over a level-2 Y, ``sequence_concat``
  (time and feature), ``sequence_reshape`` (both ways),
  ``sequence_slice``, ``sequence_erase``, ``sequence_mask_op``,
  ``kmax_seq_score`` (level 1 with ties and a beam wider than the
  sequence, level 2 with a vacant outer slot), ``sub_nested_seq`` (a
  repeated pick and a -1 before a valid one) and ``lookup_table`` on
  level-2 ids (dense and sparse gradients).  Outputs within 1e-6 and
  gradients (``jax.vjp`` against autograd, one seeded cotangent) within
  1e-5: float32 on both sides, summation order only; lengths, indices
  and integer outputs exactly.
* Programs built in both packages and run from one scope: the
  reference's ``tests/test_nested_lod.py`` (nested ``sequence_expand``,
  paragraph pooling trained 30 Adam steps, ``flatten_outer``) and
  ``tests/test_ops_r5.py`` (``kmax_seq_score``, ``sub_nested_seq`` with
  its -1 and its scatter gradient, the ``DynamicRNN`` over sub-sequences,
  sequence-valued step outputs, the v2 pipeline's program built through
  ``fluid.layers``); losses within 1e-5 relative a step (30 Adam steps:
  1e-4), parameters within 1e-5.
* The hierarchical LSTM classifier (paragraphs of sentences of words: a
  ``DynamicRNN`` whose step runs ``dynamic_lstm`` over one sentence)
  serializes to the same bytes in both packages and trains 3 Adam steps
  from the reference's scope to its losses and parameters; a nested feed
  of one padded shape hits the executor's cache after its first step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import lod as jlod
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.selected_rows import SelectedRows as JRows
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.core.selected_rows import SelectedRows as TRows

OUT_TOL = dict(rtol=0, atol=1e-6)
GRAD_TOL = dict(rtol=0, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5

LENGTHS = np.array([5, 0, 3, 1, 6], np.int32)
OUTER = np.array([3, 0, 2], np.int32)
INNER = np.array([[4, 1, 2], [0, 0, 0], [3, 0, 0]], np.int32)


# -- host packing ------------------------------------------------------------

NESTED_CASES = {
    "words": [[[1, 2, 3], [4]], [[5, 6]], []],
    "features": [[np.ones((2, 3)), np.zeros((1, 3))], [np.ones((4, 3))]],
    "empty_first": [[[], [1.0, 2.0]], [[3.0]]],
}


@pytest.mark.parametrize("kw", [{}, dict(outer_bucket=4),
                                dict(inner_bucket=3),
                                dict(outer_bucket=2, inner_bucket=8)],
                         ids=["tight", "outer4", "inner3", "both"])
@pytest.mark.parametrize("case", list(NESTED_CASES))
def test_make_nested_seq_matches_reference(case, kw):
    nested = NESTED_CASES[case]
    for dtype in (None, np.float32, np.int64):
        want = jlod.make_nested_seq(nested, dtype=dtype, **kw)
        got = tlod.make_nested_seq(nested, dtype=dtype, **kw)
        assert isinstance(got, tlod.NestedSeqArray)
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.data, want.data)
        for a, b in ((got.outer_lengths, want.outer_lengths),
                     (got.inner_lengths, want.inner_lengths)):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_masks_and_flatten_outer_match_reference():
    want = jlod.make_nested_seq([[[1, 2], [3]], [[4, 5, 6]]],
                                dtype=np.float32)
    got = tlod.make_nested_seq([[[1, 2], [3]], [[4, 5, 6]]],
                               dtype=np.float32)
    jn = jlod.NestedSeqArray(jnp.asarray(want.data),
                             jnp.asarray(want.outer_lengths),
                             jnp.asarray(want.inner_lengths))
    tn = tlod.NestedSeqArray(torch.tensor(got.data),
                             torch.tensor(got.outer_lengths),
                             torch.tensor(got.inner_lengths))
    np.testing.assert_array_equal(tn.outer_mask().numpy(),
                                  np.asarray(jn.outer_mask()))
    np.testing.assert_array_equal(tn.inner_mask().numpy(),
                                  np.asarray(jn.inner_mask()))
    flat, jflat = tn.flatten_outer(), jn.flatten_outer()
    assert isinstance(flat, tlod.SeqArray)
    assert flat.data.shape[0] == 4          # batch 2 x max_outer 2
    np.testing.assert_array_equal(flat.lengths.numpy(), [2, 1, 3, 0])
    np.testing.assert_array_equal(flat.lengths.numpy(),
                                  np.asarray(jflat.lengths))
    np.testing.assert_array_equal(flat.data.numpy(), np.asarray(jflat.data))


# -- the ops, emitter against emitter -----------------------------------------

def _mods(pkg):
    return (jlod, jnp.asarray) if pkg == "jax" else (tlod, torch.as_tensor)


def _seq(pkg, data, lengths=LENGTHS):
    lod, arr = _mods(pkg)
    return lod.SeqArray(arr(data), arr(lengths))


def _nested(pkg, data, outer=OUTER, inner=INNER):
    lod, arr = _mods(pkg)
    return lod.NestedSeqArray(arr(data), arr(outer), arr(inner))


def _flat(v):
    """An op output as a list of arrays: data first, then its lengths."""
    if isinstance(v, (jlod.NestedSeqArray, tlod.NestedSeqArray)):
        return [v.data, v.outer_lengths, v.inner_lengths]
    if isinstance(v, (jlod.SeqArray, tlod.SeqArray)):
        return [v.data, v.lengths]
    if isinstance(v, (JRows, TRows)):
        return [v.rows, v.values]
    return [v]


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a)


def compare_op(op_type, make_ins, arrays, attrs=None, wrt=(),
               out_slots=("Out",)):
    """Run ``op_type``'s emitter in both packages on ``arrays`` (name ->
    numpy array; ``make_ins(pkg, values)`` builds the input slots) and
    hold the outputs, and the gradients of the ``wrt`` arrays (through
    one seeded cotangent on each float output), to each other."""
    attrs = attrs or {}
    names = {s: [s] for s in ("X", "Y", "W", "Ids", "Offset", "Length",
                              "Selection")}
    jinfo, tinfo = jreg.get_op_info(op_type), treg.get_op_info(op_type)
    jctx = jreg.EmitCtx(JOpDesc(op_type, names, {s: [s] for s in out_slots},
                                attrs))
    tctx = treg.EmitCtx(TOpDesc(op_type, names, {s: [s] for s in out_slots},
                                attrs))

    def jouts(*vals):
        v = {n: jnp.asarray(a) for n, a in arrays.items()}
        v.update(zip(wrt, vals))
        out = jinfo.emit(jctx, make_ins("jax", v))
        return [a for s in out_slots for o in out[s] for a in _flat(o)]

    want = jouts(*[jnp.asarray(arrays[n]) for n in wrt])
    leaves = {n: torch.tensor(arrays[n], requires_grad=True) for n in wrt}
    vals = {n: leaves.get(n, torch.as_tensor(a)) for n, a in arrays.items()}
    out = tinfo.emit(tctx, make_ins("port", vals))
    got = [a for s in out_slots for o in out[s] for a in _flat(o)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, **OUT_TOL)
        else:
            np.testing.assert_array_equal(g, w)
    if not wrt:
        return got
    rng = np.random.RandomState(9)
    floats = [i for i, w in enumerate(want)
              if jnp.issubdtype(w.dtype, jnp.floating)]
    cts = [rng.randn(*want[i].shape).astype(np.float32) for i in floats]

    def jfloat(*vals):
        outs = jouts(*vals)
        return [outs[i] for i in floats]

    _, vjp = jax.vjp(jfloat, *[jnp.asarray(arrays[n]) for n in wrt])
    want_g = vjp([jnp.asarray(c) for c in cts])
    ys = [got[i] for i in floats]
    got_g = torch.autograd.grad(ys, list(leaves.values()),
                                [torch.tensor(c) for c in cts],
                                allow_unused=True)
    for n, g, w in zip(wrt, got_g, want_g):
        g = np.zeros(arrays[n].shape, np.float32) if g is None else _np(g)
        np.testing.assert_allclose(g, np.asarray(w), err_msg=n, **GRAD_TOL)
    return got


def _data(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("length,start", [(3, None), (4, -2), (2, 0)])
def test_sequence_context(length, start):
    attrs = {"context_length": length}
    if start is not None:
        attrs["context_start"] = start
    compare_op("sequence_context",
               lambda pkg, v: {"X": [_seq(pkg, v["x"])]},
               {"x": _data((5, 6, 3))}, attrs, wrt=["x"])


@pytest.mark.parametrize("pool", ["sum", "average", "max"])
def test_nested_sequence_pool(pool):
    x = _data((3, 3, 4, 2), 1)
    x[0, 0, 1] = x[0, 0, 0]                       # tied maxima
    got = compare_op("nested_sequence_pool",
                     lambda pkg, v: {"X": [_nested(pkg, v["x"])]},
                     {"x": x}, {"pool_type": pool}, wrt=["x"])
    np.testing.assert_array_equal(got[1].numpy(), OUTER)


def test_sequence_expand_over_a_nested_y():
    compare_op("sequence_expand",
               lambda pkg, v: {"X": [_seq(pkg, v["x"], OUTER)],
                               "Y": [_nested(pkg, v["y"])]},
               {"x": _data((3, 3, 2), 2), "y": _data((3, 3, 4, 1), 3)},
               wrt=["x"])


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_concat(axis):
    other = np.array([2, 4, 0, 3, 1], np.int32)
    t2 = 4 if axis == 0 else 6
    compare_op("sequence_concat",
               lambda pkg, v: {"X": [_seq(pkg, v["a"]),
                                     _seq(pkg, v["b"], other if axis == 0
                                          else LENGTHS)]},
               {"a": _data((5, 6, 3), 4), "b": _data((5, t2, 3), 5)},
               {"axis": axis}, wrt=["a", "b"])


@pytest.mark.parametrize("d,new_dim", [(4, 2), (2, 4)])
def test_sequence_reshape(d, new_dim):
    lengths = np.array([6, 0, 2, 4, 2], np.int32)
    compare_op("sequence_reshape",
               lambda pkg, v: {"X": [_seq(pkg, v["x"], lengths)]},
               {"x": _data((5, 6, d), 6)}, {"new_dim": new_dim}, wrt=["x"])


def test_sequence_slice():
    compare_op("sequence_slice",
               lambda pkg, v: {"X": [_seq(pkg, v["x"])],
                               "Offset": [v["off"]], "Length": [v["len"]]},
               {"x": _data((5, 6, 3), 7),
                "off": np.array([[1], [0], [2], [0], [3]], np.int32),
                "len": np.array([[3], [0], [2], [1], [5]], np.int32)},
               wrt=["x"])


def test_sequence_erase():
    ids = np.random.RandomState(8).randint(0, 6, (5, 6, 1)).astype(np.int32)
    got = compare_op("sequence_erase",
                     lambda pkg, v: {"X": [_seq(pkg, v["x"])]},
                     {"x": ids}, {"tokens": [2, 5]})
    # stable compaction: each row's kept tokens, in order, then zeros
    for row, n, out, m in zip(ids[..., 0], LENGTHS, got[0][..., 0].numpy(),
                              got[1].numpy()):
        kept = [t for t in row[:n] if t not in (2, 5)]
        assert m == len(kept) and list(out[:m]) == kept and not out[m:].any()


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_sequence_mask(dtype):
    got = compare_op("sequence_mask_op", lambda pkg, v: {"X": [v["x"]]},
                     {"x": LENGTHS}, {"maxlen": 7, "out_dtype": dtype})
    assert got[0].dtype == (torch.float32 if dtype == "float32"
                            else torch.int32)


@pytest.mark.parametrize("beam", [2, 4, 7])
def test_kmax_seq_score_level1(beam):
    scores = np.round(_data((5, 6, 1), 10), 1)
    scores[0, :3, 0] = 0.5                          # ties: lower first
    got = compare_op("kmax_seq_score",
                     lambda pkg, v: {"X": [_seq(pkg, v["x"])]},
                     {"x": scores}, {"beam_size": beam})
    assert got[0].shape == (5, beam)
    # -1 past min(beam, length)
    for row, n in zip(got[0].numpy(), LENGTHS):
        assert (row[min(beam, n):] == -1).all()
        assert (row[:min(beam, n)] >= 0).all()


def test_kmax_seq_score_nested():
    scores = np.round(_data((3, 3, 4, 1), 11), 1)
    scores[0, 0, :2, 0] = 0.25
    got = compare_op("kmax_seq_score",
                     lambda pkg, v: {"X": [_nested(pkg, v["x"])]},
                     {"x": scores}, {"beam_size": 3})
    out = got[0].numpy()
    assert (out[1] == -1).all() and (out[2, 1:] == -1).all()
    np.testing.assert_array_equal(got[1].numpy(), OUTER)


def test_sub_nested_seq():
    sel = np.array([[2, 0, 2], [1, -1, 0], [0, 1, -1]], np.float32)
    got = compare_op("sub_nested_seq",
                     lambda pkg, v: {"X": [_nested(pkg, v["x"])],
                                     "Selection": [v["sel"]]},
                     {"x": _data((3, 3, 4, 2), 12), "sel": sel}, wrt=["x"])
    # the first -1 ends a row's selection; a repeated pick is kept
    np.testing.assert_array_equal(got[1].numpy(), [3, 1, 2])
    np.testing.assert_array_equal(got[2].numpy(),
                                  [[2, 4, 2], [0, 0, 0], [3, 0, 0]])


@pytest.mark.parametrize("sparse", [False, True])
def test_lookup_table_on_nested_ids(sparse):
    ids = np.random.RandomState(13).randint(0, 7, (3, 3, 4, 1))
    ids = ids.astype(np.int32)
    table = _data((7, 5), 14)
    compare_op("lookup_table",
               lambda pkg, v: {"W": [v["w"]], "Ids": [_nested(pkg, v["ids"])]},
               {"w": table, "ids": ids}, {"padding_idx": 3}, wrt=["w"])
    og = _data((3, 3, 4, 5), 15)
    got = compare_op("lookup_table_grad",
                     lambda pkg, v: {"W": [v["w"]],
                                     "Ids": [_nested(pkg, v["ids"])],
                                     "Out@GRAD": [_nested(pkg, v["og"])]},
                     {"w": table, "ids": ids, "og": og},
                     {"is_sparse": sparse, "padding_idx": 3},
                     out_slots=("W@GRAD",))
    assert len(got) == (2 if sparse else 1)


# -- programs through both packages ---------------------------------------------

def _run_both(build, feeds, fetch_names=None, steps=1):
    """Build ``build(fluid)`` -> (main, startup, fetch vars) in both
    packages (same bytes), run the reference's startup, copy its scope
    into the port, and run ``steps`` passes over ``feeds(pkg)`` in each
    -> (the reference's fetches, the port's, both scopes' parameters)."""
    out = {}
    progs = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = build(fluid)
        progs[pkg] = (main, startup, fetch)
    assert progs["port"][0].serialize_to_string() == \
        progs["jax"][0].serialize_to_string()
    main, startup, fetch = progs["jax"]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        out["jax"] = [exe.run(main, feed=feeds("jax"), fetch_list=fetch,
                              return_numpy=False) for _ in range(steps)]
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.global_block().all_parameters()}
    main, _, fetch = progs["port"]
    tscope = tfluid.scope_from_numpy(init, tfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    out["port"] = [texe.run(main, feed=feeds("port"), fetch_list=fetch,
                            scope=tscope) for _ in range(steps)]
    tparams = tfluid.scope_to_numpy(tscope, list(params))
    for n in params:
        np.testing.assert_allclose(tparams[n], params[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    return out["jax"], out["port"], texe


def _make(pkg):
    return (jlod if pkg == "jax" else tlod)


def _same(got, want, rtol=1e-6, atol=1e-6):
    """A fetched value (array, SeqArray, NestedSeqArray) of the port
    against the reference's: lengths exactly, data within tolerance."""
    got_parts, want_parts = _flat(got), _flat(want)
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got_parts, want_parts):
        g, w = np.asarray(g), np.asarray(w)
        if w.dtype.kind == "V":
            continue      # the reference's gradient of lengths: float0
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(g, w)


def test_nested_sequence_expand_program():
    """The reference's numeric case: each outer element of X broadcast
    over its sub-sequence's steps, padding 0."""
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32",
                              lod_level=1)
        y = fluid.layers.data(name="y", shape=[1], dtype="float32",
                              lod_level=2)
        out = fluid.layers.sequence_expand(x, y)
        assert out.lod_level == 2
        return [out]

    def feeds(pkg):
        lod = _make(pkg)
        return {"x": lod.make_seq([[[1., 1.], [2., 2.]], [[3., 3.]]],
                                  dtype=np.float32),
                "y": lod.make_nested_seq([[[5., 6., 7.], [8.]], [[9., 9.]]],
                                         dtype=np.float32)}

    (want,), (got,), _ = _run_both(build, feeds)
    res = got[0]
    assert isinstance(res, tlod.NestedSeqArray)
    _same(res, want[0])
    np.testing.assert_array_equal(res.outer_lengths, [2, 1])
    np.testing.assert_array_equal(res.inner_lengths, [[3, 1], [2, 0]])
    np.testing.assert_allclose(res.data[0, 0], [[1, 1], [1, 1], [1, 1]])
    np.testing.assert_allclose(res.data[0, 1], [[2, 2], [0, 0], [0, 0]])
    np.testing.assert_allclose(res.data[1, 0], [[3, 3], [3, 3], [0, 0]])
    np.testing.assert_allclose(res.data[1, 1], 0)


def test_paragraph_pooling_trains_as_the_reference():
    """Paragraphs of sentences of word embeddings -> nested average pool
    -> max over sentences -> classifier, 30 Adam steps on one batch in
    both packages: the same losses, falling."""
    vocab, dim = 20, 6

    def build(fluid):
        words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                  lod_level=2)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(input=words, size=[vocab, dim],
                                     param_attr="nested_emb_w")
        sent = fluid.layers.nested_sequence_pool(emb, pool_type="average")
        para = fluid.layers.sequence_pool(input=sent, pool_type="max")
        pred = fluid.layers.fc(input=para, size=2, act="softmax")
        cost = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.Adam(learning_rate=5e-2).minimize(cost)
        return [cost]

    rng = np.random.RandomState(3)
    paras, labels = [], []
    for _ in range(8):
        pol = rng.randint(0, 2)
        lo, hi = (2, vocab // 2) if pol == 0 else (vocab // 2, vocab)
        paras.append([rng.randint(lo, hi, rng.randint(1, 5)).tolist()
                      for _ in range(rng.randint(1, 4))])
        labels.append([pol])

    def feeds(pkg):
        return {"words": _make(pkg).make_nested_seq(paras, dtype=np.int64),
                "label": np.asarray(labels, np.int64)}

    want, got, _ = _run_both(build, feeds, steps=30)
    want = [float(np.asarray(w[0])) for w in want]
    got = [float(g[0]) for g in got]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] * 0.6, (got[0], got[-1])


def test_kmax_and_sub_nested_seq_programs():
    """The reference's cases: nested kmax scores one row per
    sub-sequence; sub_nested_seq reorders, the first -1 ends a row; its
    gradient lands on the picked sub-sequences only; kmax feeding
    sub_nested_seq picks the best sub-sequence (the v2 pipeline)."""
    def build(fluid):
        x = fluid.layers.data("x", [1], "float32", lod_level=2)
        x.stop_gradient = False
        scores = fluid.layers.data("scores", [1], "float32", lod_level=2)
        flat_scores = fluid.layers.data("flat", [1], "float32", lod_level=1)
        sel = fluid.layers.data("sel", [3], "float32")
        top = fluid.layers.kmax_seq_score(scores, beam_size=2)
        assert top.lod_level == 1
        picked = fluid.layers.sub_nested_seq(x, sel)
        pooled = fluid.layers.nested_sequence_pool(picked, "sum")
        loss = fluid.layers.reduce_sum(fluid.layers.sequence_pool(
            pooled, "sum"))
        best = fluid.layers.sub_nested_seq(
            x, fluid.layers.kmax_seq_score(flat_scores, beam_size=1))
        best_sum = fluid.layers.nested_sequence_pool(best, "sum")
        fluid.append_backward(loss)
        return [top, picked, x.grad_name, best_sum]

    def feeds(pkg):
        lod = _make(pkg)
        return {"x": lod.make_nested_seq(
                    [[[1.0, 1.5], [2.0, 2.5], [3.0, 3.5]],
                     [[4.0, 4.5], [5.0, 5.5]]], dtype=np.float32),
                "scores": lod.make_nested_seq(
                    [[[0.1, 0.9], [0.7, 0.2], [0.3]], [[0.2, 0.2]]],
                    dtype=np.float32),
                "flat": lod.make_seq([[0.1, 0.9, 0.5], [0.8, 0.2]],
                                     dtype=np.float32),
                "sel": np.asarray([[2.0, 0.0, 2.0], [1.0, -1.0, 0.0]],
                                  np.float32)}

    (want,), (got,), _ = _run_both(build, feeds)
    for g, w in zip(got, want):
        _same(g, w)
    top, picked, grad, best = got
    np.testing.assert_array_equal(top.lengths, [3, 1])
    np.testing.assert_allclose(top.data[0], [[1, 0], [0, 1], [0, -1]])
    np.testing.assert_allclose(top.data[1, 0], [0, 1])      # tie: lower
    np.testing.assert_array_equal(picked.outer_lengths, [3, 1])
    np.testing.assert_allclose(picked.data[0, 0], [3.0, 3.5])
    np.testing.assert_allclose(picked.data[0, 1], [1.0, 1.5])
    np.testing.assert_allclose(picked.data[1, 1], 0.0)
    # the scatter gradient: subsequence 2 picked twice, 1 never
    gd = np.asarray(grad.data if hasattr(grad, "data") else grad)
    np.testing.assert_allclose(gd[0, :, :2].sum(axis=1), [2.0, 0.0, 4.0])
    np.testing.assert_allclose(gd[1, :, :2].sum(axis=1), [0.0, 2.0, 0.0])
    np.testing.assert_allclose(best.data[:, 0], [4.5, 8.5])


def _rnn_over_subsequences(fluid, scale_output):
    x = fluid.layers.data("x", [1], "float32", lod_level=2)
    rnn = fluid.layers.DynamicRNN()
    with rnn.block():
        sub = rnn.step_input(x)              # one sub-sequence a step
        if scale_output:
            rnn.output(fluid.layers.scale(sub, scale=2.0))
        else:
            acc = rnn.memory(shape=[1])
            new_acc = fluid.layers.elementwise_add(
                acc, fluid.layers.sequence_pool(sub, "sum"))
            rnn.update_memory(acc, new_acc)
            rnn.output(new_acc)
    return [rnn()]


def _subsequence_feed(pkg):
    return {"x": _make(pkg).make_nested_seq(
        [[[[1.0], [2.0]], [[3.0]]], [[[4.0], [5.0], [6.0]]]],
        dtype=np.float32)}


def test_dynamic_rnn_over_subsequences():
    """Each step sees one sub-sequence of every row as a level-1
    sequence; the outer lengths mask the state."""
    (want,), (got,), _ = _run_both(
        lambda fluid: _rnn_over_subsequences(fluid, False),
        _subsequence_feed)
    out = got[0]
    _same(out, want[0])
    assert isinstance(out, tlod.SeqArray)
    np.testing.assert_array_equal(out.lengths, [2, 1])
    np.testing.assert_allclose(out.data[0, :, 0], [3.0, 6.0])
    np.testing.assert_allclose(out.data[1, 0, 0], 15.0)
    np.testing.assert_allclose(out.data[1, 1, 0], 0.0)


def test_sequence_valued_step_outputs_stack_nested():
    (want,), (got,), _ = _run_both(
        lambda fluid: _rnn_over_subsequences(fluid, True), _subsequence_feed)
    out = got[0]
    _same(out, want[0])
    assert isinstance(out, tlod.NestedSeqArray)
    np.testing.assert_array_equal(out.outer_lengths, [2, 1])
    np.testing.assert_array_equal(out.inner_lengths, [[2, 1], [3, 0]])
    np.testing.assert_allclose(out.data[0, 0, :2, 0], [2.0, 4.0])
    np.testing.assert_allclose(out.data[1, 0, :3, 0], [8.0, 10.0, 12.0])


def test_recurrent_group_over_subsequences_trains():
    """The reference's v2 pipeline (``recurrent_group`` over a
    ``SubsequenceInput``: an fc on each pooled sub-sequence, the last
    step, a softmax classifier, SGD 0.2) as the Fluid program it builds:
    30 steps in both packages, the same falling losses."""
    def build(fluid):
        x = fluid.layers.data("x", [2], "float32", lod_level=2)
        lbl = fluid.layers.data("lbl", [1], "int64")
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            sub = rnn.step_input(x)
            rnn.output(fluid.layers.fc(
                input=fluid.layers.sequence_pool(sub, "sum"), size=4,
                act="tanh"))
        final = fluid.layers.sequence_last_step(rnn())
        pred = fluid.layers.fc(input=final, size=3, act="softmax")
        cost = fluid.layers.mean(fluid.layers.cross_entropy(pred, lbl))
        fluid.optimizer.SGD(learning_rate=0.2).minimize(cost)
        return [cost]

    rng = np.random.RandomState(0)
    rows = [[rng.rand(3, 2), rng.rand(2, 2)], [rng.rand(4, 2)]]

    def feeds(pkg):
        return {"x": _make(pkg).make_nested_seq(rows, dtype=np.float32),
                "lbl": np.asarray([[0], [2]], np.int64)}

    want, got, _ = _run_both(build, feeds, steps=30)
    want = [float(np.asarray(w[0])) for w in want]
    got = [float(g[0]) for g in got]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


# -- the hierarchical LSTM classifier (chip_smoke's phase 33 program) ------

HIER = dict(vocab=20, emb=8, hidden=8)


def test_hierarchical_classifier_matches_reference():
    rng = np.random.RandomState(6)
    batches = [chip_smoke.hierarchical_batch(np, rng, 4, 2, 4,
                                             HIER["vocab"])
               for _ in range(3)]
    order = []

    def feeds(pkg):
        # both packages run the same three batches in turn
        i = order.count(pkg)
        order.append(pkg)
        paras, labels = batches[i]
        return {"words": _make(pkg).make_nested_seq(
                    paras, dtype=np.int32, outer_bucket=2, inner_bucket=4),
                "label": labels}

    want, got, texe = _run_both(
        lambda fluid: [chip_smoke.hierarchical_net(fluid, **HIER)], feeds,
        steps=3)
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(np.asarray(w[0])) for w in want],
                               rtol=LOSS_RTOL)
    # one padded shape: the step is one executable, hit after its first
    # run (the card replays one CUDA graph)
    stats = texe.cache_stats()["executable"]
    assert (stats["misses"], stats["hits"]) == (1, 2)
