"""Sparse embeddings in the port — SelectedRows, the sparse gradient of
``lookup_table``, ``sum`` over SelectedRows and the sparse updates of
``sgd``, ``momentum``, ``adam`` and ``adagrad`` — and the models that
train through them (CTR wide&deep, the book's word2vec and recommender,
and ``convolution_net``), against the JAX package on the CPU.

* ``merge_rows``, ``to_dense`` and ``scatter_add_to`` against the
  reference's at duplicate rows and at sentinel rows: the merged rows
  and the sentinel slots exactly, the summed values within float32
  rounding of the reference's order (OUT_TOL).
* The sparse update ops at duplicate rows and a sentinel row, through
  both emitters: parameter and moments within OUT_TOL, untouched rows
  exactly as they were; each op writes its state in place.
* Sparse training (``embedding(is_sparse=True)``, the same table looked
  up twice) against the port's dense training: SGD and Adagrad at the
  reference's ``atol=2e-7`` (``tests/test_sparse.py:90``), Momentum and
  Adam too, in the zero-moment, fixed-rows case where the lazy update
  equals the dense one; ``padding_idx`` rows get no update; with
  ``SelectedRows.to_dense`` patched to raise, sparse SGD, Momentum,
  Adam and Adagrad never densify.
* Programs: CTR wide&deep (sparse and dense), word2vec, the recommender
  and ``convolution_net`` serialize to the same bytes in both packages;
  each trains 5 steps on the CPU port from the JAX package's initialized
  scope (copied as numpy) on the same seeded feeds, every loss within
  LOSS_RTOL and every parameter within PARAM_ATOL of the reference's.
* ``chip_smoke.py``'s card-vs-CPU rule for the sparse phase fails a
  halved update and a wrong moment.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.selected_rows import SelectedRows as JSR
from paddle_tpu.fluid.core.selected_rows import merge_rows as jmerge
from paddle_tpu.models import ctr as JCtr
from paddle_tpu.models import recommender as JRec
from paddle_tpu.models import sentiment as JSent
from paddle_tpu.models import word2vec as JW2V
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.core.selected_rows import SelectedRows as TSR
from paddle_tpu_torch.fluid.core.selected_rows import merge_rows as tmerge
from paddle_tpu_torch.models import ctr as TCtr
from paddle_tpu_torch.models import recommender as TRec
from paddle_tpu_torch.models import sentiment as TSent
from paddle_tpu_torch.models import word2vec as TW2V
from tests.test_torch_amp import _emit
from tests.test_torch_book import OUT_TOL

# float32 on both sides, summed in another order: the losses of 5 steps
# and the parameters after them
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _sr_arrays(rng, n=9, dim=3, height=12, sentinel=True):
    """Rows with duplicates (and, with ``sentinel``, a vacated slot at
    ``height``), seeded values."""
    rows = rng.randint(0, height // 2, n).astype(np.int32)
    rows[0] = rows[1] = rows[3]                 # a triple
    if sentinel:
        rows[-1] = height
    vals = rng.randn(n, dim).astype(np.float32)
    return rows, vals, height


def _both_sr(rows, vals, height):
    return (JSR(jnp.asarray(rows), jnp.asarray(vals), height),
            TSR(torch.tensor(rows), torch.tensor(vals), height))


@pytest.mark.parametrize("height,dim,n,kind", [
    (258, 8, 1024, "positions"), (4096, 16, 512, "zipf"),
    (5, 3, 1, "one")])
def test_segment_sum_is_the_cpu_embedding_adjoint_bit_for_bit(height, dim,
                                                              n, kind):
    """``segment_sum`` (a stable sort, a sum a run, ``index_add_`` of the
    run sums and zeros) gives the bits of PyTorch's embedding adjoint on
    the CPU, which adds each row's values in index order from 0.0: position-table ids (each row
    many times), Zipf-drawn ids, one id; and its gradient is the row
    gather of the output's."""
    from paddle_tpu_torch.fluid.core.selected_rows import segment_sum

    rng = np.random.RandomState(7)
    if kind == "positions":
        ids = np.tile(np.arange(256), n // 256)
    else:
        ids = rng.zipf(1.1, n) * 2654435761 % height
    ids = torch.tensor(ids.astype(np.int64))
    vals = torch.tensor(rng.randn(n, dim).astype(np.float32),
                        requires_grad=True)
    got = segment_sum(vals, ids, height)
    want = torch.ops.aten.embedding_dense_backward(vals.detach(), ids,
                                                   height, -1, False)
    assert torch.equal(got.detach().view(torch.int32),
                       want.view(torch.int32))
    dout = torch.tensor(rng.randn(height, dim).astype(np.float32))
    got.backward(dout)
    assert torch.equal(vals.grad, dout[ids])


@pytest.mark.parametrize("sentinel", [False, True])
def test_merge_rows_matches_reference(sentinel):
    """Merged rows: the distinct rows ascending, then the sentinel;
    values the sums (within float32 rounding of the reference's order);
    the slots past the distinct rows (the input's own sentinel slot is
    one of them) vacated: the sentinel row and zeros."""
    rows, vals, height = _sr_arrays(np.random.RandomState(0),
                                    sentinel=sentinel)
    j, t = _both_sr(rows, vals, height)
    jm, tm = jmerge(j), tmerge(t)
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    assert tm.rows.dtype == torch.int32 and tm.height == height
    np.testing.assert_allclose(tm.values.numpy(), np.asarray(jm.values),
                               **OUT_TOL)
    distinct = len(np.unique(rows))
    assert (tm.rows.numpy()[distinct:] == height).all() and distinct <= 6
    assert (tm.values.numpy()[distinct:] == 0).all()


def test_to_dense_and_scatter_add_to_match_reference():
    rows, vals, height = _sr_arrays(np.random.RandomState(1))
    j, t = _both_sr(rows, vals, height)
    np.testing.assert_allclose(t.to_dense().numpy(),
                               np.asarray(j.to_dense()), **OUT_TOL)
    base = np.random.RandomState(2).randn(height, 3).astype(np.float32)
    dense = torch.tensor(base)
    out = t.scatter_add_to(dense, scale=torch.tensor([-0.5]))
    assert out is dense                             # in place
    want = np.asarray(j.scatter_add_to(jnp.asarray(base),
                                       scale=jnp.asarray([-0.5])))
    np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)
    # rows no slot names are untouched, bit for bit
    untouched = np.setdiff1d(np.arange(height), rows)
    np.testing.assert_array_equal(out.numpy()[untouched], base[untouched])


def test_sentinel_slot_leaves_negative_zero_alone():
    """A vacated slot adds -0.0 to the first slot's row (the last row if
    every slot is vacant), which leaves every value as it was, -0.0
    included."""
    base = torch.tensor([[-0.0, 1.0], [2.0, -0.0], [-0.0, -0.0],
                         [0.0, -0.0]])
    for rows, touched in (([1, 4], 1), ([4, 4], None)):
        dense = base.clone()
        TSR(torch.tensor(rows, dtype=torch.int32), torch.ones(2, 2),
            4).scatter_add_to(dense)
        for r in range(4):
            want = base[r] + 1 if r == touched else base[r]
            assert torch.equal(dense[r], want)
            assert torch.equal(torch.signbit(dense[r]),
                               torch.signbit(want)), (rows, r)


@pytest.mark.parametrize("pad", [None, 3])
@pytest.mark.parametrize("seq", [False, True], ids=["dense_ids", "seq_ids"])
def test_sparse_lookup_table_grad_matches_reference(pad, seq):
    """The gradient is SelectedRows(ids, output-gradient rows, V):
    duplicates kept, padding_idx rows zero, and for sequence ids every
    padded position a row with zero values (the reference's)."""
    rng = np.random.RandomState(3)
    w = rng.randn(10, 4).astype(np.float32)
    ids = rng.randint(0, 10, (3, 5, 1)).astype(np.int32)
    ids[0, :2, 0] = 3
    og = rng.randn(3, 5, 4).astype(np.float32)
    lengths = np.array([5, 2, 4], np.int32)
    if seq:
        og = og * (np.arange(5)[None, :] < lengths[:, None])[..., None]
    attrs = {"is_sparse": True}
    if pad is not None:
        attrs["padding_idx"] = pad

    def wrap(lod, ids, og, conv):
        if not seq:
            return conv(ids), conv(og)
        return (lod.SeqArray(conv(ids), conv(lengths)),
                lod.SeqArray(conv(og), conv(lengths)))

    from paddle_tpu.fluid.core import lod as jlod
    from paddle_tpu_torch.fluid.core import lod as tlod

    ji, jo = wrap(jlod, ids, og, jnp.asarray)
    ti, to = wrap(tlod, ids, og, torch.tensor)
    jg = _emit(jreg, JOpDesc, "lookup_table_grad",
               {"W": [jnp.asarray(w)], "Ids": [ji], "Out@GRAD": [jo]},
               attrs)["W@GRAD"][0]
    tg = _emit(treg, TOpDesc, "lookup_table_grad",
               {"W": [torch.tensor(w)], "Ids": [ti], "Out@GRAD": [to]},
               attrs)["W@GRAD"][0]
    assert isinstance(tg, TSR) and tg.height == 10
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
    # the dense gradient is the same rows summed
    attrs["is_sparse"] = False
    dense = _emit(treg, TOpDesc, "lookup_table_grad",
                  {"W": [torch.tensor(w)], "Ids": [ti], "Out@GRAD": [to]},
                  attrs)["W@GRAD"][0]
    np.testing.assert_allclose(dense.numpy(), np.asarray(jg.to_dense()),
                               **OUT_TOL)


@pytest.mark.parametrize("mix", ["sparse", "mixed"])
def test_sum_over_selected_rows_matches_reference(mix):
    """All sparse: one SelectedRows of the concatenated rows; beside a
    dense input: the dense sum with the rows scattered on."""
    rng = np.random.RandomState(4)
    a, b = _sr_arrays(rng, 5, 2, 8), _sr_arrays(rng, 4, 2, 8, False)
    ja, ta = _both_sr(*a)
    jb, tb = _both_sr(*b)
    jx, tx = [ja, jb], [ta, tb]
    if mix == "mixed":
        d = rng.randn(8, 2).astype(np.float32)
        jx.insert(1, jnp.asarray(d))
        tx.insert(1, torch.tensor(d))
    jo = _emit(jreg, JOpDesc, "sum", {"X": jx}, {})["Out"][0]
    to = _emit(treg, TOpDesc, "sum", {"X": tx}, {})["Out"][0]
    if mix == "sparse":
        np.testing.assert_array_equal(to.rows.numpy(), np.asarray(jo.rows))
        np.testing.assert_array_equal(to.values.numpy(),
                                      np.asarray(jo.values))
    else:
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT_TOL)
        np.testing.assert_array_equal(tx[1].numpy(), d)   # input unchanged


SPARSE_UPDATES = {
    "sgd": (dict(), ("Param",), ("ParamOut",)),
    "momentum": (dict(mu=0.9), ("Param", "Velocity"),
                 ("ParamOut", "VelocityOut")),
    "momentum_nesterov": (dict(mu=0.9, use_nesterov=True),
                          ("Param", "Velocity"),
                          ("ParamOut", "VelocityOut")),
    "adam": (dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
             ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
             ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut")),
    "adagrad": (dict(epsilon=1e-6), ("Param", "Moment"),
                ("ParamOut", "MomentOut")),
}


@pytest.mark.parametrize("name", sorted(SPARSE_UPDATES))
def test_sparse_update_ops_match_reference(name, monkeypatch):
    """Duplicate rows and a sentinel slot, non-zero moments: every output
    within OUT_TOL of the reference's, the rows the gradient does not
    name exactly as they were, the state updated in place, and no
    densified gradient."""
    op = name.split("_")[0]
    attrs, state, outs = SPARSE_UPDATES[name]
    rng = np.random.RandomState(5)
    rows, vals, height = _sr_arrays(rng, 9, 3, 12)
    arrays = {"LearningRate": np.array([0.1], np.float32)}
    for s in state:
        if s.startswith("Beta"):
            arrays[s] = np.array([0.9 if s == "Beta1Pow" else 0.999],
                                 np.float32)
        else:
            arrays[s] = rng.randn(height, 3).astype(np.float32)
            if s.startswith("Moment"):
                arrays[s] = np.abs(arrays[s])
    jg, tg = _both_sr(rows, vals, height)
    j_out = _emit(jreg, JOpDesc, op,
                  {"Grad": [jg], **{s: [jnp.asarray(a)]
                                    for s, a in arrays.items()}}, attrs)
    monkeypatch.setattr(TSR, "to_dense", lambda self: pytest.fail(
        f"{op} densified a SelectedRows gradient"))
    t_ins = {s: torch.tensor(a) for s, a in arrays.items()}
    t_out = _emit(treg, TOpDesc, op,
                  {"Grad": [tg], **{s: [v] for s, v in t_ins.items()}},
                  attrs)
    untouched = np.setdiff1d(np.arange(height), rows)
    for s, o in zip(state, outs):
        assert t_out[o][0] is t_ins[s], o
        np.testing.assert_allclose(t_out[o][0].numpy(),
                                   np.asarray(j_out[o][0]), **OUT_TOL,
                                   err_msg=o)
        if not s.startswith("Beta"):
            np.testing.assert_array_equal(
                t_out[o][0].numpy()[untouched], arrays[s][untouched])


def _embedding_net(is_sparse, make_opt, vocab=50, dim=8, pad=None):
    """tests/test_sparse.py's net: one table looked up twice (the
    gradient's fan-in sums two SelectedRows), an fc over both."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("ids", [6], "int64")
        emb = tfluid.layers.embedding(ids, size=[vocab, dim],
                                      is_sparse=is_sparse, padding_idx=pad,
                                      param_attr="emb_w")
        emb2 = tfluid.layers.embedding(ids, size=[vocab, dim],
                                       is_sparse=is_sparse, padding_idx=pad,
                                       param_attr="emb_w")
        both = tfluid.layers.elementwise_add(emb, emb2)
        pred = tfluid.layers.fc(input=both, size=1, num_flatten_dims=2,
                                bias_attr=False)
        loss = tfluid.layers.mean(pred)
        make_opt().minimize(loss)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


OPTIMIZERS = {
    "sgd": lambda: tfluid.optimizer.SGD(learning_rate=0.1),
    "adagrad": lambda: tfluid.optimizer.Adagrad(learning_rate=0.1),
    "momentum": lambda: tfluid.optimizer.Momentum(learning_rate=0.1,
                                                  momentum=0.9),
    "adam": lambda: tfluid.optimizer.Adam(learning_rate=0.1),
}


def _train(main, startup, loss, feed, steps=4):
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, scope


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sparse_trains_as_dense(name):
    """4 steps on one fixed batch (a fixed set of touched rows, moments
    from zero): the sparse table equals the dense one within the
    reference's atol=2e-7 for every optimizer here."""
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 50, (4, 6)).astype(np.int64)}
    got = {}
    for sp in (False, True):
        main, startup, loss = _embedding_net(sp, OPTIMIZERS[name])
        _, scope = _train(main, startup, loss, feed)
        got[sp] = scope.find_var("emb_w").numpy()
    np.testing.assert_allclose(got[True], got[False], rtol=0, atol=2e-7)
    touched = np.unique(feed["ids"])
    assert np.abs(got[True][touched]).sum() > 0


def test_padding_idx_rows_get_no_update():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("ids", [4], "int64")
        emb = tfluid.layers.embedding(ids, size=[20, 4], is_sparse=True,
                                      padding_idx=0, param_attr="emb_w")
        loss = tfluid.layers.mean(emb)
        tfluid.optimizer.SGD(learning_rate=1.0).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.find_var("emb_w").numpy().copy()
    exe.run(main, feed={"ids": np.array([[0, 1, 2, 0]], np.int64)},
            fetch_list=[loss], scope=scope)
    after = scope.find_var("emb_w").numpy()
    np.testing.assert_array_equal(after[0], before[0])
    assert np.abs(after[1] - before[1]).max() > 0
    np.testing.assert_array_equal(after[3:], before[3:])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_sparse_training_never_densifies(name, monkeypatch):
    monkeypatch.setattr(TSR, "to_dense", lambda self: pytest.fail(
        f"{name}: the sparse path densified a SelectedRows gradient"))
    main, startup, loss = _embedding_net(True, OPTIMIZERS[name])
    rng = np.random.RandomState(3)
    losses, _ = _train(main, startup, loss,
                       {"ids": rng.randint(0, 50, (4, 6)).astype(np.int64)},
                       steps=6)
    assert losses[-1] < losses[0]


def test_sparse_gradient_fetch_is_the_reference_form():
    """A fetched SelectedRows comes back as the reference returns it: a
    0-d object array holding the SelectedRows (here of numpy arrays)."""
    main, startup, loss = _embedding_net(True, OPTIMIZERS["sgd"])
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    ids = np.arange(24).reshape(4, 6) % 7
    _, g = exe.run(main, feed={"ids": ids}, fetch_list=[loss, "emb_w@GRAD"],
                   scope=scope)
    assert g.dtype == object and g.shape == ()
    sr = g[()]
    assert isinstance(sr.rows, np.ndarray) and sr.values.shape == (48, 8)
    np.testing.assert_array_equal(np.sort(sr.rows),
                                  np.sort(np.tile(ids.reshape(-1), 2)))


# -- the models ---------------------------------------------------------------

N_SLOTS, CTR_VOCAB, CTR_BATCH = 4, 64, 16


def ctr_program(is_sparse):
    def make(fluid, models):
        sparse_ids = [fluid.layers.data(f"C{i}", [1], "int64")
                      for i in range(N_SLOTS)]
        dense = fluid.layers.data("dense", [5], "float32")
        label = fluid.layers.data("label", [1], "float32")
        avg_cost, _ = models["ctr"].wide_and_deep(
            sparse_ids, dense, label, slot_vocab=CTR_VOCAB, embed_dim=4,
            hidden_sizes=(16, 8), is_sparse=is_sparse)
        fluid.optimizer.Adagrad(learning_rate=0.1).minimize(avg_cost)
        return avg_cost
    return make


def ctr_feed(i):
    """Slot ids from a skewed draw (repeats in a batch), a click when
    slot 0's id is even (tests/test_sparse.py's signal)."""
    rng = np.random.RandomState(100 + i)
    ids = (rng.zipf(1.5, (CTR_BATCH, N_SLOTS)) % CTR_VOCAB).astype(np.int64)
    feed = {f"C{k}": ids[:, k:k + 1] for k in range(N_SLOTS)}
    feed["dense"] = rng.randn(CTR_BATCH, 5).astype(np.float32)
    feed["label"] = (ids[:, :1] % 2 == 0).astype(np.float32)
    return feed


W2V_DICT = 40


def word2vec_program(fluid, models):
    words = [fluid.layers.data(n, [1], "int64")
             for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")]
    avg_cost, _ = models["w2v"].ngram_model(words, W2V_DICT, embed_size=8,
                                            hidden_size=16)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return avg_cost


def word2vec_feed(i):
    rng = np.random.RandomState(200 + i)
    ids = rng.randint(0, W2V_DICT, (8, 5)).astype(np.int64)
    return {n: ids[:, k:k + 1] for k, n in enumerate(
        ("firstw", "secondw", "thirdw", "forthw", "nextw"))}


def rec_dims(models):
    return models["rec"].MovieLensDims(
        max_user_id=30, max_job_id=5, n_age_buckets=4, max_movie_id=40,
        n_categories=6, title_dict_size=50)


def recommender_program(fluid, models):
    avg_cost, _ = models["rec"].recommender(rec_dims(models))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(avg_cost)
    return avg_cost


def recommender_feed(make_seq):
    def feed(i):
        rng = np.random.RandomState(300 + i)
        b = 6
        out = {n: rng.randint(0, v, (b, 1)).astype(np.int64)
               for n, v in (("user_id", 30), ("gender_id", 2),
                            ("age_id", 4), ("job_id", 5),
                            ("movie_id", 40))}
        out["category_id"] = make_seq(
            [rng.randint(0, 6, (rng.randint(1, 4), 1)) for _ in range(b)],
            dtype=np.int32, max_len=4)
        out["movie_title"] = make_seq(
            [rng.randint(0, 50, (rng.randint(1, 7), 1)) for _ in range(b)],
            dtype=np.int32, max_len=8)
        out["score"] = rng.randint(1, 6, (b, 1)).astype(np.float32)
        return out
    return feed


def conv_net_program(fluid, models):
    data = fluid.layers.data("words", [1], "int64", lod_level=1)
    label = fluid.layers.data("label", [1], "int64")
    avg_cost, _, _ = models["sent"].convolution_net(
        data, label, input_dim=30, class_dim=2, emb_dim=8, hid_dim=8)
    fluid.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return avg_cost


def conv_net_feed(make_seq):
    def feed(i):
        rng = np.random.RandomState(400 + i)
        lengths = rng.randint(1, 9, 5)
        return {"words": make_seq([rng.randint(0, 30, (m, 1))
                                   for m in lengths], dtype=np.int32,
                                  max_len=8),
                "label": rng.randint(0, 2, (5, 1)).astype(np.int64)}
    return feed


PACKAGES = {"jax": (jfluid, {"ctr": JCtr, "w2v": JW2V, "rec": JRec,
                             "sent": JSent}),
            "port": (tfluid, {"ctr": TCtr, "w2v": TW2V, "rec": TRec,
                              "sent": TSent})}
MODELS = {
    "ctr_sparse": (ctr_program(True), lambda pkg: ctr_feed),
    "ctr_dense": (ctr_program(False), lambda pkg: ctr_feed),
    "word2vec": (word2vec_program, lambda pkg: word2vec_feed),
    "recommender": (recommender_program,
                    lambda pkg: recommender_feed(pkg.make_seq)),
    "convolution_net": (conv_net_program,
                        lambda pkg: conv_net_feed(pkg.make_seq)),
}


def build(package, model):
    fluid, models = PACKAGES[package]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = MODELS[model][0](fluid, models)
    return main, startup, loss


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_program_bytes_match_reference(model):
    jm, js, _ = build("jax", model)
    tm, ts, _ = build("port", model)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    if model in ("ctr_sparse", "recommender"):
        assert any(op.type == "lookup_table_grad"
                   and op.attr("is_sparse") for op in tm.global_block().ops)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_trains_as_the_reference(model):
    """5 steps from the reference's initialized scope on the same feeds:
    every loss within LOSS_RTOL, every parameter and accumulator after
    them within PARAM_ATOL; the loss falls over the steps (one fixed
    batch for CTR, whose slot-0 signal the wide part learns)."""
    steps = 5
    jm, js, jloss = build("jax", model)
    feed_j = MODELS[model][1](jfluid)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    fixed = model.startswith("ctr")
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = [float(np.asarray(exe.run(
            jm, feed=feed_j(0 if fixed else i), fetch_list=[jloss])[0]))
            for i in range(steps)]
        after = {n: np.asarray(scope.find_var(n)) for n in init}
    tm, _, tloss = build("port", model)
    feed_t = MODELS[model][1](tfluid)
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    got = [float(texe.run(tm, feed=feed_t(0 if fixed else i),
                          fetch_list=[tloss], scope=tscope)[0])
           for i in range(steps)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    got_state = tfluid.scope_to_numpy(tscope, list(init))
    for n in init:
        np.testing.assert_allclose(got_state[n], after[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    if fixed:
        assert got[-1] < got[0], got


def test_chip_smoke_update_rule_catches_a_wrong_update():
    """``chip_smoke.update_errors``, the card-vs-CPU rule of the sparse
    phase: equal states read 0; an Adagrad update halved where the
    gradient is large, or a moment off, reads far above
    SPARSE_UPDATE_RTOL; a difference only where this step's gradient is
    below SPARSE_G_FLOOR of its largest (where Adagrad's update is
    steep in g) is not held."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(root)
    rng = np.random.RandomState(6)
    p0 = rng.randn(50, 4).astype(np.float32)
    m0 = np.abs(rng.randn(50, 4)).astype(np.float32)
    g = rng.randn(50, 4).astype(np.float32)
    g[0, 0] = 1e-6                                   # below the floor
    m1 = m0 + g * g
    p1 = (p0 - 0.1 * g / (np.sqrt(m1) + 1e-6)).astype(np.float32)
    before, cpu = {"p": p0, "m": m0}, {"p": p1, "m": m1}

    def err(card):
        out = cs.update_errors(np, card, cpu, before, ["p", "m"], {"p": "m"})
        return max(out.values())

    assert err(dict(cpu)) == 0.0
    halved = p1.copy()
    halved[3, 1] = p0[3, 1] + (p1[3, 1] - p0[3, 1]) / 2
    assert err({"p": halved, "m": m1}) > 100 * cs.SPARSE_UPDATE_RTOL
    steep = p1.copy()
    steep[0, 0] += 0.01
    assert err({"p": steep, "m": m1}) == 0.0
    moment = m1.copy()
    moment[0, 0] *= 2
    assert err({"p": p1, "m": moment}) > cs.SPARSE_UPDATE_RTOL
