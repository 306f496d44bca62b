"""Semantic role labeling in the port (``fluid/ops/crf_ops.py``, the CRF
layers, ``fluid/evaluator.py``, ``models/label_semantic_roles.py``)
against the JAX package on the CPU.

* ``linear_chain_crf`` through both emitters on seeded emissions over
  ragged lengths (length 1 included): the loss within LOSS_RTOL and
  the gradients of sum(nll * w) for the emissions and the transitions
  within GRAD_RTOL of their largest (float32, summation order only).
  Its backward graph holds no indexed write (``index_put``: float
  atomics on the card), so replays sum in one order.
* ``crf_decoding`` with and without Label, and ``chunk_eval`` on random
  IOB tag sequences: bit for bit; with zero transitions the Viterbi
  path is each step's argmax (``tests/test_aux.py``'s case); a padded
  length of 1, which the reference's backtrace cannot trace, by hand;
  ``chunk_eval``'s rule where the inferred chunk runs past the label's
  (ROADMAP C7), as the reference counts it.
* ``srl_model`` with SGD, a ``ChunkEvaluator`` and a ``ModelAverage``
  serializes to the reference's bytes (main, startup, apply and restore
  programs) at the full ``SRLDims()`` and at ``tests/test_book.py``'s
  small dims.  Five SGD steps at the small dims from the reference's
  initialized scope give its losses (LOSS_RTOL) and parameters
  (PARAM_ATOL), its Viterbi paths and chunk counts bit for bit, and its
  averaged weights under ``apply``.
* ``Accuracy``, ``ChunkEvaluator``, ``AUC`` and ``DetectionMAP``: the
  reference's ``eval()`` on the same batches, and after ``reset()`` the
  next batch is counted from zero.
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
from paddle_tpu.fluid.core.lod import make_seq as jmake_seq
from paddle_tpu.models import label_semantic_roles as jL
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.models import label_semantic_roles as tL
from tests.test_torch_amp import _emit

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5
SMALL = dict(word_dict_len=30, label_dict_len=5, pred_len=8, hidden_dim=16,
             depth=2)
PACKAGES = {"jax": (jfluid, jL, jmake_seq),
            "port": (tfluid, tL, tfluid.make_seq)}

# (batch, padded length, tags, lengths)
CRF_CASES = {
    "ragged": (5, 7, 6, [7, 1, 4, 3, 7]),
    "length1": (3, 1, 4, [1, 1, 1]),
    "wide": (4, 12, 13, [12, 2, 9, 5]),
}


def _crf_inputs(case, seed=0):
    b, t, k, lens = CRF_CASES[case]
    rng = np.random.RandomState(seed)
    e = rng.randn(b, t, k).astype(np.float32)
    trans = (rng.randn(k + 2, k) * 0.5).astype(np.float32)
    lbl = rng.randint(0, k, (b, t, 1)).astype(np.int32)
    return e, trans, lbl, np.asarray(lens, np.int32)


def _crf_ins(pkg, e, trans, lbl, lens, label_slot=True):
    lod, conv = (jlod, jnp.asarray) if pkg == "jax" else (tlod, torch.tensor)
    e, trans = (conv(a) if isinstance(a, np.ndarray) else a
                for a in (e, trans))
    ins = {"Emission": [lod.SeqArray(e, conv(lens))], "Transition": [trans]}
    if label_slot:
        ins["Label"] = [lod.SeqArray(conv(lbl), conv(lens))]
    return ins


def _run(pkg, op_type, ins, attrs=None):
    reg, Desc = (jreg, JOpDesc) if pkg == "jax" else (treg, TOpDesc)
    return _emit(reg, Desc, op_type, ins, attrs or {})


@pytest.mark.parametrize("case", sorted(CRF_CASES))
def test_linear_chain_crf_matches_reference(case):
    e, trans, lbl, lens = _crf_inputs(case)
    w = np.random.RandomState(1).randn(e.shape[0], 1).astype(np.float32)

    def jloss(e_, t_):
        out = _run("jax", "linear_chain_crf",
                   _crf_ins("jax", e_, t_, lbl, lens))["LogLikelihood"][0]
        return (out * w).sum(), out

    (_, jnll), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                       has_aux=True)(jnp.asarray(e),
                                                     jnp.asarray(trans))
    te = torch.tensor(e, requires_grad=True)
    tt = torch.tensor(trans, requires_grad=True)
    tnll = _run("port", "linear_chain_crf",
                _crf_ins("port", te, tt, lbl, lens))["LogLikelihood"][0]
    assert tnll.shape == jnll.shape == (e.shape[0], 1)
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll),
                               rtol=LOSS_RTOL)
    (tnll * torch.tensor(w)).sum().backward()
    for got, want, name in ((te.grad, jg[0], "emission"),
                            (tt.grad, jg[1], "transition")):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= GRAD_RTOL, (name, err)
    # padding steps take no gradient
    for i, n in enumerate(lens):
        assert not te.grad[i, n:].any()


def _graph_nodes(t):
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def test_linear_chain_crf_backward_has_no_indexed_writes():
    """The gold path's table reads are one-hot products: no node of the
    backward graph scatters by index (``IndexBackward`` would be
    ``index_put_(accumulate=True)``, atomics on the card)."""
    e, trans, lbl, lens = _crf_inputs("ragged")
    te = torch.tensor(e, requires_grad=True)
    tt = torch.tensor(trans, requires_grad=True)
    out = _run("port", "linear_chain_crf",
               _crf_ins("port", te, tt, lbl, lens))["LogLikelihood"][0]
    names = _graph_nodes(out)
    assert names and not [n for n in names if "Index" in n
                          or "Scatter" in n or "Gather" in n], names


# the reference's backtrace cannot trace a padded length of 1 (its scan
# indexes an empty history): "length1" is the port's alone, below
@pytest.mark.parametrize("case", ["ragged", "wide"])
@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_matches_reference_bitwise(case, with_label):
    e, trans, lbl, lens = _crf_inputs(case, seed=2)
    outs = [_run(pkg, "crf_decoding",
                 _crf_ins(pkg, e, trans, lbl, lens, with_label)
                 )["ViterbiPath"][0] for pkg in ("jax", "port")]
    want, got = (np.asarray(o.data) if pkg == "jax" else o.data.numpy()
                 for o, pkg in zip(outs, ("jax", "port")))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs[1].lengths.numpy(), lens)


def test_crf_decoding_of_one_step():
    """A padded length of 1: the path is argmax(start + emission +
    stop), and with Label the mask of where it hits the label."""
    e, trans, lbl, lens = _crf_inputs("length1", seed=2)
    path = _run("port", "crf_decoding", _crf_ins(
        "port", torch.tensor(e), torch.tensor(trans), lbl, lens, False)
    )["ViterbiPath"][0].data.numpy()
    want = (trans[0] + e[:, 0] + trans[1]).argmax(-1)
    np.testing.assert_array_equal(path[:, 0, 0], want)
    hit = _run("port", "crf_decoding", _crf_ins(
        "port", torch.tensor(e), torch.tensor(trans), lbl, lens)
    )["ViterbiPath"][0].data.numpy()
    np.testing.assert_array_equal(hit[:, 0, 0], want == lbl[:, 0, 0])


def test_crf_decoding_is_argmax_without_transitions():
    """tests/test_aux.py's case, through the port's program: zero
    transitions make the Viterbi path each step's argmax."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        emission = tfluid.layers.data(name="e", shape=[4], dtype="float32",
                                      lod_level=1)
        path = tfluid.layers.crf_decoding(
            emission, param_attr=tfluid.ParamAttr(
                name="trans0",
                initializer=tfluid.initializer.Constant(0.0)))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    seqs = [rng.randn(5, 4).astype(np.float32),
            rng.randn(2, 4).astype(np.float32)]
    out, = exe.run(main, feed={"e": tfluid.make_seq(seqs, np.float32)},
                   fetch_list=[path], scope=scope)
    got = np.asarray(out.data).squeeze(-1)
    np.testing.assert_array_equal(got[0, :5], seqs[0].argmax(-1))
    np.testing.assert_array_equal(got[1, :2], seqs[1].argmax(-1))
    assert (got[1, 2:] == 0).all()


def _iob_batch(seed, b=6, t=9, types=3, agree=0.6):
    """Random IOB tags (2 * type for B, 2 * type + 1 for I) and an
    inference that keeps each label tag with probability ``agree``."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, t + 1, b).astype(np.int32)
    lbl = rng.randint(0, 2 * types, (b, t, 1)).astype(np.int32)
    other = rng.randint(0, 2 * types, (b, t, 1)).astype(np.int32)
    inf = np.where(rng.rand(b, t, 1) < agree, lbl, other).astype(np.int32)
    return inf, lbl, lens


@pytest.mark.parametrize("seed,agree", [(0, 0.6), (1, 0.9), (2, 1.0),
                                        (3, 0.0)])
def test_chunk_eval_matches_reference_bitwise(seed, agree):
    inf, lbl, lens = _iob_batch(seed, agree=agree)
    outs = []
    for pkg in ("jax", "port"):
        lod, conv = (jlod, jnp.asarray) if pkg == "jax" \
            else (tlod, torch.tensor)
        outs.append(_run(pkg, "chunk_eval",
                         {"Inference": [lod.SeqArray(conv(inf), conv(lens))],
                          "Label": [lod.SeqArray(conv(lbl), conv(lens))]},
                         {"chunk_scheme": "IOB", "num_chunk_types": 3}))
    for slot in outs[0]:
        want = np.asarray(outs[0][slot][0])
        got = outs[1][slot][0].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, slot
        np.testing.assert_array_equal(got, want, err_msg=slot)
    if agree == 1.0:
        nc, nl = (outs[1][s][0].item() for s in ("NumCorrectChunks",
                                                "NumLabelChunks"))
        assert nc == nl > 0


def test_chunk_eval_ignores_where_the_inferred_chunk_ends():
    """The reference's rule (ROADMAP C7), which the port keeps: label
    [B0 I0 B0] against inference [B0 I0 I0] counts the first label
    chunk correct though the inferred chunk runs a step further."""
    want = {"NumInferChunks": 1.0, "NumLabelChunks": 2.0,
            "NumCorrectChunks": 1.0, "Precision": 1.0, "Recall": 0.5}
    lens = np.array([3], np.int32)
    for pkg in ("jax", "port"):
        lod, conv = (jlod, jnp.asarray) if pkg == "jax" \
            else (tlod, torch.tensor)
        out = _run(pkg, "chunk_eval", {
            "Inference": [lod.SeqArray(conv(np.array([[[0], [1], [1]]],
                                                     np.int32)),
                                       conv(lens))],
            "Label": [lod.SeqArray(conv(np.array([[[0], [1], [0]]],
                                                 np.int32)), conv(lens))]})
        got = {k: float(np.asarray(out[k][0]).reshape(-1)[0]) for k in want}
        assert got == want, (pkg, got)


def build_srl(pkg, dims, lr=0.05, windows=(2, 4)):
    """srl_model + SGD + ChunkEvaluator + ModelAverage -> (main, startup,
    loss, crf_decode, evaluator, model average)."""
    fluid, L, _ = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _, crf_decode, target, _ = L.srl_model(L.SRLDims(**dims))
        fluid.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
        ev = fluid.evaluator.ChunkEvaluator(
            crf_decode, target, "IOB", (dims.get("label_dict_len", 106)
                                        - 1) // 2)
        ma = fluid.optimizer.ModelAverage(0.15, min_average_window=windows[0],
                                          max_average_window=windows[1])
    return main, startup, avg_cost, crf_decode, ev, ma


def srl_feed(make_seq, dims, i, batch=8, bucket=6):
    """Seeded sentences of 1-``bucket`` words, the tags derived from the
    word ids as tests/test_book.py derives them."""
    rng = np.random.RandomState(100 + i)
    lens = rng.randint(1, bucket + 1, batch)
    words = [rng.randint(0, dims["word_dict_len"], n) for n in lens]

    def seq(rows):
        return make_seq(rows, dtype=np.int64, bucket=bucket)

    feed = {"word_data": seq(words),
            "target": seq([w % dims["label_dict_len"] for w in words]),
            "verb_data": seq([w % dims["pred_len"] for w in words]),
            "mark_data": seq([w % 2 for w in words])}
    for n in ("ctx_n2_data", "ctx_n1_data", "ctx_0_data", "ctx_p1_data",
              "ctx_p2_data"):
        feed[n] = seq(words)
    return feed


@pytest.mark.parametrize("dims", ["full", "small"])
def test_srl_programs_match_reference_bytes(dims):
    d = {} if dims == "full" else SMALL
    j, t = build_srl("jax", d), build_srl("port", d)
    for a, b in ((j[0], t[0]), (j[1], t[1]), (j[5]._apply_program,
                                              t[5]._apply_program),
                 (j[5]._restore_program, t[5]._restore_program)):
        assert b.serialize_to_string() == a.serialize_to_string()
    ops = [op.type for op in t[0].global_block().ops]
    assert ops.count("dynamic_lstm") == (8 if dims == "full" else 2)
    for op in ("linear_chain_crf", "crf_decoding", "chunk_eval",
               "average_accumulates", "linear_chain_crf_grad"):
        assert op in ops, op


def _arrays(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.vars
            if scope.find_var(n) is not None}


def test_srl_trains_as_the_reference():
    steps = 5
    jm, js, jl, jd, jev, jma = build_srl("jax", SMALL)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = _arrays(scope)
        want = [exe.run(jm, feed=srl_feed(jmake_seq, SMALL, i),
                        fetch_list=[jl, jd]) for i in range(steps)]
        jcounts = jev.eval()
        after = _arrays(scope)
        with jma.apply(exe):
            javg = _arrays(scope)
    tm, _, tl, td, tev, tma = build_srl("port", SMALL)
    cpu = tfluid.CPUPlace()
    tscope, texe = tfluid.scope_from_numpy(init, cpu), tfluid.Executor(cpu)
    got = [texe.run(tm, feed=srl_feed(tfluid.make_seq, SMALL, i),
                    fetch_list=[tl, td], scope=tscope) for i in range(steps)]
    for i, ((jloss, jpath), (tloss, tpath)) in enumerate(zip(want, got)):
        np.testing.assert_allclose(float(tloss), float(np.asarray(jloss)),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(np.asarray(tpath.data),
                                      np.asarray(jpath.data),
                                      err_msg=f"path {i}")
    for s in ("num_infer", "num_label", "num_correct"):
        name = getattr(tev, s).name
        np.testing.assert_array_equal(
            tfluid.scope_to_numpy(tscope, [name])[name], after[name])
    np.testing.assert_array_equal(tev.eval(scope=tscope), jcounts)
    state = tfluid.scope_to_numpy(tscope, list(init))
    for n in init:
        np.testing.assert_allclose(state[n], after[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    with tfluid.scope_guard(tscope):
        with tma.apply(texe):
            tavg = tfluid.scope_to_numpy(tscope, list(init))
        back = tfluid.scope_to_numpy(tscope, list(init))
    for n in init:
        np.testing.assert_allclose(tavg[n], javg[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        np.testing.assert_array_equal(back[n], state[n], err_msg=n)
    params = [p.name for p in tm.global_block().all_parameters()]
    assert any(not np.array_equal(tavg[n], state[n]) for n in params)


# -- evaluators ---------------------------------------------------------------

def _accuracy(fluid):
    x = fluid.layers.data("x", [5], "float32")
    y = fluid.layers.data("y", [1], "int64")
    return fluid.evaluator.Accuracy(input=fluid.layers.softmax(x), label=y)


def _accuracy_feed(make_seq, i):
    rng = np.random.RandomState(10 + i)
    return {"x": rng.randn(16, 5).astype(np.float32),
            "y": rng.randint(0, 5, (16, 1)).astype(np.int64)}


def _chunk(fluid):
    inf = fluid.layers.data("inf", [1], "int64", lod_level=1)
    lbl = fluid.layers.data("lbl", [1], "int64", lod_level=1)
    return fluid.evaluator.ChunkEvaluator(inf, lbl, "IOB", 3)


def _chunk_feed(make_seq, i):
    inf, lbl, lens = _iob_batch(20 + i, agree=0.7)
    return {"inf": make_seq([r[:n] for r, n in zip(inf, lens)],
                            dtype=np.int64),
            "lbl": make_seq([r[:n] for r, n in zip(lbl, lens)],
                            dtype=np.int64)}


def _auc(fluid):
    x = fluid.layers.data("x", [2], "float32")
    y = fluid.layers.data("y", [1], "int64")
    return fluid.evaluator.AUC(input=fluid.layers.softmax(x), label=y,
                               num_thresholds=50)


def _auc_feed(make_seq, i):
    rng = np.random.RandomState(30 + i)
    y = rng.randint(0, 2, (32, 1)).astype(np.int64)
    x = rng.randn(32, 2).astype(np.float32)
    x[:, 1] += 1.5 * y[:, 0]
    return {"x": x, "y": y}


EVALUATORS = {"Accuracy": (_accuracy, _accuracy_feed),
              "ChunkEvaluator": (_chunk, _chunk_feed),
              "AUC": (_auc, _auc_feed)}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluator_matches_reference(name):
    build, feed_of = EVALUATORS[name]
    res = {}
    for pkg in ("jax", "port"):
        fluid, _, make_seq = PACKAGES[pkg]
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ev = build(fluid)
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            for i in range(3):
                exe.run(main, feed=feed_of(make_seq, i), fetch_list=[])
            total = np.asarray(ev.eval())
            ev.reset()
            exe.run(main, feed=feed_of(make_seq, 3), fetch_list=[])
            after_reset = np.asarray(ev.eval())
            # the last batch alone, in a fresh scope
            fresh = fluid.Scope()
            with fluid.scope_guard(fresh):
                exe.run(startup)
                exe.run(main, feed=feed_of(make_seq, 3), fetch_list=[])
                alone = np.asarray(ev.eval())
        res[pkg] = (main.serialize_to_string(), total, after_reset, alone)
    assert res["port"][0] == res["jax"][0]
    for i in (1, 2, 3):
        np.testing.assert_allclose(res["port"][i], res["jax"][i],
                                   rtol=1e-6)
    np.testing.assert_array_equal(res["port"][2], res["port"][3])
    assert not np.array_equal(res["port"][1], res["port"][2])


def _detections(seed, n_img=6, n_cls=3):
    rng = np.random.RandomState(seed)
    dets, gts = [], []
    for _ in range(n_img):
        g = []
        for _ in range(rng.randint(1, 4)):
            x1, y1 = rng.rand(2) * 0.6
            g.append([rng.randint(n_cls), x1, y1, x1 + 0.3, y1 + 0.3])
        d = []
        for c, x1, y1, x2, y2 in g:
            j = rng.randn(4) * 0.05
            d.append([c, rng.rand(), x1 + j[0], y1 + j[1], x2 + j[2],
                      y2 + j[3]])
        for _ in range(rng.randint(0, 3)):
            x1, y1 = rng.rand(2) * 0.6
            d.append([rng.randint(n_cls), rng.rand(), x1, y1, x1 + 0.2,
                      y1 + 0.2])
        dets.append(d)
        gts.append(g)
    return dets, gts


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_matches_reference(ap_version):
    maps = []
    for fluid in (jfluid, tfluid):
        m = fluid.evaluator.DetectionMAP(0.5, ap_version)
        for seed in (0, 1):
            m.update(*_detections(seed))
        maps.append(float(m.eval()))
        m.reset()
        m.update(*_detections(2))
        maps.append(float(m.eval()))
    assert maps[2:] == maps[:2]
    assert 0.0 < maps[0] <= 1.0
