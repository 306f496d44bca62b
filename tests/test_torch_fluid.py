"""The port's Fluid front end against the JAX package, on the CPU.

* The op emitters the Transformer training step runs (``layer_norm``,
  ``dropout``, ``lookup_table`` and its grad, ``softmax_with_cross_entropy``,
  ``fused_vocab_cross_entropy`` and ``adam``) on the same numpy inputs:
  outputs, and gradients through ``jax.vjp`` against autograd.  Both
  sides compute in float32 and differ in summation order only: 1e-5 on
  outputs of magnitude ~1, 1e-4 on gradients that sum up to 64 terms.
  Dropout masks are compared exactly, from the same uint32 seed.
* ``transformer()`` built by both packages, before and after
  ``Adam.minimize``, serializes to the same bytes (main and startup).
* The executor's plan: dead code is dropped, and every op whose grad op
  has no emitter of its own keeps its autograd graph for that grad op.
* What the slice does not port raises ``NotImplementedError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.lowering import BlockPlan
from paddle_tpu_torch.models import transformer as TT

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _emit_jax(op_type, ins, attrs, key=0):
    desc = JOpDesc(op_type, {s: [f"{s}{i}" for i in range(len(v))]
                             for s, v in ins.items()}, {}, attrs)
    ctx = jreg.EmitCtx(desc, rng=jax.random.key(key))
    return jreg.get_op_info(op_type).emit(ctx, ins)


def _emit_port(op_type, ins, attrs, seed=None):
    desc = TOpDesc(op_type, {s: [f"{s}{i}" for i in range(len(v))]
                             for s, v in ins.items()}, {}, attrs)
    ctx = treg.EmitCtx(desc, seed=seed)
    return treg.get_op_info(op_type).emit(ctx, ins)


def _both(op_type, arrays, attrs, out_slot, wrt=(), seed_key=0):
    """Run the JAX and the port emitter on the same arrays
    (``{slot: ndarray}``); returns ``(jax_outs, port_outs, jax_grads,
    port_grads)`` where the grads are of ``sum(out_slot * w)`` for a
    seeded random ``w``, with respect to the slots in ``wrt``."""
    j_ins = {s: [jnp.asarray(a)] for s, a in arrays.items()}
    t_ins = {s: [torch.tensor(a)] for s, a in arrays.items()}
    j_outs = _emit_jax(op_type, j_ins, attrs, seed_key)
    seed = int(jax.random.bits(jax.random.key(seed_key), (), jnp.uint32))
    for s in wrt:
        t_ins[s][0].requires_grad_(True)
    t_outs = _emit_port(op_type, t_ins, attrs, seed)
    if not wrt:
        return j_outs, t_outs, [], []
    w = np.random.RandomState(4).randn(
        *np.shape(j_outs[out_slot][0])).astype(np.float32)

    def f(*xs):
        ins = dict(j_ins)
        ins.update({s: [x] for s, x in zip(wrt, xs)})
        return (_emit_jax(op_type, ins, attrs, seed_key)[out_slot][0]
                * w).sum()

    j_grads = jax.grad(f, argnums=tuple(range(len(wrt))))(
        *[j_ins[s][0] for s in wrt])
    (t_outs[out_slot][0] * torch.tensor(w)).sum().backward()
    return j_outs, t_outs, list(j_grads), [t_ins[s][0].grad for s in wrt]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("axis", [1, 2])
def test_layer_norm_matches_reference(axis):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 16).astype(np.float32) * 2 + 1
    n = 16 if axis == 2 else 80
    arrays = {"X": x, "Scale": rng.randn(n).astype(np.float32),
              "Bias": rng.randn(n).astype(np.float32)}
    jo, to, jg, tg = _both("layer_norm", arrays,
                           {"epsilon": 1e-5, "begin_norm_axis": axis}, "Y",
                           wrt=("X", "Scale", "Bias"))
    for slot in ("Y", "Mean", "Variance"):
        _close(to[slot][0], jo[slot][0], OUT_TOL)
    for g, w in zip(tg, jg):
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("axis", [1, 2])
def test_layer_norm_without_grad_matches_reference(axis):
    """Under ``no_grad`` (how serving runs a step) the emitter takes its
    fused route: Y, Mean and Variance as the reference's, in float32 and
    for a bf16 input."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 5, 16).astype(np.float32) * 2 + 1
    n = 16 if axis == 2 else 80
    arrays = {"X": x, "Scale": rng.randn(n).astype(np.float32),
              "Bias": rng.randn(n).astype(np.float32)}
    attrs = {"epsilon": 1e-5, "begin_norm_axis": axis}
    jo = _emit_jax("layer_norm", {k: [jnp.asarray(v)]
                                  for k, v in arrays.items()}, attrs)
    ins = {k: [torch.from_numpy(v)] for k, v in arrays.items()}
    with torch.no_grad():
        to = _emit_port("layer_norm", ins, attrs)
        ins["X"] = [ins["X"][0].to(torch.bfloat16)]
        tb = _emit_port("layer_norm", ins, attrs)
    for slot in ("Y", "Mean", "Variance"):
        _close(to[slot][0], jo[slot][0], OUT_TOL)
    assert tb["Y"][0].dtype == torch.bfloat16
    np.testing.assert_allclose(tb["Y"][0].float().numpy(),
                               np.asarray(jo["Y"][0]), rtol=2 ** -6,
                               atol=2 ** -6)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_mask_is_the_references(p):
    """Same uint32 seed (the JAX op draws it from its key), same mask."""
    x = np.random.RandomState(1).randn(4, 7, 16).astype(np.float32)
    jo, to, jg, tg = _both("dropout", {"X": x}, {"dropout_prob": p}, "Out",
                           wrt=("X",), seed_key=3)
    np.testing.assert_array_equal(to["Mask"][0].numpy(),
                                  np.asarray(jo["Mask"][0]))
    _close(to["Out"][0], jo["Out"][0], OUT_TOL)
    _close(tg[0], jg[0], OUT_TOL)
    assert 0 < (to["Mask"][0] == 0).float().mean() < 1
    # off in inference and for p = 0: the identity
    for attrs in ({"dropout_prob": p, "is_test": True},
                  {"dropout_prob": 0.0}):
        out = _emit_port("dropout", {"X": [torch.tensor(x)]}, attrs, 5)
        np.testing.assert_array_equal(out["Out"][0].numpy(), x)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table_and_its_grad_match_reference(padding_idx):
    rng = np.random.RandomState(2)
    w = rng.randn(10, 8).astype(np.float32)
    ids = rng.randint(0, 10, (4, 6, 1)).astype(np.int32)
    ids[0, :3] = 3                              # repeats, and the pad row
    attrs = {"is_sparse": False}
    if padding_idx is not None:
        attrs["padding_idx"] = padding_idx
    jo, to, _, _ = _both("lookup_table", {"W": w, "Ids": ids}, attrs, "Out")
    _close(to["Out"][0], jo["Out"][0], OUT_TOL)
    og = rng.randn(4, 6, 8).astype(np.float32)
    ins = {"W": w, "Ids": ids, "Out@GRAD": og}
    jg = _emit_jax("lookup_table_grad",
                   {s: [jnp.asarray(a)] for s, a in ins.items()}, attrs)
    tg = _emit_port("lookup_table_grad",
                    {s: [torch.tensor(a)] for s, a in ins.items()}, attrs)
    _close(tg["W@GRAD"][0], jg["W@GRAD"][0], GRAD_TOL)


def test_softmax_with_cross_entropy_matches_reference():
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 5, 11).astype(np.float32) * 3
    label = rng.randint(0, 11, (3, 5, 1)).astype(np.int32)
    jo, to, jg, tg = _both("softmax_with_cross_entropy",
                           {"Logits": logits, "Label": label},
                           {"soft_label": False}, "Loss", wrt=("Logits",))
    for slot in ("Softmax", "Loss"):
        _close(to[slot][0], jo[slot][0], OUT_TOL)
    _close(tg[0], jg[0], GRAD_TOL)


@pytest.mark.parametrize("chunk", [8192, 16, 7])
def test_fused_vocab_cross_entropy_matches_reference(chunk):
    """One chunk, even chunks, and a ragged last chunk (V = 50)."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 16).astype(np.float32)
    w = (rng.randn(16, 50) * 0.3).astype(np.float32)
    label = rng.randint(0, 50, (3, 5, 1)).astype(np.int32)
    jo, to, jg, tg = _both("fused_vocab_cross_entropy",
                           {"X": x, "W": w, "Label": label},
                           {"chunk": chunk}, "Loss", wrt=("X", "W"))
    _close(to["Loss"][0], jo["Loss"][0], OUT_TOL)
    for g, want in zip(tg, jg):
        _close(g, want, GRAD_TOL)


def test_adam_matches_reference_and_updates_in_place():
    rng = np.random.RandomState(5)
    arrays = {"Param": rng.randn(6, 4).astype(np.float32),
              "Grad": rng.randn(6, 4).astype(np.float32),
              "LearningRate": np.array([1e-3], np.float32),
              "Moment1": rng.randn(6, 4).astype(np.float32) * 0.1,
              "Moment2": rng.rand(6, 4).astype(np.float32) * 0.1,
              "Beta1Pow": np.array([0.9 ** 3], np.float32),
              "Beta2Pow": np.array([0.999 ** 3], np.float32)}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    jo, to, _, _ = _both("adam", arrays, attrs, "ParamOut")
    for slot in ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                 "Beta2PowOut"):
        _close(to[slot][0], jo[slot][0], OUT_TOL)
    # the port writes the state through: outputs are the input tensors
    t_ins = {s: [torch.tensor(a)] for s, a in arrays.items()}
    out = _emit_port("adam", t_ins, attrs)
    assert out["ParamOut"][0] is t_ins["Param"][0]
    assert out["Moment2Out"][0] is t_ins["Moment2"][0]


# -- programs ---------------------------------------------------------------

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, max_length=32, n_layer=2,
             n_head=2, d_key=8, d_value=8, d_model=16, d_inner_hid=32,
             dropout_rate=0.1, src_seq_len=16, trg_seq_len=16, fused=True)


def build(fluid, T, minimize=True, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, predict, feeds = T.transformer(**dict(SMALL, **kw))
        if minimize:
            fluid.optimizer.Adam(1e-3).minimize(avg_cost)
    return main, startup, avg_cost, predict


@pytest.mark.parametrize("minimize", [False, True])
@pytest.mark.parametrize("materialize_attn_bias", [True, False])
@pytest.mark.parametrize("fused_vocab_loss", [True, False])
def test_transformer_program_bytes_match_reference(
        minimize, materialize_attn_bias, fused_vocab_loss):
    kw = dict(minimize=minimize, materialize_attn_bias=materialize_attn_bias,
              fused_vocab_loss=fused_vocab_loss, param_prefix="tf")
    jm, js, _, _ = build(jfluid, JT, **kw)
    tm, ts, _, _ = build(tfluid, TT, **kw)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm.desc.fingerprint() == jm.desc.fingerprint()


def test_auto_named_program_bytes_match_reference():
    """Without param_prefix every name comes from the unique_name
    counters, which must advance alike in both packages."""
    jm, js, _, _ = build(jfluid, JT, materialize_attn_bias=False)
    tm, ts, _, _ = build(tfluid, TT, materialize_attn_bias=False)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()


@pytest.mark.parametrize("fused_vocab_loss", [True, False])
def test_plan_drops_dead_ops_and_tapes_each_forward_once(fused_vocab_loss):
    main, _, avg_cost, predict = build(
        tfluid, TT, materialize_attn_bias=False,
        fused_vocab_loss=fused_vocab_loss)
    block = main.desc.global_block()
    feeds = ["src_word", "src_pos", "trg_word", "trg_pos", "lbl_word",
             "lbl_weight"]
    plan = BlockPlan(block, feeds, [avg_cost.name])
    types = [op.type for op in plan.ops]
    # 2 encoder + 2x2 decoder attentions, each with one grad op that
    # consumes its forward's graph (the forward kernel runs once)
    assert types.count("fused_attention") == 6
    assert types.count("fused_attention_grad") == 6
    fa = [i for i, op in enumerate(plan.ops) if op.type == "fused_attention"]
    assert sorted(plan.grad_of.values()) == sorted(plan.tape)
    assert set(fa) <= set(plan.tape)
    # lookup_table_grad has an emitter of its own: nothing is taped for it
    lt = [i for i, op in enumerate(plan.ops) if op.type == "lookup_table"]
    assert not set(lt) & set(plan.tape)
    # the inference head's [b, t, V] projection is computed only when the
    # loss needs it
    assert (predict.op.desc in plan.ops) == (not fused_vocab_loss)
    # every parameter and accumulator goes back to the scope; the learning
    # rate is only read
    persistable = {n for n, v in block.vars.items() if v.persistable}
    assert persistable - set(plan.state_out) == {"learning_rate_0"}
    assert "learning_rate_0" in plan.state_in


def test_unported_features_raise():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4], "float32")
        ids = tfluid.layers.data("ids", [4], "int64")
        # level-1 sequences are ported; level-2 (NestedSeqArray) is not
        with pytest.raises(NotImplementedError, match="lod_level"):
            tfluid.layers.data("s", [4], "int64", lod_level=2)
        with pytest.raises(NotImplementedError, match="is_sparse"):
            tfluid.layers.embedding(ids, [8, 4], is_sparse=True)
        with pytest.raises(NotImplementedError, match="seq_parallel"):
            tfluid.layers.fused_attention(x, x, x, seq_parallel=True)
        with pytest.raises(NotImplementedError, match="Adagrad"):
            tfluid.optimizer.Adagrad(0.1)
        with pytest.raises(NotImplementedError, match="regulariz"):
            tfluid.optimizer.Adam(0.1, regularization=object())
        # batch_norm is ported (tests/test_torch_image.py holds the bytes)
        img = tfluid.layers.data("img", [3, 8, 8], "float32")
        out = tfluid.nets.img_conv_group(img, [4, 4], pool_size=2,
                                         conv_with_batchnorm=True)
        assert out.shape == (-1, 4, 7, 7)
    for kw, what in ((dict(mp_shard=True), "mp_shard"),
                     (dict(seq_parallel=True), "seq_parallel")):
        with pytest.raises(NotImplementedError, match=what):
            build(tfluid, TT, minimize=False, **kw)
    # the unfused attention is ported; as in the reference, it masks
    # causally only through a bias
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        q = tfluid.layers.data("q", [4, 8], "float32")
        with pytest.raises(NotImplementedError, match="fused=True"):
            TT.multi_head_attention(q, q, q, None, 4, 4, 8, n_head=2,
                                    causal=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="cost_analysis"):
        exe.cost_analysis()
    # run_steps and run_pipeline are ported (tests/test_torch_executor.py);
    # the pipeline's guardrails are not
    with pytest.raises(NotImplementedError, match="guard"):
        exe.run_pipeline(main, loader=[], guard="raise")
    with pytest.raises(NotImplementedError, match="validate"):
        exe.run(main, validate=True)
