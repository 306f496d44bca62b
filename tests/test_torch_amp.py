"""The bf16 training recipe (``amp_dtype="bfloat16"``) in the port,
against the JAX package, on the CPU.

The recipe: parameters live in float32, one ``cast`` at each embedding
makes the activations bfloat16, and every op that meets a bf16
activation and an f32 parameter casts the parameter down
(``match_master_dtype``) and sums its products in float32.

* Ops, on the same numpy inputs through both packages' emitters: the
  ``cast`` both ways, ``mul`` and ``elementwise_add`` with a bf16 X over
  an f32 Y, ``layer_norm``, ``dropout``, ``softmax``, ``cross_entropy``
  and ``fused_vocab_cross_entropy`` on bf16 inputs, forward and
  gradients.  Every output and gradient must carry the reference's
  dtype exactly.  Both sides round the same float32 sums to bf16, but
  in a different summation order, so a value near a rounding boundary
  lands one bf16 ulp (2^-8 relative) apart: BF16_TOL is 2 ulps of a
  value of magnitude ~1.
* The program: ``transformer(amp_dtype="bfloat16")`` with Adam builds
  the same bytes in both packages; after one step every variable of the
  block has exactly the reference's runtime dtype; 3 Adam steps from a
  copied JAX scope track the reference (see LOSS_RTOL, GRAD_L2 and
  NOISE_RATIO for the tolerances and the gaps measured), and a bf16
  feed crosses into the executor.
* The reference's own trajectory check (``tests/test_fused_transformer.py``
  ``test_amp_bfloat16_activations_train``): 4 SGD steps of the amp
  program stay within 8% of the float32 program's, and converge.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
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
from paddle_tpu_torch.models import transformer as TT

BF16 = ml_dtypes.bfloat16
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# float32 results (a loss, an f32 master gradient) computed from bf16
# operands: the summation order moves them by about one float32 ulp of
# each partial sum
F32_OF_BF16_TOL = dict(rtol=1e-4, atol=1e-5)
# programs, 3 Adam steps of the small amp Transformer (batch 4 x 16).
# Rounding the activations and their gradients to bf16 moves the master
# gradients from the float32 program's by 3.8% (median over parameters,
# relative L2; up to 11%) in the reference itself: the backward's
# layer-norm and softmax subtractions cancel most of each value, and a
# relu whose input lands within a bf16 ulp of 0 may switch.  Two
# implementations round in different places, so their bf16 gradients
# differ by about sqrt(2) times that (measured on the CPU: median 5.3%,
# up to 16.8%; the largest single element up to 50% of its gradient's
# largest, where a relu switched).  The loss, a mean over 64 tokens,
# moves by at most 2.9e-4 relative.
LOSS_RTOL, GRAD_L2, NOISE_RATIO = 1e-2, 0.25, 1.25


def _emit(reg, Desc, op_type, ins, attrs, **ctx_kw):
    desc = Desc(op_type, {s: [f"{s}{i}" for i in range(len(v))]
                          for s, v in ins.items()}, {}, attrs)
    return reg.get_op_info(op_type).emit(reg.EmitCtx(desc, **ctx_kw), ins)


def _jax_in(a):
    return jnp.asarray(a)


def _port_in(a):
    if a.dtype == BF16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _np(t):
    """A port tensor as numpy in its own dtype (bf16 via ml_dtypes)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(BF16)
    return t.numpy()


def _both(op_type, arrays, attrs, out_slot="Out", wrt=(), seed_key=0):
    """Both emitters on ``arrays`` ({slot: ndarray, bf16 as ml_dtypes});
    grads of sum(out * w) for a seeded f32 ``w`` w.r.t. the slots in
    ``wrt``.  Returns (jax outs, port outs, jax grads, port grads), the
    port's as numpy in their own dtypes."""
    j_ins = {s: [_jax_in(a)] for s, a in arrays.items()}
    t_ins = {s: [_port_in(a)] for s, a in arrays.items()}
    key = jax.random.key(seed_key)
    seed = int(jax.random.bits(key, (), jnp.uint32))
    for s in wrt:
        t_ins[s][0].requires_grad_(True)
    j_outs = _emit(jreg, JOpDesc, op_type, j_ins, attrs, rng=key)
    t_outs = _emit(treg, TOpDesc, op_type, t_ins, attrs, seed=seed)
    jg, tg = [], []
    if wrt:
        w = np.random.RandomState(4).randn(
            *np.shape(j_outs[out_slot][0])).astype(np.float32)

        def f(*xs):
            ins = dict(j_ins)
            ins.update({s: [x] for s, x in zip(wrt, xs)})
            out = _emit(jreg, JOpDesc, op_type, ins, attrs, rng=key)
            return (out[out_slot][0].astype(jnp.float32) * w).sum()

        jg = list(jax.grad(f, argnums=tuple(range(len(wrt))))(
            *[j_ins[s][0] for s in wrt]))
        (t_outs[out_slot][0].float() * torch.tensor(w)).sum().backward()
        tg = [_np(t_ins[s][0].grad) for s in wrt]
    t_outs = {s: [_np(v) for v in vals] for s, vals in t_outs.items()}
    return j_outs, t_outs, jg, tg


def _close(got, want, tol):
    """Same shape and dtype exactly, then values within ``tol``."""
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **tol)


def _rand(rng, *shape, scale=1.0, dtype=np.float32):
    return (rng.randn(*shape) * scale).astype(dtype)


@pytest.mark.parametrize("src,dst", [("float32", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_cast_and_its_gradient(src, dst):
    x = _rand(np.random.RandomState(0), 4, 9, dtype=np.dtype(
        BF16 if src == "bfloat16" else np.float32))
    jo, to, jg, tg = _both("cast", {"X": x},
                           {"in_dtype": src, "out_dtype": dst}, "Out",
                           wrt=("X",))
    _close(to["Out"][0], jo["Out"][0], dict(rtol=0, atol=0))
    # the cotangent goes back in X's dtype
    _close(tg[0], jg[0], BF16_TOL)


def test_mul_casts_the_master_weight_down():
    """bf16 X [3, 5, 16] over f32 W [16, 12]: out bf16, dX bf16, dW f32."""
    rng = np.random.RandomState(1)
    x = _rand(rng, 3, 5, 16, dtype=BF16)
    w = _rand(rng, 16, 12, scale=0.3)
    jo, to, jg, tg = _both("mul", {"X": x, "Y": w},
                           {"x_num_col_dims": 2, "y_num_col_dims": 1},
                           "Out", wrt=("X", "Y"))
    _close(to["Out"][0], jo["Out"][0], BF16_TOL)
    _close(tg[0], jg[0], BF16_TOL)
    assert tg[1].dtype == np.float32
    # dW sums 15 bf16 products rounded to bf16 on both sides
    _close(tg[1], jg[1], dict(rtol=2 ** -7, atol=2 ** -7 * 8))


def test_elementwise_add_keeps_the_activation_dtype():
    rng = np.random.RandomState(2)
    x = _rand(rng, 3, 5, 8, dtype=BF16)
    b = _rand(rng, 8)
    jo, to, jg, tg = _both("elementwise_add", {"X": x, "Y": b},
                           {"axis": 2}, "Out", wrt=("X", "Y"))
    _close(to["Out"][0], jo["Out"][0], BF16_TOL)
    _close(tg[0], jg[0], BF16_TOL)
    _close(tg[1], jg[1], dict(rtol=2 ** -7, atol=2 ** -7 * 4))


def test_layer_norm_on_bf16():
    rng = np.random.RandomState(3)
    x = _rand(rng, 3, 5, 16, scale=2, dtype=BF16)
    arrays = {"X": x, "Scale": _rand(rng, 16), "Bias": _rand(rng, 16)}
    jo, to, jg, tg = _both("layer_norm", arrays,
                           {"epsilon": 1e-5, "begin_norm_axis": 2}, "Y",
                           wrt=("X", "Scale", "Bias"))
    _close(to["Y"][0], jo["Y"][0], BF16_TOL)
    for slot in ("Mean", "Variance"):
        _close(to[slot][0], jo[slot][0], F32_OF_BF16_TOL)
    _close(tg[0], jg[0], dict(rtol=2 ** -6, atol=2 ** -6))
    for g, want in zip(tg[1:], jg[1:]):
        _close(g, want, F32_OF_BF16_TOL)


def test_dropout_on_bf16_has_the_references_mask():
    x = _rand(np.random.RandomState(4), 4, 7, 16, dtype=BF16)
    jo, to, jg, tg = _both("dropout", {"X": x}, {"dropout_prob": 0.1},
                           "Out", wrt=("X",), seed_key=3)
    _close(to["Mask"][0], jo["Mask"][0], dict(rtol=0, atol=0))
    _close(to["Out"][0], jo["Out"][0], dict(rtol=0, atol=0))
    _close(tg[0], jg[0], dict(rtol=0, atol=0))


def test_softmax_and_cross_entropy_on_bf16():
    rng = np.random.RandomState(5)
    x = _rand(rng, 6, 10, scale=2, dtype=BF16)
    jo, to, jg, tg = _both("softmax", {"X": x}, {}, "Out", wrt=("X",))
    _close(to["Out"][0], jo["Out"][0], BF16_TOL)
    _close(tg[0], jg[0], BF16_TOL)
    p = np.asarray(jo["Out"][0])
    label = rng.randint(0, 10, (6, 1)).astype(np.int32)
    jo, to, jg, tg = _both("cross_entropy", {"X": p, "Label": label},
                           {"soft_label": False}, "Out", wrt=("X",))
    _close(to["Out"][0], jo["Out"][0], BF16_TOL)
    _close(tg[0], jg[0], dict(rtol=2 ** -7, atol=0))


@pytest.mark.parametrize("chunk", [8192, 7])
def test_fused_vocab_cross_entropy_on_bf16(chunk):
    """bf16 X, f32 W: the logits are f32 sums of bf16 products, the loss
    f32, dX bf16 and dW f32 (one chunk, and a ragged last chunk)."""
    rng = np.random.RandomState(6)
    x = _rand(rng, 3, 5, 16, dtype=BF16)
    w = _rand(rng, 16, 50, scale=0.3)
    label = rng.randint(0, 50, (3, 5, 1)).astype(np.int32)
    jo, to, jg, tg = _both("fused_vocab_cross_entropy",
                           {"X": x, "W": w, "Label": label},
                           {"chunk": chunk}, "Loss", wrt=("X", "W"))
    _close(to["Loss"][0], jo["Loss"][0], F32_OF_BF16_TOL)
    _close(tg[0], jg[0], BF16_TOL)
    # dW: f32 sums over 15 rows of bf16-rounded logit gradients
    _close(tg[1], jg[1], dict(rtol=2 ** -7, atol=2 ** -7 * 4))


# -- the program --------------------------------------------------------------

V, S, NL, NH, DM = 64, 16, 2, 2, 16


def build(fluid, T, amp="bfloat16", opt="adam", prefix="tf", **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _, _ = T.transformer(
            V, V, 2 * S, n_layer=NL, n_head=NH, d_key=DM // NH,
            d_value=DM // NH, d_model=DM, d_inner_hid=2 * DM,
            dropout_rate=0.0, src_seq_len=S, trg_seq_len=S, fused=True,
            materialize_attn_bias=False, fused_vocab_loss=True,
            amp_dtype=amp, param_prefix=prefix, **kw)
        if opt == "adam":
            fluid.optimizer.Adam(1e-3).minimize(avg_cost)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def feed_data(batch=4):
    rng = np.random.RandomState(0)
    return {"src_word": rng.randint(0, V, (batch, S)),
            "src_pos": np.tile(np.arange(S), (batch, 1)),
            "trg_word": rng.randint(0, V, (batch, S)),
            "trg_pos": np.tile(np.arange(S), (batch, 1)),
            "lbl_word": rng.randint(0, V, (batch, S)),
            "lbl_weight": np.ones((batch, S), np.float32)}


@pytest.mark.parametrize("prefix", ["tf", None], ids=["named", "auto"])
def test_amp_program_bytes_match_reference(prefix):
    jm, js, _ = build(jfluid, JT, prefix=prefix)
    tm, ts, _ = build(tfluid, TT, prefix=prefix)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm.desc.fingerprint() == jm.desc.fingerprint()
    # the recipe: one cast per embedding, parameters f32, activations bf16
    block = tm.global_block()
    assert [op.type for op in block.ops].count("cast") == 2
    params = block.all_parameters()
    assert {p.dtype for p in params} == {"float32"}
    assert {block.var(p.name + "@GRAD").dtype for p in params} \
        == {"float32"}


def _jax_init(main, startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.find_var(n)) for n in scope.vars
                   if scope.find_var(n) is not None}


def test_one_amp_step_gives_every_variable_the_references_dtype():
    """Every variable one step writes (activations, gradients, parameters,
    accumulators), fetched at once, in the reference's runtime dtype."""
    jm, js, _ = build(jfluid, JT)
    tm, _, _ = build(tfluid, TT)
    feed = feed_data(2)
    names = sorted(n for n, v in jm.desc.global_block().vars.items()
                   if n not in feed and "@GRAD@ZERO" not in n)
    jscope, init = _jax_init(jm, js)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            jm, feed=feed, fetch_list=names)
    cpu = tfluid.CPUPlace()
    got = tfluid.Executor(cpu).run(tm, feed=feed, fetch_list=names,
                                   scope=tfluid.scope_from_numpy(init, cpu),
                                   return_numpy=False)
    bad = {n: (str(g.dtype), str(np.asarray(w).dtype))
           for n, g, w in zip(names, got, want)
           if str(g.dtype).removeprefix("torch.") != str(np.asarray(w).dtype)}
    assert not bad, bad
    dtypes = {str(g.dtype) for g in got}
    assert {"torch.bfloat16", "torch.float32"} <= dtypes


def _rel_l2(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_three_amp_adam_steps_track_reference():
    """3 Adam steps from one copied scope.  The loss within LOSS_RTOL a
    step; every f32 master gradient, a step, within GRAD_L2 of the
    reference's in relative L2 norm; and at the first step the port's
    bf16 gradients no farther from the float32 program's gradients (the
    reference's, same scope) than the reference's bf16 gradients are,
    within NOISE_RATIO, in the median over parameters."""
    jm, js, jloss = build(jfluid, JT)
    jf32, _, jloss32 = build(jfluid, JT, amp=None)
    tm, _, _ = build(tfluid, TT)
    feed = feed_data()
    params = sorted(p.name for p in tm.global_block().all_parameters())
    grads = [p + "@GRAD" for p in params]
    jscope, init = _jax_init(jm, js)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    f32_scope = jfluid.Scope()
    for name, value in init.items():
        f32_scope.set_var(name, jnp.asarray(value))
    with jfluid.scope_guard(f32_scope):
        f32_grads = jexe.run(jf32, feed=feed, fetch_list=grads)
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    losses = []
    for step in range(3):
        with jfluid.scope_guard(jscope):
            want = jexe.run(jm, feed=feed, fetch_list=[jloss] + grads)
        got = texe.run(tm, feed=feed, fetch_list=[jloss.name] + grads,
                       scope=tscope)
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
        losses.append(float(got[0]))
        for name, g, w in zip(params, got[1:], want[1:]):
            assert g.dtype == np.asarray(w).dtype == np.float32, name
            assert _rel_l2(g, w) <= GRAD_L2, (step, name, _rel_l2(g, w))
        if step == 0:
            port = np.median([_rel_l2(g, f) for g, f in
                              zip(got[1:], f32_grads)])
            ref = np.median([_rel_l2(w, f) for w, f in
                             zip(want[1:], f32_grads)])
            assert port <= NOISE_RATIO * ref, (port, ref)
    assert losses[-1] < losses[0]


def test_bf16_feed_reaches_the_executor_as_bf16():
    """An ``ml_dtypes`` bfloat16 feed crosses by its bits; a bf16 fetch
    comes back as the reference returns it, an ``ml_dtypes`` bfloat16
    array of the same bits (float32 of the same values only where
    ``ml_dtypes`` does not import)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [5], "bfloat16")
        y = tfluid.layers.scale(x, scale=2.0)
    xv = _rand(np.random.RandomState(7), 3, 5, dtype=BF16)
    exe = tfluid.Executor(tfluid.CPUPlace())
    out, = exe.run(main, feed={"x": xv}, fetch_list=[y],
                   scope=tfluid.Scope(), return_numpy=False)
    assert out.dtype == torch.bfloat16
    got, = exe.run(main, feed={"x": xv}, fetch_list=[y],
                   scope=tfluid.Scope())
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.view(np.int16),
                                  (2 * xv.astype(np.float32)).astype(BF16)
                                  .view(np.int16))


def test_amp_sgd_trajectory_stays_near_float32():
    """The reference's check, in the port: from the port's own seeded
    startup, 4 SGD(0.1) steps of the amp program within 8% of the f32
    program's losses, the amp loss falling; the master weights stay
    f32."""
    feed = feed_data()
    runs = {}
    for amp in (None, "bfloat16"):
        main, startup, loss = build(tfluid, TT, amp=amp, opt="sgd")
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        runs[amp] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0]) for _ in range(4)]
        assert scope.find_var("tf.vocab_proj.w").dtype == torch.float32
    got, ref = runs["bfloat16"], runs[None]
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, ref, rtol=0.08)
