"""The optimizer front end and the ops it and the new chapters emit, in
the port, against the JAX package on the CPU.

* Every dense update op (``adagrad``, ``adamax``, ``decayed_adagrad``,
  ``adadelta``, ``rmsprop`` with and without momentum, ``ftrl``,
  ``proximal_gd`` / ``proximal_adagrad`` with and without l1) through
  both emitters on the same seeded arrays: every output within the
  book's OUT_TOL, the state updated in place.
* Every activation op, forward and the gradient of sum(out * w), on
  seeded values with exact 0s and the clip bounds among them (where
  ``abs``, ``leaky_relu`` and the clips have their reference slopes):
  OUT_TOL / GRAD_TOL (float32, summation order and libm only); the six
  whose float attrs meet X also on bf16 X, the attrs rounded to bf16 as
  the reference's weak typing rounds them (BF16_ACTIVATIONS).  The
  math and loss ops the clips, regularizers, schedules and models emit
  (``square``, ``clip``, ``sign``, ``clip_by_norm``, ``norm``,
  ``squared_l2_norm``, ``cos_sim``, ``elementwise_max / min / pow``,
  ``sigmoid_cross_entropy_with_logits``, ``log_softmax``,
  ``sequence_softmax``, ``sequence_conv``) the same way; ``scale`` on a
  bf16 tensor bit for bit (ROADMAP C5).
* The front end: for every optimizer but ModelAverage, and for
  regularizers (L2 on the optimizer, L1 on a parameter), gradient clips
  (by value, by norm, by global norm), an error clip and ``global_step``
  with each decay schedule, the program serializes to the reference's
  bytes and 4 steps from the reference's initialized scope give its
  losses (LOSS_RTOL) and state (PARAM_ATOL).  Each schedule's rate over
  10 steps (OUT_TOL).  A regularizer on a sparse gradient warns and is
  skipped, a clip on one raises the reference's "sparse-grad" error, and
  ``append_backward``'s callbacks see every op it appends.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import lod as jlod
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from tests.test_torch_amp import BF16, _both, _close, _emit
from tests.test_torch_book import EXACT, GRAD_TOL, OUT_TOL

# float32 on both sides, summed in another order: the losses of 4 steps
# and the state after them.  The normalised updates (the Adagrad family,
# Adam) move an element by about lr whatever its gradient's size, so a
# rounding difference in a small gradient moves the parameter by a few
# float32 ulps of lr (measured: 2.4e-6 at most, DecayedAdagrad)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


# -- update ops ---------------------------------------------------------------

UPDATE_OPS = {
    "adagrad": (dict(epsilon=1e-6), ["Moment"], ["MomentOut"], True),
    "adamax": (dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
               ["Moment", "InfNorm", "Beta1Pow"],
               ["MomentOut", "InfNormOut"], True),
    "decayed_adagrad": (dict(decay=0.95, epsilon=1e-6), ["Moment"],
                        ["MomentOut"], True),
    "adadelta": (dict(rho=0.95, epsilon=1e-6),
                 ["AvgSquaredGrad", "AvgSquaredUpdate"],
                 ["AvgSquaredGradOut", "AvgSquaredUpdateOut"], False),
    "rmsprop": (dict(decay=0.9, epsilon=1e-10, momentum=0.0),
                ["Moment", "MeanSquare"], ["MomentOut", "MeanSquareOut"],
                True),
    "rmsprop_momentum": (dict(decay=0.9, epsilon=1e-10, momentum=0.5),
                         ["Moment", "MeanSquare"],
                         ["MomentOut", "MeanSquareOut"], True),
    "ftrl": (dict(l1=0.01, l2=0.02, lr_power=-0.5),
             ["SquaredAccumulator", "LinearAccumulator"],
             ["SquaredAccumOut", "LinearAccumOut"], True),
    "proximal_gd": (dict(l1=0.0, l2=0.01), [], [], True),
    "proximal_gd_l1": (dict(l1=0.05, l2=0.01), [], [], True),
    "proximal_adagrad": (dict(l1=0.05, l2=0.01), ["Moment"], ["MomentOut"],
                         True),
}


@pytest.mark.parametrize("name", sorted(UPDATE_OPS))
def test_dense_update_op_matches_reference(name):
    op = name.replace("_momentum", "").replace("_l1", "")
    attrs, state, outs, has_lr = UPDATE_OPS[name]
    rng = np.random.RandomState(sorted(UPDATE_OPS).index(name))
    arrays = {"Param": rng.randn(6, 5).astype(np.float32),
              "Grad": rng.randn(6, 5).astype(np.float32)}
    if has_lr:
        arrays["LearningRate"] = np.array([0.05], np.float32)
    for s in state:
        arrays[s] = (np.array([0.9 ** 3], np.float32) if s == "Beta1Pow"
                     else np.abs(rng.randn(6, 5)).astype(np.float32)
                     + (0.1 if s != "LinearAccumulator" else -0.5))
    t_ins = {s: [torch.tensor(a)] for s, a in arrays.items()}
    j_out = _emit(jreg, JOpDesc, op, {s: [jnp.asarray(a)]
                                      for s, a in arrays.items()}, attrs)
    t_out = _emit(treg, TOpDesc, op, t_ins, attrs)
    for s, o in zip(["Param"] + [s for s in state if s != "Beta1Pow"],
                    ["ParamOut"] + outs):
        _close(t_out[o][0].numpy(), j_out[o][0], OUT_TOL)
        assert t_out[o][0] is t_ins[s][0], o
    assert not np.array_equal(t_out["ParamOut"][0].numpy(),
                              arrays["Param"])


# -- activations --------------------------------------------------------------

SPECIAL = np.array([0.0, 0.0, 6.0, 1.0, -1.0, 0.5, -0.5, 24.0],
                   np.float32)
ACTIVATIONS = {
    "sigmoid": {}, "logsigmoid": {}, "exp": {}, "relu": {},
    "relu6": {"threshold": 6.0}, "tanh": {}, "tanh_shrink": {},
    "sqrt": "positive", "rsqrt": "positive", "abs": {}, "ceil": {},
    "floor": {}, "round": {}, "reciprocal": "positive", "log": "positive",
    "softplus": {}, "softsign": {}, "softshrink": {"lambda": 0.5},
    "hard_shrink": {"threshold": 0.5},
    "hard_sigmoid": {"slope": 0.2, "offset": 0.5},
    "thresholded_relu": {"threshold": 1.0}, "elu": {"alpha": 1.5},
    "pow": "positive", "stanh": {}, "square_act": {},
    "swish": {"beta": 1.5}, "gelu": {}, "leaky_relu": {"alpha": 0.1},
    "brelu": {"t_min": 0.0, "t_max": 6.0},
}


def _act_input(name):
    rng = np.random.RandomState(len(name))
    x = (rng.randn(4, 9) * 3).astype(np.float32)
    if ACTIVATIONS[name] == "positive":
        return np.abs(x) + 0.1
    x[0, :8] = SPECIAL                        # exact 0s and clip bounds
    return x


# the ops whose float attrs meet a bf16 X (ROADMAP C6), at attrs bf16
# does not hold exactly: the reference rounds each to bf16 first (JAX's
# weak typing).  (output ulps, gradient tolerance as a share of its
# largest magnitude): exact where the port rounds where the reference
# does; swish's output within 2 bf16 ulps and the stanh and swish
# gradients within 1.5% of their largest, the order of rounding inside
# the reference's fused bf16 chain.  Without the attrs rounded the
# outputs lie 1 (leaky_relu, elu), 3 (stanh), 15 (swish) and 64
# (hard_sigmoid) ulps apart, and pow's gradient 4 ulps.
BF16_ACTIVATIONS = {
    "leaky_relu": ({"alpha": 0.02}, 0, 0.0),
    "elu": ({"alpha": 0.3}, 0, 0.0),
    "stanh": ({}, 0, 1.5e-2),
    "hard_sigmoid": ({"slope": 0.2, "offset": 0.5}, 0, 0.0),
    "swish": ({"beta": 1.3}, 2, 1.5e-2),
    "pow": ({"factor": 1.7}, 0, 0.0),
}


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    return np.abs(got - want) / ulp


@pytest.mark.parametrize("name", sorted(ACTIVATIONS) + [
    f"{n}/bf16" for n in sorted(BF16_ACTIVATIONS)])
def test_activation_matches_reference(name):
    if name.endswith("/bf16"):
        name = name[:-len("/bf16")]
        attrs, out_ulps, grad_share = BF16_ACTIVATIONS[name]
        rng = np.random.RandomState(len(name))
        x = (rng.randn(16, 64) * 3).astype(np.float32)
        if name == "pow":
            x = np.abs(x) + 0.1
        jo, to, jg, tg = _both(name, {"X": x.astype(BF16)}, attrs,
                               wrt=("X",))
        want, got = np.asarray(jo["Out"][0]), to["Out"][0]
        assert got.dtype == want.dtype == BF16
        assert _bf16_ulps(got, want).max() <= out_ulps
        gwant = np.asarray(jg[0]).astype(np.float32)
        np.testing.assert_allclose(
            tg[0].astype(np.float32), gwant, rtol=0,
            atol=grad_share * float(np.abs(gwant).max()))
        return
    attrs = ACTIVATIONS[name]
    if attrs == "positive":
        attrs = {"factor": 2.5} if name == "pow" else {}
    jo, to, jg, tg = _both(name, {"X": _act_input(name)}, attrs,
                           wrt=("X",))
    _close(to["Out"][0], jo["Out"][0], OUT_TOL)
    _close(tg[0], jg[0], GRAD_TOL)


@pytest.mark.parametrize("mode", ["all", "channel", "element"])
def test_prelu_matches_reference(mode):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    alpha = {"all": rng.rand(1), "channel": rng.rand(3),
             "element": rng.rand(3, 4, 5)}[mode].astype(np.float32)
    jo, to, jg, tg = _both("prelu", {"X": x, "Alpha": alpha},
                           {"mode": mode}, wrt=("X", "Alpha"))
    _close(to["Out"][0], jo["Out"][0], OUT_TOL)
    for g, want in zip(tg, jg):
        _close(g, want, GRAD_TOL)


def test_maxout_matches_reference():
    """Values from {0, 1, 2}: tied maxima share the gradient alike."""
    x = np.random.RandomState(8).randint(0, 3, (2, 6, 3, 4)).astype(
        np.float32)
    jo, to, jg, tg = _both("maxout", {"X": x}, {"groups": 3}, wrt=("X",))
    _close(to["Out"][0], jo["Out"][0], EXACT)
    _close(tg[0], jg[0], OUT_TOL)


# -- math, loss and sequence ops --------------------------------------------

MATH_OPS = {
    "square": ({}, "X", ()),
    "clip": ({"min": -0.5, "max": 0.5}, "X", ()),
    "sign": ({}, "X", ()),
    "clip_by_norm/clipped": ({"max_norm": 1.0}, "X", ()),
    "clip_by_norm/kept": ({"max_norm": 100.0}, "X", ()),
    "norm": ({}, "X", ()),
    "squared_l2_norm": ({}, "X", ()),
    "log_softmax": ({}, "X", ()),
    "elementwise_max": ({}, "X", ("Y",)),
    "elementwise_min": ({}, "X", ("Y",)),
    "elementwise_pow": ({}, "positive", ("Y",)),
    "cos_sim": ({}, "X", ("Y",)),
    "sigmoid_cross_entropy_with_logits": ({}, "X", ("Label",)),
}


@pytest.mark.parametrize("name", sorted(MATH_OPS))
def test_math_op_matches_reference(name):
    op = name.split("/")[0]
    attrs, kind, extra = MATH_OPS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(5, 4).astype(np.float32)
    if kind == "positive":
        x = np.abs(x) + 0.1
    x[0, 0] = 0.5                                # at clip's bound
    arrays = {"X": x}
    for s in extra:
        arrays[s] = (rng.rand(5, 4) if s == "Label"
                     else rng.randn(5, 4)).astype(np.float32)
    if op in ("elementwise_max", "elementwise_min"):
        arrays["Y"][1, :2] = x[1, :2]            # ties split the gradient
    wrt = ("X",) + tuple(s for s in extra if s != "Label")
    if op in ("norm", "squared_l2_norm"):
        return _scalar_op_matches(op, x)
    jo, to, jg, tg = _both(op, arrays, attrs, wrt=wrt)
    for slot, vals in jo.items():
        _close(to[slot][0], vals[0], OUT_TOL)
    for g, want in zip(tg, jg):
        _close(g, want, GRAD_TOL)


def _scalar_op_matches(op, x):
    """A 0-d output and its own gradient."""
    import jax

    def jf(v):
        return _emit(jreg, JOpDesc, op, {"X": [v]}, {})["Out"][0]

    jv, jgrad = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tv = _emit(treg, TOpDesc, op, {"X": [xt]}, {})["Out"][0]
    tv.backward()
    _close(tv.detach().numpy(), jv, OUT_TOL)
    _close(xt.grad.numpy(), jgrad, GRAD_TOL)


def _seq_pair(rng, shape, lengths):
    data = rng.randn(*shape).astype(np.float32)
    return (jlod.SeqArray(jnp.asarray(data), jnp.asarray(lengths)),
            tlod.SeqArray(torch.tensor(data, requires_grad=True),
                          torch.tensor(lengths)))


@pytest.mark.parametrize("ctx_len,start", [(3, -1), (4, -1), (2, 0)])
def test_sequence_conv_matches_reference(ctx_len, start):
    """Ragged lengths (one of 1): the output, masked past each length,
    and the gradients of the data and the filter."""
    import jax

    rng = np.random.RandomState(ctx_len)
    lengths = np.array([5, 1, 3], np.int32)
    js, ts = _seq_pair(rng, (3, 5, 4), lengths)
    w = (rng.randn(ctx_len * 4, 6) * 0.3).astype(np.float32)
    wt = torch.tensor(w, requires_grad=True)
    attrs = {"context_length": ctx_len, "context_start": start}
    cot = rng.randn(3, 5, 6).astype(np.float32)

    def jf(data, w):
        out = _emit(jreg, JOpDesc, "sequence_conv",
                    {"X": [jlod.SeqArray(data, js.lengths)], "Filter": [w]},
                    attrs)["Out"][0]
        return (out.data * cot).sum(), out.data

    (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1),
                                           has_aux=True)(js.data,
                                                         jnp.asarray(w))
    tout = _emit(treg, TOpDesc, "sequence_conv", {"X": [ts], "Filter": [wt]},
                 attrs)["Out"][0]
    assert torch.equal(tout.lengths, ts.lengths)
    (tout.data * torch.tensor(cot)).sum().backward()
    _close(tout.data.detach().numpy(), jout, OUT_TOL)
    _close(ts.data.grad.numpy(), jgrads[0], GRAD_TOL)
    _close(wt.grad.numpy(), jgrads[1], GRAD_TOL)


def test_sequence_softmax_matches_reference():
    rng = np.random.RandomState(9)
    lengths = np.array([4, 1, 2], np.int32)
    js, ts = _seq_pair(rng, (3, 4, 1), lengths)
    jo = _emit(jreg, JOpDesc, "sequence_softmax", {"X": [js]}, {})["Out"][0]
    to = _emit(treg, TOpDesc, "sequence_softmax", {"X": [ts]}, {})["Out"][0]
    _close(to.data.detach().numpy(), jo.data, OUT_TOL)


def test_scale_rounds_its_scalars_on_bf16_as_the_reference():
    """ROADMAP C5: the reference rounds 0.9 and 0.3 to bf16 beside a bf16
    X (weak typing); the port does too, so the outputs are equal bit for
    bit, where scaling by the float32 scalars lands a bf16 ulp away on
    some elements."""
    x = (np.random.RandomState(10).randn(64) * 4).astype(BF16)
    attrs = {"scale": 0.9, "bias": 0.3, "bias_after_scale": True}
    jo, to, _, _ = _both("scale", {"X": x}, attrs)
    _close(to["Out"][0], jo["Out"][0], EXACT)
    unrounded = (torch.tensor(x.astype(np.float32)).to(torch.bfloat16)
                 * 0.9 + 0.3).float().numpy()
    assert (unrounded != np.asarray(jo["Out"][0]).astype(np.float32)).any()
    attrs["bias_after_scale"] = False
    jo, to, _, _ = _both("scale", {"X": x}, attrs)
    _close(to["Out"][0], jo["Out"][0], EXACT)


# -- the front end ------------------------------------------------------------

def _opt(kind, **kw):
    def make(fluid):
        o = fluid.optimizer
        return {"sgd": lambda: o.SGD(learning_rate=0.1, **kw),
                "momentum": lambda: o.Momentum(0.05, 0.9, **kw),
                "adagrad": lambda: o.Adagrad(0.1, **kw),
                "adam": lambda: o.Adam(0.02, **kw),
                "adamax": lambda: o.Adamax(0.02, **kw),
                "decayed_adagrad": lambda: o.DecayedAdagrad(0.1, **kw),
                "adadelta": lambda: o.Adadelta(1.0, **kw),
                "rmsprop": lambda: o.RMSProp(0.01, momentum=0.5, **kw),
                "ftrl": lambda: o.Ftrl(0.1, l1=0.01, l2=0.01, **kw)}[kind]()
    return make


def _net(fluid, opt, param_kw=None, error_clip=False):
    """x [8] -> fc 16 tanh -> fc 4 softmax -> cross entropy."""
    x = fluid.layers.data("x", [8], "float32")
    label = fluid.layers.data("label", [1], "int64")
    attr = fluid.ParamAttr(**param_kw) if param_kw else None
    hidden = fluid.layers.fc(x, size=16, act="tanh", param_attr=attr)
    if error_clip:
        hidden.error_clip = fluid.clip.ErrorClipByValue(max=1e-3)
    predict = fluid.layers.fc(hidden, size=4, act="softmax")
    loss = fluid.layers.mean(fluid.layers.cross_entropy(predict, label))
    opt(fluid).minimize(loss)
    return loss


def _decay(schedule):
    def make(fluid):
        d = fluid.learning_rate_decay
        lr = {"exponential": lambda: d.exponential_decay(0.1, 2, 0.5),
              "exponential_staircase": lambda: d.exponential_decay(
                  0.1, 2, 0.5, staircase=True),
              "natural_exp": lambda: d.natural_exp_decay(0.1, 3, 0.5),
              "inverse_time": lambda: d.inverse_time_decay(0.1, 2, 0.5),
              "polynomial": lambda: d.polynomial_decay(0.1, 5, 0.01, 2.0),
              "polynomial_cycle": lambda: d.polynomial_decay(
                  0.1, 3, 0.01, 1.0, cycle=True),
              "piecewise": lambda: d.piecewise_decay([2, 5],
                                                     [0.1, 0.05, 0.01])
              }[schedule]()
        step = fluid.layers.create_global_var([1], 0.0, "float32",
                                              persistable=True,
                                              name="opt_step")
        return fluid.optimizer.SGD(learning_rate=lr, global_step=step)
    return make


def _clip_case(kind):
    clips = {"value": lambda f: f.clip.GradientClipByValue(0.01),
             "norm": lambda f: f.clip.GradientClipByNorm(0.05),
             "global_norm": lambda f: f.clip.GradientClipByGlobalNorm(0.05)}

    def build(fluid):
        if kind == "global_norm":
            fluid.clip.set_gradient_clip(clips[kind](fluid))
            try:
                return _net(fluid, _opt("sgd"))
            finally:
                fluid.clip.set_gradient_clip(None)
        return _net(fluid, _opt("momentum"),
                    {"gradient_clip": clips[kind](fluid)})
    return build


FRONT_END = {
    **{f"opt/{k}": (lambda k=k: lambda f: _net(f, _opt(k)))()
       for k in ("sgd", "momentum", "adagrad", "adam", "adamax",
                 "decayed_adagrad", "adadelta", "rmsprop", "ftrl")},
    "reg/l2_optimizer": lambda f: _net(f, _opt(
        "adam", regularization=f.regularizer.L2Decay(0.1))),
    "reg/l1_param": lambda f: _net(f, _opt("sgd"), {
        "regularizer": f.regularizer.L1Decay(0.05)}),
    **{f"clip/{k}": _clip_case(k) for k in ("value", "norm",
                                            "global_norm")},
    "error_clip": lambda f: _net(f, _opt("sgd"), error_clip=True),
    **{f"decay/{k}": (lambda k=k: lambda f: _net(f, _decay(k)))()
       for k in ("exponential", "exponential_staircase", "natural_exp",
                 "inverse_time", "polynomial", "polynomial_cycle",
                 "piecewise")},
}


def _build(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = FRONT_END[case](fluid)
    return main, startup, loss


def _feed(i):
    rng = np.random.RandomState(50 + i)
    return {"x": rng.randn(6, 8).astype(np.float32),
            "label": rng.randint(0, 4, (6, 1)).astype(np.int64)}


@pytest.mark.parametrize("case", sorted(FRONT_END))
def test_front_end_matches_reference(case):
    """The program's bytes, then 4 steps from the reference's initialized
    scope: losses, parameters and every accumulator (the global step
    and the decayed rate's counter too)."""
    jm, js, jloss = _build(jfluid, case)
    tm, ts, tloss = _build(tfluid, case)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    types = [op.type for op in tm.global_block().ops]
    want_op = {"clip/value": "clip", "clip/norm": "clip_by_norm",
               "clip/global_norm": "squared_l2_norm",
               "reg/l1_param": "sign", "error_clip": "clip"}.get(case)
    assert want_op is None or want_op in types, types
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = [float(np.asarray(exe.run(jm, feed=_feed(i),
                                         fetch_list=[jloss])[0]))
                for i in range(4)]
        after = {n: np.asarray(scope.find_var(n)) for n in init}
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    got = [float(texe.run(tm, feed=_feed(i), fetch_list=[tloss],
                          scope=tscope)[0]) for i in range(4)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    got_state = tfluid.scope_to_numpy(tscope, list(init))
    moved = 0
    for n in init:
        np.testing.assert_allclose(got_state[n], after[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
        moved += not np.array_equal(after[n], init[n])
    assert moved >= 4
    if case.startswith("decay/"):
        np.testing.assert_array_equal(got_state["opt_step"], [4.0])


SCHEDULES = sorted(k.split("/")[1] for k in FRONT_END
                   if k.startswith("decay/"))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_decay_schedule_values_over_ten_steps(schedule):
    """The decayed rate fetched at steps 1-10 (the counter increments
    before the fetch, as in the reference)."""
    rates = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            lr = _decay(schedule)(fluid)._learning_rate
        if name == "jax":
            scope = jfluid.Scope()
            exe = jfluid.Executor(jfluid.CPUPlace())
            with jfluid.scope_guard(scope):
                exe.run(startup)
                rates[name] = [float(np.asarray(exe.run(
                    main, fetch_list=[lr])[0]).reshape(-1)[0])
                    for _ in range(10)]
        else:
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            rates[name] = [float(exe.run(main, fetch_list=[lr],
                                         scope=scope)[0].reshape(-1)[0])
                           for _ in range(10)]
    np.testing.assert_allclose(rates["port"], rates["jax"], **OUT_TOL)
    assert len(set(rates["port"])) > 1


def _sparse_net(fluid):
    ids = fluid.layers.data("ids", [4], "int64")
    emb = fluid.layers.embedding(ids, size=[20, 4], is_sparse=True,
                                 param_attr="emb_w")
    return fluid.layers.mean(emb)


def test_regularizer_on_a_sparse_gradient_warns_and_is_skipped():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        loss = _sparse_net(tfluid)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tfluid.optimizer.SGD(
                learning_rate=0.1,
                regularization=tfluid.regularizer.L2Decay(1e-4)
            ).minimize(loss)
    assert any("sparse-grad" in str(x.message) for x in w)
    assert "scale" not in [op.type for op in main.global_block().ops]
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"ids": np.array([[1, 2, 3, 4]])},
                   fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()


def test_clip_on_a_sparse_gradient_raises():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        loss = _sparse_net(tfluid)
        pg = tfluid.backward.append_backward(loss)
        for p, _ in pg:
            p.gradient_clip_attr = tfluid.clip.GradientClipByValue(1.0)
        with pytest.raises(NotImplementedError, match="sparse-grad"):
            tfluid.clip.append_gradient_clip_ops(pg)


def test_append_backward_callbacks_see_every_appended_op():
    main, startup = tfluid.Program(), tfluid.Program()
    seen = []
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4], "float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, size=3))
        n_fwd = len(main.global_block().ops)
        tfluid.backward.append_backward(
            loss, callbacks=[lambda block, op: seen.append(op)])
    assert seen == main.global_block().ops[n_fwd:]
    assert seen[0].type == "fill_constant"


def test_model_average_is_not_ported():
    with pytest.raises(NotImplementedError, match="ModelAverage"):
        tfluid.optimizer.ModelAverage(0.15)
