"""The book's first two chapters in the port — fit_a_line and
recognize_digits (``conv_net``, ``mlp``) — against the JAX package, on
the CPU.

* Ops, on the same numpy inputs through both packages' emitters:
  ``conv2d`` (strides, padding, dilation, groups) and ``pool2d`` (max
  and average, padding, ``ceil_mode``, global, tied maxima) forward and
  gradients in float32 and bf16, and ``square_error_cost``, ``sgd`` and
  ``momentum``.  float32: both sides sum in float32 in another order,
  so OUT_TOL / GRAD_TOL; pooling picks or sums the same elements, and
  max pooling's value and the route of its gradient must be exact.
  bf16: every output rounds the same float32 sums to bf16, so a value
  near a rounding boundary lands one ulp (2^-8 relative) apart
  (BF16_TOL, 2 ulps); a filter gradient sums bf16-rounded products.
* Programs: fit_a_line, ``conv_net`` and ``mlp`` under SGD, Momentum
  and Adam, and the reference's bf16 conv net, serialize to the same
  bytes in both packages.
* Training from a copied JAX scope on the same seeded feeds: 200 SGD
  steps of fit_a_line follow the reference's loss curve and the loss
  falls ~100x; ``conv_net`` under Adam on the synthetic digits of
  ``tests/test_book.py`` follows the reference and meets its ``< 0.6x``
  after 30 steps; the bf16 conv-pool net of ``tests/test_book.py`` under
  Momentum follows the reference for 10 steps and meets its ``< 0.8x``
  after 25; ``mlp`` under Momentum follows the reference.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import fit_a_line as JFit
from paddle_tpu.models import recognize_digits as JDigits
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.models import fit_a_line as TFit
from paddle_tpu_torch.models import recognize_digits as TDigits
from tests.test_torch_amp import BF16, BF16_TOL, _both, _close, _emit

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=0, atol=0)


# -- ops ----------------------------------------------------------------------

CONV_CASES = {
    "plain": dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                  groups=1),
    "strided_padded": dict(strides=[2, 1], paddings=[1, 2],
                           dilations=[1, 1], groups=1),
    "dilated_grouped": dict(strides=[1, 2], paddings=[2, 1],
                            dilations=[2, 1], groups=2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_reference(case, dtype):
    """NCHW input [2, 4, 9, 11], OIHW filter [6, 4 / groups, 3, 3] kept
    f32 (the master filter under amp when the input is bf16)."""
    attrs = CONV_CASES[case]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 9, 11).astype(BF16 if dtype == "bfloat16"
                                       else np.float32)
    w = (rng.randn(6, 4 // attrs["groups"], 3, 3) * 0.3).astype(np.float32)
    jo, to, jg, tg = _both("conv2d", {"Input": x, "Filter": w}, attrs,
                           "Output", wrt=("Input", "Filter"))
    if dtype == "float32":
        _close(to["Output"][0], jo["Output"][0], OUT_TOL)
        _close(tg[0], jg[0], GRAD_TOL)
        _close(tg[1], jg[1], GRAD_TOL)
    else:
        _close(to["Output"][0], jo["Output"][0], BF16_TOL)
        _close(tg[0], jg[0], BF16_TOL)
        # the filter gradient sums up to 2 x 99 bf16 products into f32
        # after a bf16 rounding on each side
        assert tg[1].dtype == np.float32
        _close(tg[1], jg[1], dict(rtol=2 ** -6, atol=2 ** -7 * 16))


POOL_CASES = {
    "max_2x2": dict(pooling_type="max", ksize=[2, 2], strides=[2, 2],
                    paddings=[0, 0]),
    "max_3x3_s2_pad1": dict(pooling_type="max", ksize=[3, 3],
                            strides=[2, 2], paddings=[1, 1]),
    "max_ceil": dict(pooling_type="max", ksize=[3, 2], strides=[2, 2],
                     paddings=[0, 0], ceil_mode=True),
    # a last window that starts in the padding: kept by the reference,
    # dropped by torch's own ceil_mode (-inf there)
    "max_ceil_pad": dict(pooling_type="max", ksize=[2, 2], strides=[2, 2],
                         paddings=[1, 1], ceil_mode=True),
    "max_global": dict(pooling_type="max", global_pooling=True),
    "avg_2x2": dict(pooling_type="avg", ksize=[2, 2], strides=[2, 2],
                    paddings=[0, 0]),
    "avg_3x3_s1_pad1": dict(pooling_type="avg", ksize=[3, 3],
                            strides=[1, 1], paddings=[1, 1]),
    "avg_ceil": dict(pooling_type="avg", ksize=[3, 3], strides=[2, 2],
                     paddings=[0, 1], ceil_mode=True),
    "avg_global": dict(pooling_type="avg", global_pooling=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_reference(case, dtype):
    """X [2, 3, 7, 9] (odd extents, so ceil_mode keeps partial windows).
    Max: the same element wins each window, so value and gradient are
    exact in both dtypes.  Average: exclusive counts (padding left out)."""
    attrs = POOL_CASES[case]
    x = np.random.RandomState(1).randn(2, 3, 7, 9).astype(
        BF16 if dtype == "bfloat16" else np.float32)
    jo, to, jg, tg = _both("pool2d", {"X": x}, attrs, wrt=("X",))
    out = np.asarray(jo["Out"][0])
    if case == "max_ceil_pad":
        # the reference's 5x6 output keeps windows wholly in the padding
        assert out.shape == (2, 3, 5, 6) and np.isinf(
            out.astype(np.float32)).any()
    ptype = attrs["pooling_type"]
    if ptype == "max":
        _close(to["Out"][0], out, EXACT)
        _close(tg[0], jg[0], EXACT)
    elif dtype == "float32":
        _close(to["Out"][0], out, OUT_TOL)
        _close(tg[0], jg[0], OUT_TOL)
    else:
        _close(to["Out"][0], out, BF16_TOL)
        _close(tg[0], jg[0], BF16_TOL)


@pytest.mark.parametrize("strides", [[2, 2], [1, 1]],
                         ids=["disjoint", "overlapping"])
def test_max_pool_gradient_on_ties_routes_as_the_reference(strides):
    """Windows whose maximum is tied (values drawn from {0, 1}): the
    reference's reduce_window gradient gives each window's cotangent to
    one of its maxima; the port must pick the same one, also where
    windows overlap."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, 2, (2, 2, 6, 6)).astype(np.float32)
    attrs = dict(pooling_type="max", ksize=[2, 2], strides=strides,
                 paddings=[0, 0])
    jo, to, jg, tg = _both("pool2d", {"X": x}, attrs, wrt=("X",))
    _close(to["Out"][0], jo["Out"][0], EXACT)
    _close(tg[0], jg[0], EXACT)


def test_square_error_cost_matches_reference():
    rng = np.random.RandomState(3)
    arrays = {"X": rng.randn(8, 1).astype(np.float32),
              "Y": rng.randn(8, 1).astype(np.float32)}
    jo, to, jg, tg = _both("square_error_cost", arrays, {},
                           wrt=("X", "Y"))
    _close(to["Out"][0], jo["Out"][0], OUT_TOL)
    for g, want in zip(tg, jg):
        _close(g, want, OUT_TOL)


def test_sgd_matches_reference_and_updates_in_place():
    rng = np.random.RandomState(4)
    arrays = {"Param": rng.randn(5, 3).astype(np.float32),
              "Grad": rng.randn(5, 3).astype(np.float32),
              "LearningRate": np.array([0.05], np.float32)}
    jo, to, _, _ = _both("sgd", arrays, {}, "ParamOut")
    _close(to["ParamOut"][0], jo["ParamOut"][0], OUT_TOL)
    t_ins = {s: [torch.tensor(a)] for s, a in arrays.items()}
    out = _emit(treg, TOpDesc, "sgd", t_ins, {})
    assert out["ParamOut"][0] is t_ins["Param"][0]


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_reference_and_updates_in_place(nesterov):
    rng = np.random.RandomState(5)
    arrays = {"Param": rng.randn(5, 3).astype(np.float32),
              "Grad": rng.randn(5, 3).astype(np.float32),
              "Velocity": rng.randn(5, 3).astype(np.float32) * 0.1,
              "LearningRate": np.array([0.05], np.float32)}
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    jo, to, _, _ = _both("momentum", arrays, attrs, "ParamOut")
    for slot in ("ParamOut", "VelocityOut"):
        _close(to[slot][0], jo[slot][0], OUT_TOL)
    t_ins = {s: [torch.tensor(a)] for s, a in arrays.items()}
    out = _emit(treg, TOpDesc, "momentum", t_ins, attrs)
    assert out["ParamOut"][0] is t_ins["Param"][0]
    assert out["VelocityOut"][0] is t_ins["Velocity"][0]


# -- programs -----------------------------------------------------------------

OPTIMIZERS = {"sgd": lambda o: o.SGD(learning_rate=0.01),
              "momentum": lambda o: o.Momentum(learning_rate=0.05,
                                               momentum=0.9),
              "adam": lambda o: o.Adam(learning_rate=0.01)}


def fit_a_line(fluid, models):
    loss = models["fit"].build()[1]
    return loss, None


def digits(net, opt, shape=(1, 28, 28), dtype="float32"):
    def make(fluid, models):
        img = fluid.layers.data(name="img", shape=list(shape), dtype=dtype)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        _, avg_cost, acc = getattr(models["digits"], net)(img, label)
        OPTIMIZERS[opt](fluid.optimizer).minimize(avg_cost)
        return avg_cost, acc
    return make


def bf16_conv_net(fluid, models):
    """tests/test_book.py test_bf16_activation_training's network."""
    img = fluid.layers.data(name="img", shape=[3, 16, 16], dtype="bfloat16")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    conv = fluid.layers.conv2d(input=img, num_filters=8, filter_size=3,
                               padding=1, act="relu")
    pool = fluid.layers.pool2d(input=conv, pool_size=2, pool_stride=2)
    predict = fluid.layers.fc(input=pool, size=4, act="softmax")
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(
        avg_cost)
    return avg_cost, None


PACKAGES = {"jax": (jfluid, {"fit": JFit, "digits": JDigits}),
            "port": (tfluid, {"fit": TFit, "digits": TDigits})}
PROGRAMS = {"fit_a_line": fit_a_line,
            "bf16_conv_net": bf16_conv_net,
            **{f"{net}/{opt}": digits(net, opt) for net in ("conv_net",
                                                            "mlp")
               for opt in OPTIMIZERS}}


def build(package, program):
    fluid, models = PACKAGES[package]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, acc = PROGRAMS[program](fluid, models)
    return main, startup, loss, acc


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_book_program_bytes_match_reference(program):
    jm, js, _, _ = build("jax", program)
    tm, ts, _, _ = build("port", program)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm.desc.fingerprint() == jm.desc.fingerprint()


def train_both(program, feeder, steps):
    """``steps`` steps of ``program`` in both packages from the JAX
    startup's scope on the same feeds -> (jax losses, port losses)."""
    jm, js, jloss, _ = build("jax", program)
    tm, _, tloss, _ = build("port", program)
    scope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        jexe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = [float(jexe.run(jm, feed=feeder(i), fetch_list=[jloss])[0])
                for i in range(steps)]
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    got = [float(texe.run(tm, feed=feeder(i), fetch_list=[tloss],
                          scope=tscope)[0]) for i in range(steps)]
    return np.array(want), np.array(got)


def fit_a_line_feed(i):
    """Batches of 32 from a fixed linear model plus noise (the regression
    of tests/test_executor.py), one seed a step."""
    w = np.random.RandomState(42).randn(13, 1).astype(np.float32)
    rng = np.random.RandomState(1000 + i)
    x = rng.randn(32, 13).astype(np.float32)
    y = x @ w + 0.5 + 0.01 * rng.randn(32, 1).astype(np.float32)
    return {"x": x, "y": y}


def test_fit_a_line_200_sgd_steps_follow_the_reference():
    """float32 on both sides, summation order only: every step's loss
    within 1e-4 relative (measured: 6.7e-6); the loss falls ~100x (the
    verify recipe's flow 1; measured 6.33 -> 0.0032)."""
    want, got = train_both("fit_a_line", fit_a_line_feed, 200)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    assert got[-10:].mean() < got[0] / 100, (got[0], got[-10:])


def digits_feed(i):
    """tests/test_book.py's synthetic digits: class k lights the row band
    2k..2k+2 of a dim 28x28 image; 16 a batch, one seed a step."""
    rng = np.random.RandomState(i)
    lbl = rng.randint(0, 10, (16, 1)).astype(np.int64)
    img = rng.rand(16, 1, 28, 28).astype(np.float32) * 0.1
    for b, k in enumerate(lbl[:, 0]):
        img[b, 0, k * 2: k * 2 + 3, :] += 1.0
    return {"img": img, "label": lbl}


@pytest.mark.parametrize("program,steps,below", [
    ("conv_net/adam", 30, 0.6), ("mlp/momentum", 20, None)])
def test_digits_nets_train_as_the_reference(program, steps, below):
    """float32: each step's loss within 2e-3 relative of the reference's
    (measured: 4.5e-4 for conv_net under Adam, whose normalised steps let
    summation-order differences grow over 30 steps; 3.4e-6 for mlp);
    conv_net meets tests/test_book.py's ``last < 0.6 x first``."""
    want, got = train_both(program, digits_feed, steps)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    if below is not None:
        assert got[-1] < got[0] * below, got[::6]


def bf16_images_feed(i):
    """tests/test_book.py test_bf16_activation_training's feed: bf16
    images where class k brightens channel k % 3."""
    rng = np.random.RandomState(i)
    lbl = rng.randint(0, 4, (8, 1)).astype(np.int64)
    img = (rng.rand(8, 3, 16, 16) * 0.2).astype(BF16)
    for b, k in enumerate(lbl[:, 0]):
        img[b, k % 3] += BF16(0.8)
    return {"img": img, "label": lbl}


def test_bf16_conv_net_trains_under_momentum():
    """bf16 activations over f32 master weights: 25 Momentum steps, every
    loss finite and the last below 0.8 x the first (tests/test_book.py's
    bar).  The first 10 losses follow the reference's within 5e-2
    relative (measured: 1.9e-2; the bf16 loss is itself rounded to
    2^-8).  Later steps are not compared: momentum 0.9 compounds the two
    sides' bf16 rounding differences (measured: 0.1-0.3 apart at some
    steps after the 13th, the last 10 steps' mean 0.42 against 0.39)."""
    want, got = train_both("bf16_conv_net", bf16_images_feed, 25)
    assert np.isfinite(got).all()
    assert got[-1] < got[0] * 0.8, got[::5]
    np.testing.assert_allclose(got[:10], want[:10], rtol=5e-2)
