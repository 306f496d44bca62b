"""Image classification in the port — ``batch_norm``, ``lrn`` and
``concat``, the book's third chapter (``models/image_classification``:
``resnet_cifar10``, ``vgg16_bn_drop``, ``resnet_imagenet``) and the
reference's image benchmarks (``models/benchmark_nets``: AlexNet,
GoogLeNet, SmallNet) — against the JAX package, on the CPU.

* Ops, on the same numpy inputs through both packages' emitters, forward
  and every gradient, in float32 and bf16.  ``batch_norm`` on NCHW and
  2-D input, train and test mode, all five outputs (Y, the moving
  averages MeanOut / VarianceOut, SavedMean and SavedVariance, the
  inverse deviation); in bf16 with float32 and with bf16 moving stats
  (the startup program fills them in X's dtype).  float32: both sides
  sum in another order, so the book's OUT_TOL / GRAD_TOL.  bf16: Y and
  X's gradient round float32 results to bf16, one ulp apart near a
  rounding boundary (BF16_TOL); the statistics and the scale and offset
  gradients are float32 sums of the same bf16 values (OUT_TOL).
  ``lrn`` (n = 3 and 5) with the same limits; ``concat`` (2-4 inputs,
  axes 0 and 1) exactly.
* Programs: the six image models (ResNet-50 with float32 and bf16
  images), their backward and Momentum / Adam ops, and
  ``nets.img_conv_group(conv_with_batchnorm=True)`` serialize to the
  same bytes in both packages.
* Training from a copied JAX scope on the same feeds, the port's steps
  drawing the reference's dropout masks (see ``reference_seeds``):
  ``resnet_cifar10`` depth 8 (30 Momentum steps, the losses and moving
  stats, ``tests/test_book.py``'s falling-loss check); ``vgg16_bn_drop``
  (2 Adam steps at batch 2: dropout and the 2-D batch norm);
  ``smallnet_cifar`` on one fixed batch of 16; one Momentum step of
  ResNet-50 in float32 and in the bf16 recipe (loss, every gradient,
  every moving stat); and ``clone(for_test=True)`` of ``resnet_cifar10``
  evaluating with the moving stats.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import benchmark_nets as JB
from paddle_tpu.models import image_classification as JI
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.models import benchmark_nets as TB
from paddle_tpu_torch.models import image_classification as TI
from tests.test_torch_amp import (BF16, BF16_TOL, GRAD_L2, LOSS_RTOL,
                                  NOISE_RATIO, _both, _close, _emit,
                                  _rel_l2)
from tests.test_torch_book import EXACT, GRAD_TOL, OUT_TOL

BN_OUTS = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")


# -- ops ----------------------------------------------------------------------

# (X dtype, moving stats dtype): bf16 stats come only beside a bf16 X,
# at the first step of the bf16 recipe
BN_DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
             ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("dtype,stats", BN_DTYPES,
                         ids=["f32", "bf16", "bf16-bf16stats"])
@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("shape", [(4, 6, 5, 7), (8, 6)],
                         ids=["nchw", "2d"])
def test_batch_norm_matches_reference(shape, mode, dtype, stats):
    """X of ``shape`` (NCHW or the [N, C] of an fc), an f32 scale and
    offset (the masters), moving stats in ``stats``.  All five outputs
    with the reference's dtypes, and the gradients of X, Scale and
    Bias."""
    rng = np.random.RandomState(0)
    c = shape[1]
    x = (rng.randn(*shape) * 1.5 + 0.7).astype(
        BF16 if dtype == "bfloat16" else np.float32)
    st = BF16 if stats == "bfloat16" else np.float32
    arrays = {"X": x,
              "Scale": (1 + 0.3 * rng.randn(c)).astype(np.float32),
              "Bias": (0.2 * rng.randn(c)).astype(np.float32),
              "Mean": (0.1 * rng.randn(c)).astype(st),
              "Variance": (1 + 0.2 * rng.rand(c)).astype(st)}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": mode == "test",
             "data_layout": "NCHW"}
    jo, to, jg, tg = _both("batch_norm", arrays, attrs, "Y",
                           wrt=("X", "Scale", "Bias"))
    tol = BF16_TOL if dtype == "bfloat16" else OUT_TOL
    _close(to["Y"][0], jo["Y"][0], tol)
    for slot in BN_OUTS[1:]:
        _close(to[slot][0], jo[slot][0], OUT_TOL)
    _close(tg[0], jg[0], BF16_TOL if dtype == "bfloat16" else GRAD_TOL)
    _close(tg[1], jg[1], GRAD_TOL)
    _close(tg[2], jg[2], GRAD_TOL)


def test_batch_norm_infer_mode_is_test_mode():
    """``ctx.mode == "infer"`` uses the moving stats as ``is_test`` does,
    and passes them through unchanged."""
    rng = np.random.RandomState(1)
    ins = {"X": [torch.tensor(rng.randn(3, 4, 2, 2).astype(np.float32))],
           "Scale": [torch.ones(4)], "Bias": [torch.zeros(4)],
           "Mean": [torch.tensor(rng.randn(4).astype(np.float32))],
           "Variance": [torch.full((4,), 2.0)]}
    infer = _emit(treg, TOpDesc, "batch_norm", ins, {}, mode="infer")
    test = _emit(treg, TOpDesc, "batch_norm", ins, {"is_test": True})
    for slot in BN_OUTS:
        assert torch.equal(infer[slot][0], test[slot][0]), slot
    assert infer["MeanOut"][0] is ins["Mean"][0]
    want = (ins["X"][0] - ins["Mean"][0].reshape(1, 4, 1, 1)) / np.sqrt(
        2.0 + 1e-5)
    torch.testing.assert_close(infer["Y"][0], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [3, 5])
def test_lrn_matches_reference(n, dtype):
    """NCHW X [2, 7, 4, 5] (a window wider than the edge channels have),
    k 2, alpha 1e-2 (large enough that the window sum moves Out), beta
    0.75: Out and MidOut, and X's gradient."""
    x = (np.random.RandomState(2).randn(2, 7, 4, 5) * 2).astype(
        BF16 if dtype == "bfloat16" else np.float32)
    attrs = {"n": n, "k": 2.0, "alpha": 1e-2, "beta": 0.75}
    jo, to, jg, tg = _both("lrn", {"X": x}, attrs, wrt=("X",))
    if dtype == "float32":
        _close(to["Out"][0], jo["Out"][0], OUT_TOL)
        _close(to["MidOut"][0], jo["MidOut"][0], OUT_TOL)
        _close(tg[0], jg[0], GRAD_TOL)
    else:
        _close(to["Out"][0], jo["Out"][0], BF16_TOL)
        _close(to["MidOut"][0], jo["MidOut"][0], BF16_TOL)
        _close(tg[0], jg[0], BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_concat_matches_reference_exactly(k, axis, dtype):
    """``k`` NCHW inputs of different extents along ``axis``: the output
    and each input's gradient equal bitwise."""
    rng = np.random.RandomState(3)
    dt = BF16 if dtype == "bfloat16" else np.float32
    xs = []
    for i in range(k):
        shape = [2, 3, 4, 5]
        shape[axis] = i + 1
        xs.append(rng.randn(*shape).astype(dt))
    j_ins = {"X": [jnp.asarray(a) for a in xs]}
    t_ins = {"X": [torch.tensor(a.astype(np.float32)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ).requires_grad_(True) for a in xs]}
    from paddle_tpu.fluid.core import registry as jreg
    from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc

    jo = _emit(jreg, JOpDesc, "concat", j_ins, {"axis": axis})["Out"][0]
    to = _emit(treg, TOpDesc, "concat", t_ins, {"axis": axis})["Out"][0]
    _close(to.detach().float().numpy().astype(dt), jo, EXACT)
    w = np.random.RandomState(4).randn(*jo.shape).astype(np.float32)
    jg = jax.grad(lambda *a: (jnp.concatenate(a, axis).astype(jnp.float32)
                              * w).sum(), argnums=tuple(range(k)))(
        *j_ins["X"])
    (to.float() * torch.tensor(w)).sum().backward()
    for t, g in zip(t_ins["X"], jg):
        _close(t.grad.float().numpy().astype(dt), g, EXACT)


# -- programs -----------------------------------------------------------------

PACKAGES = {"jax": (jfluid, JI, JB), "port": (tfluid, TI, TB)}


def _resnet50(I, B, img):
    return I.resnet_imagenet(img, class_num=1000, depth=50)


# name: (image px, classes, builder(image models, benchmark nets, img))
MODELS = {
    "resnet50": (224, 1000, _resnet50),
    "resnet_cifar10_d8": (32, 4, lambda I, B, img: I.resnet_cifar10(
        img, depth=8, class_num=4)),
    "resnet_cifar10_d32": (32, 10, lambda I, B, img: I.resnet_cifar10(
        img, depth=32, class_num=10)),
    "vgg16_bn_drop": (32, 10, lambda I, B, img: I.vgg16_bn_drop(
        img, class_num=10)),
    "alexnet": (227, 1000, lambda I, B, img: B.alexnet(img,
                                                       class_num=1000)),
    "googlenet_v1": (224, 1000, lambda I, B, img: B.googlenet_v1(
        img, class_num=1000)),
    "smallnet_cifar": (32, 10, lambda I, B, img: B.smallnet_cifar(
        img, class_num=10)),
}

OPTIMIZERS = {"momentum": lambda o, lr: o.Momentum(learning_rate=lr,
                                                   momentum=0.9),
              "adam": lambda o, lr: o.Adam(learning_rate=lr)}


def build(package, model, dtype="float32", px=None, opt="momentum",
          lr=0.1, tests=None):
    """``model``'s training program: images [3, px, px] of ``dtype``
    (bench.py's recipe: bf16 images, f32 masters), int64 labels, the mean
    cross entropy, ``opt`` at ``lr``.  -> (main, startup, loss).  With a
    list ``tests``, the book's test program, ``main.clone(for_test=True)``
    taken before the optimizer, is appended to it with the prediction."""
    fluid, I, B = PACKAGES[package]
    size, _, make = MODELS[model]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, px or size, px or size], dtype)
        label = fluid.layers.data("label", [1], "int64")
        pred = make(I, B, img)
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        if tests is not None:
            tests.extend([main.clone(for_test=True), pred])
        OPTIMIZERS[opt](fluid.optimizer, lr).minimize(loss)
    return main, startup, loss


PROGRAMS = [("resnet50", "float32"), ("resnet50", "bfloat16")] + [
    (m, "float32") for m in sorted(MODELS) if m != "resnet50"] + [
    ("alexnet", "bfloat16"), ("googlenet_v1", "bfloat16")]


@pytest.mark.parametrize("model,dtype", PROGRAMS,
                         ids=[f"{m}-{d}" for m, d in PROGRAMS])
def test_image_program_bytes_match_reference(model, dtype):
    jm, js, _ = build("jax", model, dtype)
    tm, ts, _ = build("port", model, dtype)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert tm.desc.fingerprint() == jm.desc.fingerprint()


def test_resnet50_bf16_recipe_keeps_masters_and_stats_float32():
    """The bf16 recipe's ResNet-50: images bf16, every conv and batch
    norm output bf16, every parameter and its gradient f32, and the 53
    moving means and variances declared f32 in the main program (the
    op's float32 MeanOut / VarianceOut) while the startup program fills
    them in bf16, as the reference's does; a step from the reference's
    startup scope (R50_PX px) leaves them float32, and the port's
    executor keeps no graph of that step."""
    main, startup, _ = build("port", "resnet50", "bfloat16")
    block = main.global_block()
    bn = [op for op in block.ops if op.type == "batch_norm"]
    assert len(bn) == 53
    stats = [op.output(s)[0] for op in bn for s in ("MeanOut",
                                                    "VarianceOut")]
    assert {block.var(n).dtype for n in stats} == {"float32"}
    assert {block.var(op.output("Y")[0]).dtype for op in bn} == \
        {"bfloat16"}
    params = block.all_parameters()
    assert {p.dtype for p in params} == {"float32"}
    assert {block.var(p.name + "@GRAD").dtype for p in params} == \
        {"float32"}
    sblock = startup.global_block()
    assert {sblock.var(n).dtype for n in stats} == {"bfloat16"}
    main, _, loss = build("port", "resnet50", "bfloat16", px=R50_PX)
    _, init = _jax_init(build("jax", "resnet50", "bfloat16",
                              px=R50_PX)[1])
    cpu = tfluid.CPUPlace()
    scope = tfluid.scope_from_numpy(init, cpu)
    exe = tfluid.Executor(cpu)
    rng = np.random.RandomState(0)
    exe.run(main, feed={
        "img": rng.rand(R50_BATCH, 3, R50_PX, R50_PX).astype(BF16),
        "label": rng.randint(0, 1000, (R50_BATCH, 1)).astype(np.int64)},
        fetch_list=[loss], scope=scope)
    assert {scope.find_var(n).dtype for n in stats} == {torch.float32}
    assert exe.cache_stats()["executable"]["misses"] == 1
    assert exe.cache_stats()["executable"]["size"] == 0


@pytest.mark.parametrize("bn", [False, True, [True, False]],
                         ids=["plain", "bn", "mixed"])
def test_img_conv_group_builds_the_reference_bytes(bn):
    """``img_conv_group`` with ``conv_with_batchnorm`` off, on and per
    conv, and a dropout after the first batch norm."""
    progs = {}
    for name, (fluid, _, _) in PACKAGES.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            img = fluid.layers.data("img", [3, 8, 8], "float32")
            out = fluid.nets.img_conv_group(
                input=img, conv_num_filter=[4, 6], pool_size=2,
                conv_act="relu", conv_with_batchnorm=bn,
                conv_batchnorm_drop_rate=[0.3, 0.0], pool_stride=2)
        progs[name] = (main, startup, out)
    assert progs["port"][0].serialize_to_string() == \
        progs["jax"][0].serialize_to_string()
    assert progs["port"][1].serialize_to_string() == \
        progs["jax"][1].serialize_to_string()
    assert progs["port"][2].shape == (-1, 6, 4, 4)


# -- training from a copied JAX scope -----------------------------------------

def reference_seeds(plan, seed, step):
    """The reference's dropout seed of each of the plan's random ops in
    step ``step``: 32 bits drawn from fold_in(fold_in(key(seed), step),
    salt), as its lowering keys an op and its dropout draws one scalar.
    Put in place of the port's own hash (``lowering.step_seeds``), it
    makes the port's dropout masks the reference's."""
    key = jax.random.fold_in(jax.random.key(seed), step)
    return [int(jax.random.bits(jax.random.fold_in(key, salt), (),
                                jnp.uint32)) for salt in plan.salts]


def _jax_init(startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.find_var(n)) for n in scope.vars
                   if scope.find_var(n) is not None}


def moving_stats(main):
    return [op.output(s)[0] for op in main.global_block().ops
            if op.type == "batch_norm" for s in ("MeanOut", "VarianceOut")]


def train_both(model, feeds, fetch_of, monkeypatch, init=None, **kw):
    """``len(feeds)`` steps of ``model`` in both packages from one scope,
    the JAX startup's or the numpy state ``init`` (the port's scope at
    the same rng step), fetching ``fetch_of(main, loss)`` each step ->
    (jax fetches, port fetches, the port's executor), each a list a
    step."""
    jm, js, jloss = build("jax", model, **kw)
    tm, _, tloss = build("port", model, **kw)
    fetch = fetch_of(jm, jloss)
    jscope, start = _jax_init(js)
    init = start if init is None else init
    rng_at = (jscope._rng_seed, jscope._rng_step)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    scope._rng_seed, scope._rng_step = rng_at
    for name, value in init.items():
        scope.set_var(name, jnp.asarray(value))
    with jfluid.scope_guard(scope):
        want = [[np.asarray(v) for v in jexe.run(jm, feed=f,
                                                 fetch_list=fetch)]
                for f in feeds]
    monkeypatch.setattr(texecutor, "step_seeds", reference_seeds)
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    tscope._rng_seed, tscope._rng_step = rng_at
    texe = tfluid.Executor(cpu)
    got = [texe.run(tm, feed=f, fetch_list=fetch, scope=tscope)
           for f in feeds]
    return want, got, texe


def cifar_feeds(steps, batch=8, classes=4, seed=2):
    """tests/test_book.py's synthetic CIFAR feeds, drawn in its order:
    class k brightens channel k % 3 of a dim 32x32 image."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        lbl = rng.randint(0, classes, (batch, 1)).astype(np.int64)
        img = rng.rand(batch, 3, 32, 32).astype(np.float32) * 0.2
        for b, k in enumerate(lbl[:, 0]):
            img[b, k % 3] += 0.8
        out.append({"img": img, "label": lbl})
    return out


def _loss_gap(a, b):
    """Each step's loss in ``a`` against ``b``, relative."""
    a = np.array([float(x[0]) for x in a])
    b = np.array([float(x[0]) for x in b])
    return np.abs(a - b) / np.abs(b)


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# resnet_cifar10 depth 8 at batch 8: the steps compared tightly, and the
# bound on every step's loss gap after them
CIFAR_EXACT_STEPS, CIFAR_DRIFT = 5, 0.1


def test_resnet_cifar10_follows_the_reference_for_30_steps(monkeypatch):
    """tests/test_book.py's depth-8 CIFAR ResNet under Momentum(0.02,
    0.9), batch 8.  float32 on both sides, but at 8 images a batch norm
    turns the trajectory chaotic: the loss gap, 6e-7 at step 1 (summation
    order), grows about 2.5x a step (measured: 1.7e-4 at step 5, 2e-3 at
    step 8, up to 5.5e-2 by step 30), as a one-ulp change of the first
    batch's images grows in the reference's own run (1e-7 at step 2,
    1.4e-3 by step 20).  So: the first CIFAR_EXACT_STEPS losses within
    1e-3 relative, and the 106 moving means and variances after them
    within 1e-3 of their largest (measured 2.7e-4); every loss of the 30
    within CIFAR_DRIFT; and the test's own check, the last 5 losses
    below the first 5."""
    feeds = cifar_feeds(30)
    main = build("port", "resnet_cifar10_d8", lr=0.02)[0]
    stats = moving_stats(main)
    want, got, _ = train_both(
        "resnet_cifar10_d8", feeds, lambda m, loss: [loss.name] + stats,
        monkeypatch, lr=0.02)
    gap = _loss_gap(got, want)
    k = CIFAR_EXACT_STEPS
    assert (gap[:k] <= 1e-3).all(), gap[:k]
    for name, a, b in zip(stats, got[k - 1][1:], want[k - 1][1:]):
        assert _max_rel(a, b) <= 1e-3, (name, _max_rel(a, b))
    assert (gap <= CIFAR_DRIFT).all(), gap
    gl = np.array([float(g[0]) for g in got])
    assert gl[-5:].mean() < gl[:5].mean(), gl[::6]


def test_vgg16_bn_drop_two_adam_steps_follow_the_reference(monkeypatch):
    """tests/test_book.py's VGG step: Adam(1e-3), batch 2 of seeded
    images; the dropouts (0.3-0.5, on 4-D and 2-D values) draw the
    reference's masks, and the fc's 2-D batch norm runs on 2 rows.

    Step 1: the loss within 1e-4 relative (measured 1.2e-5), the 2-D
    norm's moving stats within 1e-4 of their largest (4.6e-6), every
    weight, scale and offset gradient within 1e-2 in relative L2 (2.7e-3:
    float32 through 13 convolutions and a norm over 2 rows, whose input
    gradient is a difference of two nearly equal terms).  The biases of
    the layers that feed a batch norm have a gradient of 0 (the norm
    takes a per-channel constant out): in both packages it is rounding,
    within VGG_ZERO_GRAD of the program's largest gradient.  Step 2: the
    loss within 1e-2 (4.2e-3): Adam's first step moves each weight by
    about the learning rate in its gradient's sign, and the elements
    whose gradient is within rounding of 0 (6206 of 15.2M) and those
    biases move apart in the two packages."""
    rng = np.random.RandomState(3)
    feeds = [{"img": rng.rand(2, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (2, 1)).astype(np.int64)}
             for _ in range(2)]
    main = build("port", "vgg16_bn_drop", opt="adam", lr=1e-3)[0]
    params = sorted(p.name for p in main.global_block().all_parameters())
    fc_bn = moving_stats(main)[-2:]
    want, got, _ = train_both(
        "vgg16_bn_drop", feeds,
        lambda m, loss: [loss.name] + fc_bn + [p + "@GRAD" for p in params],
        monkeypatch, opt="adam", lr=1e-3)
    gap = _loss_gap(got, want)
    assert gap[0] <= 1e-4 and gap[1] <= 1e-2, gap
    for a, b in zip(got[0][1:3], want[0][1:3]):
        assert _max_rel(a, b) <= 1e-4
    g_got, g_want = got[0][3:], want[0][3:]
    largest = max(float(np.abs(g).max()) for g in g_want)
    ops = main.global_block().ops
    normed = {op.input("X")[0] for op in ops if op.type == "batch_norm"}
    zero = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"
            and op.output("Out")[0] in normed}
    assert len(zero) == 14
    for name, a, b in zip(params, g_got, g_want):
        if name in zero:
            assert max(np.abs(a).max(), np.abs(b).max()) <= \
                VGG_ZERO_GRAD * largest, name
        else:
            assert _rel_l2(a, b) <= 1e-2, (name, _rel_l2(a, b))


# a gradient that is 0 but for rounding, against the program's largest
VGG_ZERO_GRAD = 1e-4


def test_smallnet_memorizes_one_batch_as_the_reference(monkeypatch):
    """tests/test_book.py's SmallNet step: Momentum(0.01, 0.9) on one
    fixed batch of 16; 8 losses within 1e-4 relative of the reference's,
    falling."""
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(16, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (16, 1)).astype(np.int64)}
    want, got, _ = train_both("smallnet_cifar", [feed] * 8,
                                    lambda m, loss: [loss.name],
                                    monkeypatch, lr=0.01)
    gl = np.array([float(g[0]) for g in got])
    np.testing.assert_allclose(gl, [float(w[0]) for w in want], rtol=1e-4)
    assert np.isfinite(gl).all() and gl[-1] < gl[0]


# ResNet-50 at a small image: 64 px keeps every stage's feature map (down
# to 2x2) and the JAX compile of the step within a CPU test's time
R50_PX, R50_BATCH = 64, 2
# At the reference's initialization the network is chaotic (a one-ulp
# change of every pixel moves its float32 gradients by a median 3% in
# relative L2, and its bf16 gradients lie 1.36 from its float32 ones:
# noise); after R50_WARM_STEPS Momentum steps at R50_WARM_LR on fresh
# seeded batches the same nudge moves them by 4e-6 (under each of ten
# nudges: no relu switches), and bf16 by 0.24.  chip_smoke.py compares
# the card with the CPU after such a warm-up on the card.
R50_WARM_STEPS, R50_WARM_LR = 50, 1e-3
# float32, each to its largest magnitude: the loss (measured 1.9e-7), each
# gradient (6.8e-6) and each moving stat (1.5e-7), summation order alone
R50_LOSS_RTOL, R50_GRAD_RTOL, R50_STAT_RTOL = 1e-5, 1e-4, 1e-5
# bf16: each gradient's distance to the float32 step's (relative L2; the
# reference's own lie at 0.24 median, 0.33 largest, the port's at 0.26,
# 0.37): a gradient at half its size reads 0.5 or more, a zeroed one 1.0
R50_BF16_GRAD_L2 = 2 * GRAD_L2
# bf16: the moving stats (float32 sums of bf16 values) against the
# reference's bf16 step, to their largest magnitude (measured 1.2e-3)
R50_BF16_STAT_RTOL = 2 ** -7


@functools.lru_cache(maxsize=None)
def resnet50_warm():
    """The reference's float32 ``resnet_imagenet(depth=50)`` (1000
    classes, R50_PX px, batch R50_BATCH) after R50_WARM_STEPS steps of
    Momentum(R50_WARM_LR, 0.9) from its startup scope, each on a fresh
    seeded batch -> (the state, the compare step's float32 feed, its
    fetch names: the loss, every parameter's gradient and the 106 moving
    stats, and the reference's float32 fetches of that step)."""
    main, startup, loss = build("jax", "resnet50", px=R50_PX,
                                lr=R50_WARM_LR)
    params = sorted(p.name for p in main.global_block().all_parameters())
    fetch = ([loss.name] + [p + "@GRAD" for p in params]
             + moving_stats(main))
    rng = np.random.RandomState(5)

    def feed():
        return {"img": rng.rand(R50_BATCH, 3, R50_PX, R50_PX).astype(
            np.float32), "label": rng.randint(0, 1000, (R50_BATCH, 1))
            .astype(np.int64)}

    scope, _ = _jax_init(startup)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        for _ in range(R50_WARM_STEPS):
            exe.run(main, feed=feed(), fetch_list=[loss])
        warm = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        f = feed()
        ref32 = [np.asarray(v) for v in exe.run(main, feed=f,
                                                 fetch_list=fetch)]
    return warm, f, fetch, ref32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet50_step_matches_reference(dtype, monkeypatch):
    """One Momentum step of ``resnet_imagenet(depth=50)`` at R50_PX px and
    batch R50_BATCH from ``resnet50_warm``'s state, in both packages: the
    loss, every parameter's gradient and the 106 moving stats after the
    step, all float32.  float32: each within the R50_* limits of the
    reference's, element by element.  The bf16 recipe (bf16 images, f32
    masters): the loss within LOSS_RTOL and the stats within
    R50_BF16_STAT_RTOL of the reference's bf16 step; each gradient within
    R50_BF16_GRAD_L2 of the reference's float32 step from the same state,
    and the port's distances to it, in the median and the largest over
    parameters, within NOISE_RATIO of the reference's bf16 step's
    (measured 1.07x, 1.13x), PERF.md section 2's amp rule.  Faults
    planted in the port's batch_norm fail both dtypes: X's gradient
    halved in every norm (the first norm's offset gradient 1.0 from the
    reference's, to its largest in float32 and in relative L2 in bf16:
    the halvings compound), the terms through the statistics dropped
    (38 and 55), the unbiased variance (the loss); the offset gradients
    alone halved fail bf16 at 0.58."""
    warm, img_feed, fetch, ref32 = resnet50_warm()
    f32 = dtype == "float32"
    feed = dict(img_feed, img=img_feed["img"] if f32
                else img_feed["img"].astype(BF16))
    want, got, _ = train_both("resnet50", [feed], lambda m, loss: fetch,
                              monkeypatch, init=warm, dtype=dtype,
                              px=R50_PX)
    n = sum(name.endswith("@GRAD") for name in fetch)

    def parts(run):
        return run[0], run[1:1 + n], run[1 + n:]

    (l_got, g_got, s_got), (l_want, g_want, s_want) = parts(got[0]), \
        parts(want[0])
    assert {v.dtype for v in g_got + s_got} == {np.dtype(np.float32)}
    if f32:
        np.testing.assert_allclose(l_got, l_want, rtol=R50_LOSS_RTOL)
        for name, a, b in zip(fetch[1:], g_got + s_got, g_want + s_want):
            tol = R50_GRAD_RTOL if name.endswith("@GRAD") else R50_STAT_RTOL
            assert _max_rel(a, b) <= tol, (name, _max_rel(a, b))
        return
    np.testing.assert_allclose(float(l_got), float(l_want), rtol=LOSS_RTOL)
    for name, a, b in zip(fetch[1 + n:], s_got, s_want):
        assert _max_rel(a, b) <= R50_BF16_STAT_RTOL, (name, _max_rel(a, b))
    g32 = parts(ref32)[1]
    port = [_rel_l2(a, f) for a, f in zip(g_got, g32)]
    ref = [_rel_l2(b, f) for b, f in zip(g_want, g32)]
    worst = int(np.argmax(port))
    assert port[worst] <= R50_BF16_GRAD_L2, (fetch[1 + worst], port[worst])
    assert np.median(port) <= NOISE_RATIO * np.median(ref), \
        (np.median(port), np.median(ref))
    assert max(port) <= NOISE_RATIO * max(ref), (max(port), max(ref))


def test_resnet_cifar10_for_test_clone_uses_the_moving_stats():
    """The book's test program, ``main.clone(for_test=True)`` of the
    depth-8 CIFAR ResNet taken before the optimizer, evaluated from the
    reference's scope after 5 training steps (moving stats away from
    their 0 / 1 start): every batch_norm has ``is_test``, the port's
    predictions on a new batch equal the reference's (float32, 1e-5
    relative) and come from the moving stats (one image alone gets the
    prediction it gets within the batch), and the moving stats stay as
    they were."""
    feeds = cifar_feeds(6)
    jtest, ttest = [], []
    jm, js, jloss = build("jax", "resnet_cifar10_d8", lr=0.02, tests=jtest)
    tm, _, _ = build("port", "resnet_cifar10_d8", lr=0.02, tests=ttest)
    assert ttest[0].serialize_to_string() == jtest[0].serialize_to_string()
    test, out = ttest[0], ttest[1].name
    stats = moving_stats(tm)
    jscope, _ = _jax_init(js)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        for f in feeds[:5]:
            jexe.run(jm, feed=f, fetch_list=[jloss])
        want = jexe.run(jtest[0], feed=feeds[5], fetch_list=[out])[0]
        trained = {n: np.asarray(jscope.find_var(n)) for n in jscope.vars
                   if jscope.find_var(n) is not None}
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(trained, cpu)
    texe = tfluid.Executor(cpu)
    assert all(op.attr("is_test") for op in test.global_block().ops
               if op.type == "batch_norm")
    got = texe.run(test, feed=feeds[5], fetch_list=[out], scope=tscope)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    one = {k: v[:1] for k, v in feeds[5].items()}
    alone = texe.run(test, feed=one, fetch_list=[out], scope=tscope)[0]
    np.testing.assert_allclose(alone, got[:1], rtol=1e-5, atol=1e-7)
    after = tfluid.scope_to_numpy(tscope, stats)
    assert all(np.array_equal(trained[n], after[n]) for n in stats)
    assert not all(np.array_equal(trained[n], 0 * trained[n])
                   for n in stats[::2])
