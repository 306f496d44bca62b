"""The rest of ``nn_ops.py`` in the port (``fluid/ops/nn_ops.py``:
``depthwise_conv2d``, ``conv2d_transpose``, ``conv3d``, ``pool3d``,
``l2_normalize``, ``nce``, ``im2sequence``) and the recurrent step ops
``lstm_unit`` / ``gru_unit`` against the JAX package on the CPU.

* Every op through both emitters on numpy-seeded inputs: float32
  outputs within OUT_RTOL of their largest magnitude, the gradients of
  sum(out * w) (a seeded w) within GRAD_RTOL of theirs (float32,
  summation order only).  ``pool3d`` max and average, with padding,
  ``ceil_mode`` (a last partial window) and ``global_pooling``.
* ``im2sequence`` bit for bit, and its features channel-major: an
  image whose value encodes (channel, row, column) reads back in
  ``conv_general_dilated_patches``' (c, kh, kw) order.
* ``nce``: with 0 negatives the reference's cost exactly; with k the
  port's cost on its own draws (``nn_ops.nce_negatives``) against the
  reference's formula on those ids, and the draws uniform (a chi-square
  test at a 1e-4 false-alarm rate) and fresh under another seed.
* The six layers build the reference's program bytes.

``compare_op`` is the harness of ``test_torch_ctc.py`` and
``test_torch_detection.py`` too.
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
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.ops import nn_ops
from tests.test_torch_amp import _emit

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4

PKG = {"jax": (jreg, JOpDesc, jlod, jnp.asarray),
       "port": (treg, TOpDesc, tlod, torch.tensor)}


def _value(pkg, spec, leaves=None):
    """An input from its spec: ("t", array), ("seq", array, lengths) or
    ("list", [arrays]); ``leaves`` replace its float arrays."""
    _, _, lod, conv = PKG[pkg]
    arrays = spec[1] if spec[0] == "list" else [spec[1]]
    vals = [conv(a) if leaves is None else leaves[i]
            for i, a in enumerate(arrays)]
    if spec[0] == "seq":
        return [lod.SeqArray(vals[0], conv(spec[2]))]
    return vals


def run_op(pkg, op_type, specs, attrs, leaves=None, seed=None):
    """One emitter call -> {slot: [values]}."""
    reg, Desc, _, _ = PKG[pkg]
    leaves = leaves or {}
    ins = {s: _value(pkg, spec, leaves.get(s)) for s, spec in specs.items()}
    kw = ({"rng": jax.random.key(seed or 0)} if pkg == "jax"
          else {"seed": seed})
    return _emit(reg, Desc, op_type, ins, attrs, **kw)


def parts(v):
    """A value's arrays as numpy: a SeqArray's data and lengths."""
    if isinstance(v, (jlod.SeqArray, tlod.SeqArray)):
        return [as_np(v.data), as_np(v.lengths)]
    return [as_np(v)]


def as_np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def rel_err(got, want):
    """The largest difference over the largest magnitude of ``want``,
    over its finite entries; inf where the non-finite entries differ (a
    max-pool window wholly in the padding is -inf in both)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(got[~fin], want[~fin], equal_nan=True) \
            or not np.isfinite(got[fin]).all():
        return float("inf")
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max()
                 / max(np.abs(want[fin]).max(), 1e-30))


def compare_op(op_type, specs, attrs, wrt=(), grad_slots=None,
               exact=False):
    """Both emitters on ``specs``: the outputs of every slot (shapes,
    dtypes; integers exactly, floats within OUT_RTOL of their largest,
    or bit for bit where ``exact``); then, for the slots ``wrt``, the
    gradients of sum(out * w) over the float outputs of ``grad_slots``
    (default: every float output) within GRAD_RTOL of their largest.
    -> (the reference's outputs, the port's)."""
    jo = run_op("jax", op_type, specs, attrs)
    to = run_op("port", op_type, specs, attrs)
    assert sorted(jo) == sorted(to)
    for slot in jo:
        assert len(jo[slot]) == len(to[slot]), slot
        for jv, tv in zip(jo[slot], to[slot]):
            for a, b in zip(parts(jv), parts(tv)):
                assert b.shape == a.shape, (slot, b.shape, a.shape)
                if a.dtype.kind in "biu" or exact:
                    assert b.dtype == a.dtype, (slot, b.dtype, a.dtype)
                    np.testing.assert_array_equal(b, a, err_msg=slot)
                else:
                    assert b.dtype == a.dtype, (slot, b.dtype, a.dtype)
                    assert rel_err(b, a) <= OUT_RTOL, (slot, rel_err(b, a))
    if not wrt:
        return jo, to
    slots = sorted(grad_slots or [s for s in jo
                                  if parts(jo[s][0])[0].dtype.kind == "f"])
    ws = {s: [np.asarray(np.random.RandomState(30 + i).randn(
        *parts(v)[0].shape), np.float32)
        for i, v in enumerate(jo[s])] for s in slots}
    floats = {s: (specs[s][1] if specs[s][0] == "list" else [specs[s][1]])
              for s in wrt}

    def total(outs, conv):
        return sum((parts_raw(v) * conv(w)).sum()
                   for s in slots for v, w in zip(outs[s], ws[s]))

    def f(*xs):
        leaves, k = {}, 0
        for s in wrt:
            n = len(floats[s])
            leaves[s], k = list(xs[k:k + n]), k + n
        return total(run_op("jax", op_type, specs, attrs, leaves),
                     jnp.asarray)

    flat = [a for s in wrt for a in floats[s]]
    jg = jax.grad(f, argnums=tuple(range(len(flat))))(
        *[jnp.asarray(a) for a in flat])
    tl = [torch.tensor(a, requires_grad=True) for a in flat]
    leaves, k = {}, 0
    for s in wrt:
        n = len(floats[s])
        leaves[s], k = tl[k:k + n], k + n
    total(run_op("port", op_type, specs, attrs, leaves),
          torch.tensor).backward()
    for i, (t, g) in enumerate(zip(tl, jg)):
        assert t.grad is not None, f"grad {i}"
        assert rel_err(t.grad.numpy(), g) <= GRAD_RTOL, \
            (f"grad {i}", rel_err(t.grad.numpy(), g))
    return jo, to


def parts_raw(v):
    """A value's differentiable array (a SeqArray's data)."""
    return v.data if isinstance(v, (jlod.SeqArray, tlod.SeqArray)) else v


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


OP_CASES = {
    "depthwise_conv2d": ({"Input": ("t", _r(0, 2, 6, 9, 8)),
                          "Filter": ("t", _r(1, 6, 1, 3, 3))},
                         {"strides": [2, 1], "paddings": [1, 1]},
                         ("Input", "Filter")),
    "conv2d_transpose": ({"Input": ("t", _r(2, 2, 4, 5, 6)),
                          "Filter": ("t", _r(3, 4, 3, 3, 2))},
                         {"strides": [2, 3], "paddings": [1, 0]},
                         ("Input", "Filter")),
    "conv2d_transpose/unit": ({"Input": ("t", _r(4, 1, 3, 4, 4)),
                               "Filter": ("t", _r(5, 3, 5, 2, 2))}, {},
                              ("Input", "Filter")),
    "conv3d": ({"Input": ("t", _r(6, 2, 4, 5, 6, 7)),
                "Filter": ("t", _r(7, 6, 2, 3, 2, 3))},
               {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                "dilations": [1, 1, 2], "groups": 2},
               ("Input", "Filter")),
    "pool3d/max": ({"X": ("t", _r(8, 2, 3, 6, 7, 5))},
                   {"pooling_type": "max", "ksize": [2, 3, 2],
                    "strides": [2, 2, 1]}, ("X",)),
    "pool3d/max_pad_ceil": ({"X": ("t", _r(9, 2, 3, 7, 6, 5))},
                            {"pooling_type": "max", "ksize": [3, 3, 2],
                             "strides": [2, 2, 2], "paddings": [1, 0, 1],
                             "ceil_mode": True}, ("X",)),
    "pool3d/avg": ({"X": ("t", _r(10, 2, 3, 6, 6, 4))},
                   {"pooling_type": "avg", "ksize": [2, 2, 2],
                    "strides": [2, 2, 2]}, ("X",)),
    "pool3d/avg_pad": ({"X": ("t", _r(11, 2, 3, 5, 6, 4))},
                       {"pooling_type": "avg", "ksize": [3, 3, 3],
                        "strides": [1, 2, 1], "paddings": [1, 1, 0]},
                       ("X",)),
    "pool3d/avg_ceil": ({"X": ("t", _r(12, 2, 3, 7, 5, 6))},
                        {"pooling_type": "avg", "ksize": [2, 2, 3],
                         "strides": [2, 2, 2], "ceil_mode": True}, ("X",)),
    "pool3d/max_global": ({"X": ("t", _r(13, 2, 3, 4, 5, 3))},
                          {"pooling_type": "max", "global_pooling": True,
                           "ksize": [1, 1, 1]}, ("X",)),
    "pool3d/avg_global": ({"X": ("t", _r(14, 2, 3, 4, 5, 3))},
                          {"pooling_type": "avg", "global_pooling": True,
                           "ceil_mode": True}, ("X",)),
    "l2_normalize": ({"X": ("t", _r(15, 4, 5, 6))}, {"axis": 1}, ("X",)),
    "l2_normalize/last": ({"X": ("t", _r(16, 7, 9))}, {}, ("X",)),
    "lstm_unit": ({"X": ("t", _r(17, 5, 4 * 6)),
                   "C_prev": ("t", _r(18, 5, 6))}, {"forget_bias": 0.5},
                  ("X", "C_prev")),
    "gru_unit": ({"Input": ("t", _r(19, 5, 3 * 6)),
                  "HiddenPrev": ("t", _r(20, 5, 6)),
                  "Weight": ("t", _r(21, 6, 3 * 6, scale=0.5)),
                  "Bias": ("t", _r(22, 1, 3 * 6))}, {},
                 ("Input", "HiddenPrev", "Weight", "Bias")),
    "gru_unit/no_bias_relu": ({"Input": ("t", _r(23, 3, 3 * 4)),
                               "HiddenPrev": ("t", _r(24, 3, 4)),
                               "Weight": ("t", _r(25, 4, 3 * 4))},
                              {"activation": "relu",
                               "gate_activation": "sigmoid"},
                              ("Input", "HiddenPrev", "Weight")),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    specs, attrs, wrt = OP_CASES[case]
    compare_op(case.split("/")[0], specs, attrs, wrt)


@pytest.mark.parametrize("attrs", [
    {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0]},
    {"kernels": [3, 3], "strides": [3, 3]}, {}])
def test_im2sequence_matches_reference_bitwise(attrs):
    compare_op("im2sequence", {"X": ("t", _r(30, 2, 3, 7, 8))}, attrs,
               exact=True)


def test_im2sequence_features_are_channel_major():
    """F.unfold's feature order is conv_general_dilated_patches': feature
    f of a patch at (0, 0) is channel f // (kh kw), row (f // kw) % kh,
    column f % kw."""
    c, h, w, kh, kw = 3, 4, 5, 2, 3
    code = (np.arange(c)[:, None, None] * 100 + np.arange(h)[None, :, None]
            * 10 + np.arange(w)[None, None, :]).astype(np.float32)
    attrs = {"kernels": [kh, kw]}
    jo, to = compare_op("im2sequence", {"X": ("t", code[None])}, attrs,
                        exact=True)
    first = as_np(to["Out"][0])[0, 0]
    f = np.arange(c * kh * kw)
    np.testing.assert_array_equal(
        first, (f // (kh * kw)) * 100 + (f // kw) % kh * 10 + f % kw)


def _nce_specs(batch=6, dim=5, classes=11):
    rng = np.random.RandomState(40)
    return {"Input": ("t", _r(41, batch, dim)),
            "Label": ("t", rng.randint(0, classes, (batch, 1))
                      .astype(np.int32)),
            "Weight": ("t", _r(42, classes, dim)),
            "Bias": ("t", _r(43, classes))}, classes


def test_nce_with_no_negatives_is_the_reference():
    specs, classes = _nce_specs()
    compare_op("nce", specs, {"num_total_classes": classes,
                              "num_neg_samples": 0},
               ("Input", "Weight", "Bias"))


def _reference_nce_formula(x, label, w, b, neg):
    """reference nce_op (nn_ops.py:276) on given negative ids, in JAX."""
    pos = label.reshape(-1, 1).astype(jnp.int32)
    ids = jnp.concatenate([pos, neg.astype(jnp.int32)], axis=1)
    logits = jnp.einsum("bd,bkd->bk", x, jnp.take(w, ids, axis=0)) \
        + jnp.take(b, ids, axis=0)
    labels = jnp.concatenate([jnp.ones((x.shape[0], 1)),
                              jnp.zeros((x.shape[0], neg.shape[1]))], 1)
    loss = jnp.maximum(logits, 0) - logits * labels + jnp.log1p(
        jnp.exp(-jnp.abs(logits)))
    return loss.sum(axis=1, keepdims=True)


def test_nce_on_its_own_draws_is_the_reference_formula():
    specs, classes = _nce_specs()
    k, seed = 7, 12345
    attrs = {"num_total_classes": classes, "num_neg_samples": k}
    leaves = {s: [torch.tensor(specs[s][1], requires_grad=True)]
              for s in ("Input", "Weight", "Bias")}
    cost = run_op("port", "nce", specs, attrs, leaves, seed=seed)["Cost"][0]
    neg = nn_ops.nce_negatives(seed, 6, k, classes, torch.device("cpu"))
    assert neg.shape == (6, k) and int(neg.min()) >= 0 \
        and int(neg.max()) < classes
    arrays = [jnp.asarray(specs[s][1]) for s in ("Input", "Weight", "Bias")]
    lbl, nj = jnp.asarray(specs["Label"][1]), jnp.asarray(neg.numpy())
    want = _reference_nce_formula(arrays[0], lbl, arrays[1], arrays[2], nj)
    assert cost.shape == (6, 1)
    assert rel_err(cost.detach().numpy(), want) <= OUT_RTOL
    w = _r(44, 6, 1)
    (cost * torch.tensor(w)).sum().backward()
    jg = jax.grad(lambda x, wt, b: (_reference_nce_formula(
        x, lbl, wt, b, nj) * w).sum(), argnums=(0, 1, 2))(*arrays)
    for s, g in zip(("Input", "Weight", "Bias"), jg):
        assert rel_err(leaves[s][0].grad.numpy(), g) <= GRAD_RTOL, s
    # the same seed draws the same ids; another draws others
    again = nn_ops.nce_negatives(seed, 6, k, classes, torch.device("cpu"))
    other = nn_ops.nce_negatives(seed + 1, 6, k, classes,
                                 torch.device("cpu"))
    assert torch.equal(neg, again) and not torch.equal(neg, other)


def test_nce_negatives_are_uniform():
    """200 x 500 draws over 37 classes: the chi-square statistic of the
    counts below the 1e-4 upper quantile of chi2(36), 74.0."""
    classes, n = 37, 200 * 500
    ids = nn_ops.nce_negatives(2024, 200, 500, classes, torch.device("cpu"))
    counts = np.bincount(ids.numpy().ravel(), minlength=classes)
    assert counts.shape == (classes,)
    expect = n / classes
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 74.0, chi2


def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, 8, 8], "float32")
        vol = fluid.layers.data("vol", [2, 4, 6, 6], "float32")
        lbl = fluid.layers.data("lbl", [1], "int64")
        up = fluid.layers.conv2d_transpose(img, 4, filter_size=3, stride=2,
                                           padding=1, act="relu")
        seq = fluid.layers.im2sequence(up, filter_size=2, stride=2)
        v = fluid.layers.conv3d(vol, 3, 3, padding=1, act="relu")
        v = fluid.layers.pool3d(v, 2, "avg", 2, ceil_mode=True)
        feat = fluid.layers.l2_normalize(
            fluid.layers.reshape(v, [-1, 3 * 2 * 3 * 3]), axis=1)
        cost = fluid.layers.nce(feat, lbl, num_total_classes=13,
                                num_neg_samples=4)
        loss = fluid.layers.mean(cost)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, seq


def test_layers_build_the_reference_program():
    j, t = _layers_program(jfluid), _layers_program(tfluid)
    for a, b in zip(j[:2], t[:2]):
        assert b.serialize_to_string() == a.serialize_to_string()
    assert tuple(t[2].shape) == tuple(j[2].shape)
    ops = [op.type for op in t[0].global_block().ops]
    for op in ("conv2d_transpose", "im2sequence", "conv3d", "pool3d",
               "l2_normalize", "nce", "nce_grad", "conv3d_grad"):
        assert op in ops, op


def test_im2sequence_lod_reset_fc_cannot_be_built_in_the_reference():
    """ROADMAP C8: the CRNN-CTC shape im2sequence -> lod_reset -> fc does
    not build in the reference: ``lod_reset``'s output var has no shape
    (its layer is ``_single_out_layer``, whose inference fails here), so
    ``fc`` raises at ``input_shape[1:]``.  The port's ``im2sequence``
    declares the reference's output shape, and its ``lod_reset`` layer
    is the reference's: it leaves the shape undeclared, and ``fc``
    raises where the reference's raises."""
    shapes = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            img = fluid.layers.data("img", [1, 32, 100], "float32")
            seq = fluid.layers.im2sequence(img, filter_size=[32, 1])
            shapes.append(tuple(seq.shape))
            lens = fluid.layers.data("lens", [1], "int32")
            reset = fluid.layers.lod_reset(seq, y=lens)
            assert reset.shape is None
            assert reset.lod_level == 1
            with pytest.raises(TypeError, match="NoneType"):
                fluid.layers.fc(reset, 10)
    assert shapes[0] == shapes[1] == (-1, 100, 32)
