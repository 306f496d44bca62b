"""The rest of ``loss_ops.py`` and ``misc_ops.py`` in the port (34 ops)
and their 26 layers against the JAX package on the CPU.

* Every op through both emitters (``compare_op``): float32 outputs
  within OUT_RTOL of their largest magnitude, the gradients of
  sum(out * w) within GRAD_RTOL of theirs; bit for bit where the op is
  exact (shape surgery, ``max_pool2d_with_index``'s values and first-
  maximum indices, ``unpool`` at stride = kernel, ``spp``'s max,
  ``is_empty``, ``assign_value``, ``auc`` and ``precision_recall``).
* bf16 inputs for the ops with float attrs: the attrs rounded to bf16
  as the reference's weak typing rounds them (``weak_scalar``).
* ``roi_pool`` against the reference as its Executor computes it (under
  ``jax.jit``: XLA folds ``i * rh / ph`` into rh times a float32
  constant, which moves bin edges), with tied maxima (an even gradient
  split), empty bins, RoIs past the map and RoIs whose edges fall on
  bin boundaries: outputs bit for bit, gradients within GRAD_RTOL.
* ``sampling_id`` by statistics: a chi-square test of 20,000 draws per
  row at a 1e-4 false-alarm rate against the row's distribution.
* The 26 layers build the reference's program bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.ops import loss_ops, misc_ops
from tests.test_torch_amp import BF16, _both, _emit
from tests.test_torch_conv_ops import (GRAD_RTOL, as_np, compare_op,
                                       rel_err, run_op)
from tests.test_torch_optim import _bf16_ulps


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _u(seed, *shape, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ints(seed, hi, *shape, dtype=np.int32):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(dtype)


def _beam_case(seed, B=3, C=(5, 6, 4), K=(2, 3, 2)):
    """Scores, ids and gold of 3 beam expansions: step 0 one row of
    C[0] candidates, K[0] selected; expansion i's rows are expansion i -
    1's live selections.  Row 0's gold stays on the beam, row 1's falls
    off at step 1, row 2 selects -1 in a slot."""
    rng = np.random.RandomState(seed)
    scores, ids, gold = [], [], []
    rows = 1
    for i in range(3):
        sc = rng.randn(B, rows, C[i]).astype(np.float32)
        sel = np.stack([np.stack([rng.permutation(C[i])[:K[i]]
                                  for _ in range(rows)])
                        for _ in range(B)]).astype(np.int32)
        sel[2, -1, -1] = -1
        g = sel[:, 0, 0].copy()
        if i == 1:
            g[1] = [c for c in range(C[i]) if c not in sel[1, 0]][0]
        scores.append(sc[:, 0] if i == 0 else sc)
        ids.append(sel[:, 0] if i == 0 else sel)
        gold.append(g)
        rows = rows * K[i]
    return {"Scores": ("list", scores), "Ids": ("list", ids),
            "Gold": ("list", gold)}


_LABELS = np.random.RandomState(3).randint(0, 2, (20, 1)).astype(np.float32)

# name -> (op, specs, attrs, wrt, exact)
OP_CASES = {
    "cross_entropy_with_selfnorm": (
        "cross_entropy_with_selfnorm",
        {"X": ("t", _u(0, 6, 7, lo=0.05, hi=1.0)),
         "Label": ("t", _ints(1, 7, 6, 1))},
        {"softmax_selfnorm_alpha": 0.3}, ("X",), False),
    "cross_entropy_over_beam": (
        "cross_entropy_over_beam", _beam_case(2), {}, ("Scores",), False),
    "smooth_l1_loss": ("smooth_l1_loss",
                       {"X": ("t", _r(3, 5, 8)), "Y": ("t", _r(4, 5, 8))},
                       {"sigma": 1.5}, ("X", "Y"), False),
    "huber_loss": ("huber_loss",
                   {"X": ("t", _r(5, 6, 1)), "Y": ("t", _r(6, 6, 1))},
                   {"delta": 0.7}, ("X", "Y"), False),
    "hinge_loss": ("hinge_loss",
                   {"Logits": ("t", _r(7, 9, 1)),
                    "Labels": ("t", _ints(8, 2, 9, 1).astype(np.float32))},
                   {}, ("Logits",), False),
    "squared_l2_distance": ("squared_l2_distance",
                            {"X": ("t", _r(9, 5, 4)),
                             "Y": ("t", _r(10, 5, 4))}, {}, ("X", "Y"),
                            False),
    "squared_l2_distance/broadcast": (
        "squared_l2_distance", {"X": ("t", _r(11, 5, 4)),
                                "Y": ("t", _r(12, 1, 4))}, {},
        ("X", "Y"), False),
    "auc": ("auc", {"Out": ("t", np.round(_u(13, 20, 2) * 4) / 4),
                    "Indices": ("t", _ints(14, 2, 20, 1)),
                    "Label": ("t", _LABELS.astype(np.int32))},
            {"curve": "ROC", "num_thresholds": 200}, (), True),
    "precision_recall": ("precision_recall",
                         {"MaxProbs": ("t", _u(15, 30, 1)),
                          "Indices": ("t", _ints(16, 5, 30, 1)),
                          "Labels": ("t", _ints(17, 5, 30, 1))},
                         {"class_number": 5}, (), True),
    "pad": ("pad", {"X": ("t", _r(18, 2, 3, 4))},
            {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": 0.5}, ("X",),
            True),
    "crop": ("crop", {"X": ("t", _r(19, 4, 5, 6))},
             {"offsets": [1, 0, 2], "shape": [-1, 3, 3]}, ("X",), True),
    "crop/y": ("crop", {"X": ("t", _r(20, 4, 5, 6)),
                        "Y": ("t", np.zeros((2, 5, 1), np.float32))},
               {"offsets": [2, 0, 4]}, ("X",), True),
    "rotate": ("rotate", {"X": ("t", _r(21, 2, 3, 4, 5))}, {}, ("X",),
               True),
    "scale_sub_region": ("scale_sub_region",
                         {"X": ("t", _r(22, 2, 3, 5, 6)),
                          "Indices": ("t", np.int32([[1, 2, 2, 4, 1, 6],
                                                     [3, 3, 1, 1, 2, 3]]))},
                         {"value": 2.5}, ("X",), True),
    "selective_fc": ("selective_fc",
                     {"X": ("t", _r(23, 6, 5)), "W": ("t", _r(24, 5, 9)),
                      "Select": ("t", np.int32([[0, 3, 3, -1],
                                                [8, 1, 0, 2],
                                                [3, 3, 3, 3],
                                                [-1, -1, 4, 5],
                                                [7, 6, 5, 4],
                                                [2, 2, -1, 0]])),
                      "Bias": ("t", _r(25, 9))}, {},
                     ("X", "W", "Bias"), False),
    "label_smooth": ("label_smooth", {"X": ("t", _u(26, 5, 6))},
                     {"epsilon": 0.2}, ("X",), False),
    "label_smooth/prior": ("label_smooth",
                           {"X": ("t", _u(27, 5, 6)),
                            "PriorDist": ("t", _u(28, 1, 6))},
                           {"epsilon": 0.15}, ("X", "PriorDist"), False),
    "rank_loss": ("rank_loss", {"Label": ("t", _LABELS[:8]),
                                "Left": ("t", _r(29, 8, 1)),
                                "Right": ("t", _r(30, 8, 1))}, {},
                  ("Left", "Right"), False),
    "margin_rank_loss": ("margin_rank_loss",
                         {"Label": ("t", np.float32([[1], [-1], [1], [-1],
                                                     [1], [1]])),
                          "X1": ("t", _r(31, 6, 1)),
                          "X2": ("t", _r(32, 6, 1))}, {"margin": 0.3},
                         ("X1", "X2"), False),
    "log_loss": ("log_loss", {"Predicted": ("t", _u(33, 7, 1, lo=0.05,
                                                    hi=0.95)),
                              "Labels": ("t", _LABELS[:7])},
                 {"epsilon": 1e-3}, ("Predicted",), False),
    "modified_huber_loss": ("modified_huber_loss",
                            {"X": ("t", _r(34, 12, 1, scale=2.0)),
                             "Y": ("t", _LABELS[:12])}, {}, ("X",), False),
    "conv_shift": ("conv_shift", {"X": ("t", _r(35, 4, 9)),
                                  "Y": ("t", _r(36, 4, 3))}, {},
                   ("X", "Y"), False),
    "row_conv": ("row_conv",
                 {"X": ("seq", _r(37, 3, 7, 4), np.int32([7, 3, 1])),
                  "Filter": ("t", _r(38, 3, 4))}, {}, ("X", "Filter"),
                 False),
    "max_pool2d_with_index": ("max_pool2d_with_index",
                              {"X": ("t", np.round(_r(39, 2, 3, 7, 8))
                                     / 2)},
                              {"ksize": [3, 2], "strides": [2, 2]},
                              ("X",), True),
    "spp": ("spp", {"X": ("t", np.round(_r(40, 2, 3, 5, 7)))},
            {"pyramid_height": 3, "pooling_type": "max"}, ("X",), True),
    "spp/deep": ("spp", {"X": ("t", _r(41, 1, 2, 3, 3))},
                 {"pyramid_height": 3}, ("X",), True),
    "spp/avg": ("spp", {"X": ("t", _r(42, 2, 3, 8, 6))},
                {"pyramid_height": 3, "pooling_type": "avg"}, ("X",),
                False),
    "bilinear_interp": ("bilinear_interp", {"X": ("t", _r(43, 2, 3, 4, 5))},
                        {"out_h": 7, "out_w": 9}, ("X",), False),
    "bilinear_interp/down": ("bilinear_interp",
                             {"X": ("t", _r(44, 1, 2, 9, 8))},
                             {"out_h": 4, "out_w": 1}, ("X",), False),
    "minus": ("minus", {"X": ("t", _r(45, 4, 5)), "Y": ("t", _r(46, 4, 5))},
              {}, ("X", "Y"), True),
    "l1_norm": ("l1_norm", {"X": ("t", _r(47, 4, 5))}, {}, ("X",), False),
    "is_empty": ("is_empty", {"X": ("t", _r(48, 4, 5))}, {}, (), True),
    "is_empty/empty": ("is_empty", {"X": ("t", np.zeros((0, 3),
                                                        np.float32))}, {},
                       (), True),
    "assign_value": ("assign_value", {},
                     {"shape": [2, 3], "fp32_values": [0.1, -2.0, 3.5, 1e-7,
                                                       0.0, 7.25]}, (),
                     True),
    "assign_value/int": ("assign_value", {},
                         {"shape": [4], "int32_values": [3, -1, 0, 7]}, (),
                         True),
    "bilinear_tensor_product": ("bilinear_tensor_product",
                                {"X": ("t", _r(49, 5, 3)),
                                 "Y": ("t", _r(50, 5, 4)),
                                 "Weight": ("t", _r(51, 6, 3, 4)),
                                 "Bias": ("t", _r(52, 1, 6))}, {},
                                ("X", "Y", "Weight", "Bias"), False),
    "hsigmoid": ("hsigmoid", {"X": ("t", _r(53, 8, 5)),
                              "Label": ("t", np.int32([[0], [1], [6], [3],
                                                       [5], [2], [6], [4]])),
                              "W": ("t", _r(54, 6, 5)),
                              "Bias": ("t", _r(55, 6))},
                 {"num_classes": 7}, ("X", "W", "Bias"), False),
    "hsigmoid/no_bias": ("hsigmoid", {"X": ("t", _r(56, 6, 4)),
                                      "Label": ("t", _ints(57, 100, 6, 1)),
                                      "W": ("t", _r(58, 99, 4))},
                         {"num_classes": 100}, ("X", "W"), False),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op, specs, attrs, wrt, exact = OP_CASES[case]
    compare_op(op, specs, attrs, wrt, exact=exact)


def test_unpool_at_stride_equal_to_kernel_is_the_reference_bitwise():
    """max_pool2d_with_index then unpool (2 x 2, stride 2): every pooled
    value back at its first maximum, zeros elsewhere; gradients too."""
    x = np.round(_r(60, 2, 3, 6, 8) * 2) / 2            # ties
    _, to = compare_op("max_pool2d_with_index", {"X": ("t", x)},
                       {"ksize": [2, 2], "strides": [2, 2]}, ("X",),
                       exact=True)
    pooled, mask = (as_np(to[s][0]) for s in ("Out", "Mask"))
    compare_op("unpool", {"X": ("t", pooled), "Indices": ("t", mask)},
               {"unpooled_size": [6, 8]}, ("X",), exact=True)


def test_lod_reset_matches_reference():
    x = ("seq", _r(61, 3, 5, 2), np.int32([5, 2, 4]))
    compare_op("lod_reset", {"X": x, "Y": ("seq", _r(62, 3, 5, 1),
                                           np.int32([1, 5, 3]))}, {},
               ("X",), exact=True)
    compare_op("lod_reset", {"X": x}, {"target_lod": [0, 2, 2, 5]},
               ("X",), exact=True)


# -- bf16 X beside float attrs: the attrs rounded as the reference rounds
# them.  (op, arrays, attrs, out slot, wrt); outputs within BF16_ULPS bf16
# ulps, gradients within BF16_GRAD of their largest
BF16_ULPS, BF16_GRAD = 1, 1e-2
BF16_CASES = {
    "smooth_l1_loss": ("smooth_l1_loss", {"X": _r(70, 6, 1, scale=0.3),
                                          "Y": _r(71, 6, 1, scale=0.3)},
                       {"sigma": 1.3}, "Out", ("X",)),
    "huber_loss": ("huber_loss", {"X": _r(72, 8, 1), "Y": _r(73, 8, 1)},
                   {"delta": 0.7}, "Out", ("X",)),
    "scale_sub_region": ("scale_sub_region",
                         {"X": _r(74, 2, 2, 3, 3),
                          "Indices": np.int32([[1, 2, 1, 2, 2, 3],
                                               [2, 2, 3, 3, 1, 1]])},
                         {"value": 0.3}, "Out", ("X",)),
    "label_smooth": ("label_smooth", {"X": _u(75, 4, 6)},
                     {"epsilon": 0.1}, "Out", ("X",)),
    "margin_rank_loss": ("margin_rank_loss",
                         {"Label": np.float32([[1], [-1], [1], [1]]),
                          "X1": _r(76, 4, 1), "X2": _r(77, 4, 1)},
                         {"margin": 0.3}, "Out", ("X1",)),
    "log_loss": ("log_loss", {"Predicted": _u(78, 6, 1, lo=0.1, hi=0.9),
                              "Labels": _LABELS[:6]},
                 {"epsilon": 0.03}, "Loss", ("Predicted",)),
    "cross_entropy_with_selfnorm": (
        "cross_entropy_with_selfnorm",
        {"X": _u(79, 4, 5, lo=0.1), "Label": _ints(80, 5, 4, 1)},
        {"softmax_selfnorm_alpha": 0.3}, "Out", ("X",)),
    "pad": ("pad", {"X": _r(81, 2, 3)},
            {"paddings": [1, 0, 0, 2], "pad_value": 0.1}, "Out", ("X",)),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_float_attrs_round_as_the_reference(case):
    op, arrays, attrs, slot, wrt = BF16_CASES[case]
    arrays = {s: a.astype(BF16) if a.dtype == np.float32 else a
              for s, a in arrays.items()}
    jo, to, jg, tg = _both(op, arrays, attrs, slot, wrt)
    want, got = np.asarray(jo[slot][0]), to[slot][0]
    assert got.dtype == want.dtype == BF16
    assert _bf16_ulps(got, want).max() <= BF16_ULPS, case
    for a, b in zip(tg, jg):
        b = np.asarray(b).astype(np.float32)
        np.testing.assert_allclose(a.astype(np.float32), b, rtol=0,
                                   atol=BF16_GRAD * np.abs(b).max())


# -- roi_pool against the reference's compiled op

def _roi_reference(x, rois, attrs, w):
    """The reference's roi_pool emitter under jax.jit (as its Executor
    runs it): out, and the gradient of sum(out * w) in X."""
    def f(xv):
        out = _emit(jreg, JOpDesc, "roi_pool", {"X": [xv], "ROIs": [
            jnp.asarray(rois)]}, attrs, rng=jax.random.key(0))["Out"][0]
        return (out * w).sum(), out

    (_, out), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    return np.asarray(out), np.asarray(g)


def _roi_port(x, rois, attrs, w):
    xt = torch.tensor(x, requires_grad=True)
    out = run_op("port", "roi_pool", {"X": ("t", x), "ROIs": ("t", rois)},
                 attrs, {"X": [xt]})["Out"][0]
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy()


def _rois_on_edges(scale):
    """RoIs in input coordinates: inside the map, past its edges, one
    pixel, and extents whose bins split on boundaries (y2 - y1 + 1 a
    multiple of the pooled size, and the float32 products of rh and
    i / ph that land on integers)."""
    inv = 1.0 / scale
    return np.float32([
        [0, 0, 0, 15, 11],
        [1, 2, 3, 9, 9],
        [0, -4, -3, 30, 25],       # past the map: clipped bins, empty ones
        [1, 5, 5, 5, 5],           # one pixel
        [0, 0, 0, 6, 13],          # rh = 14 = 2 x 7
        [1, 1, 2, 21, 9],          # rw = 21 = 3 x 7
        [0, 3, 1, 10, 7],
        [1, 0, 0, 48, 34],
        [0, 2.5 * inv, 1.5 * inv, 9.5 * inv, 6.5 * inv],   # round half even
    ])


@pytest.mark.parametrize("case", ["ties", "random", "scaled"])
def test_roi_pool_matches_the_reference_executor(case):
    rng = np.random.RandomState(90)
    scale = 0.5 if case == "scaled" else 1.0
    x = rng.randn(2, 3, 12, 16).astype(np.float32)
    if case == "ties":
        x = np.maximum(np.round(x), 0.0)      # relu maps: many tied zeros
    rois = _rois_on_edges(scale)
    if case == "scaled":
        rois[:, 1:] *= 2.0
    attrs = {"pooled_height": 7, "pooled_width": 7, "spatial_scale": scale}
    w = rng.randn(rois.shape[0], 3, 7, 7).astype(np.float32)
    want, gwant = _roi_reference(x, rois, attrs, w)
    got, ggot = _roi_port(x, rois, attrs, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert rel_err(ggot, gwant) <= GRAD_RTOL



def test_roi_pool_splits_a_tied_bin_s_gradient_evenly():
    """One bin over a 3 x 4 block of zeros: each element gets 1/12 of
    the bin's gradient, as the reference's ``jnp.max`` gives it."""
    x = np.zeros((1, 1, 5, 6), np.float32)
    x[0, 0, 4, :] = -1.0
    rois = np.float32([[0, 1, 1, 4, 3]])
    attrs = {"pooled_height": 1, "pooled_width": 1}
    w = np.full((1, 1, 1, 1), 3.0, np.float32)
    want, gwant = _roi_reference(x, rois, attrs, w)
    got, ggot = _roi_port(x, rois, attrs, w)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ggot, gwant)
    assert np.isclose(ggot[0, 0, 1:4, 1:5], 0.25).all()
    assert (ggot.sum() == 3.0) and (np.count_nonzero(ggot) == 12)


def test_roi_pool_bin_edges_are_the_executor_s_not_the_eager_op_s():
    """The eager reference divides i * rh by ph; its Executor multiplies
    rh by the float32 constant i * (1 / ph).  At rh = 21, ph = 7 bin i
    ends at ceil(3 i) in the first and ceil(3 i + an ulp) = 3 i + 1 in
    the second: the port follows the Executor."""
    inv = np.float32(1) / np.float32(7)
    ends_div = [np.ceil(np.float32(i) * np.float32(21) / np.float32(7))
                for i in range(8)]
    ends_mul = [np.ceil(np.float32(21) * (np.float32(i) * inv))
                for i in range(8)]
    assert ends_div != ends_mul
    x = np.arange(2 * 1 * 24 * 4, dtype=np.float32).reshape(2, 1, 24, 4)
    rois = np.float32([[0, 0, 0, 3, 20]])
    attrs = {"pooled_height": 7, "pooled_width": 1}
    w = np.ones((1, 1, 7, 1), np.float32)
    want, _ = _roi_reference(x, rois, attrs, w)
    got, _ = _roi_port(x, rois, attrs, w)
    np.testing.assert_array_equal(got, want)
    # bin 0 takes rows 0-3 (not 0-2): its max is row 3's last column
    assert got[0, 0, 0, 0] == x[0, 0, 3, 3]


def test_roi_pool_gradient_is_deterministic_and_device_order_free():
    """Overlapping RoIs of one image: the backward's sums run in a fixed
    order, so two runs are the same bits."""
    rng = np.random.RandomState(91)
    x = np.maximum(np.round(rng.randn(2, 4, 9, 9)), 0).astype(np.float32)
    rois = np.float32([[0, 0, 0, 8, 8]] * 5 + [[1, 1, 1, 7, 6]] * 3)
    attrs = {"pooled_height": 3, "pooled_width": 3}
    w = rng.randn(8, 4, 3, 3).astype(np.float32)
    a, ga = _roi_port(x, rois, attrs, w)
    b, gb = _roi_port(x, rois, attrs, w)
    np.testing.assert_array_equal(ga, gb)
    want, gwant = _roi_reference(x, rois, attrs, w)
    np.testing.assert_array_equal(a, want)
    assert rel_err(ga, gwant) <= GRAD_RTOL


def test_hsigmoid_path_length_is_the_reference_s_at_every_label():
    """floor(log2(float32 c)) over every c of 100,000 classes
    (``hsigmoid_path_length`` divides log c by log 2 as jnp.log2 does),
    equal to the bit length there."""
    n = 100000
    c = np.arange(n, 2 * n, dtype=np.int32)
    want = np.asarray(jnp.floor(jnp.log2(jnp.asarray(c).astype(
        jnp.float32))).astype(jnp.int32))
    got = misc_ops.hsigmoid_path_length(torch.tensor(c)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.floor(np.log2(c.astype(
        np.float64))).astype(np.int32))


def test_sampling_id_draws_each_row_s_distribution():
    """20,000 draws from each of 3 rows (ids of the op's seed, one row
    repeated): the chi-square statistic of each row's counts below the
    1e-4 upper quantile of chi2(k - 1) (k = 6: 25.7); another seed
    draws other ids."""
    p = np.float32([[0.1, 0.2, 0.3, 0.05, 0.25, 0.1],
                    [0.5, 0.0, 0.0, 0.25, 0.25, 0.0],
                    [1, 1, 1, 1, 1, 1]])
    n = 20000
    x = np.repeat(p, n, axis=0)
    ids = run_op("port", "sampling_id", {"X": ("t", x)}, {},
                 seed=1234)["Out"][0].numpy()
    assert ids.shape == (3 * n, 1) and ids.dtype == np.int32
    for r in range(3):
        counts = np.bincount(ids[r * n:(r + 1) * n, 0], minlength=6)
        prob = p[r] / p[r].sum()
        assert (counts[prob == 0] == 0).all()
        live = prob > 0
        expect = n * prob[live]
        chi2 = float(((counts[live] - expect) ** 2 / expect).sum())
        quantile = {6: 25.74, 3: 18.42}[int(live.sum())]
        assert chi2 < quantile, (r, chi2)
    other = run_op("port", "sampling_id", {"X": ("t", x)}, {},
                   seed=1235)["Out"][0].numpy()
    assert not np.array_equal(ids, other)


def test_lambda_rank_cost_matches_reference_with_ties():
    """Graded labels 0-2 and scores quantized to quarters (many ties):
    the cost within OUT_RTOL and its gradient within GRAD_RTOL, where
    an unstable sort would rank tied documents otherwise and move the
    cost by whole pairs; a query of one document and one of equal labels
    cost 0."""
    rng = np.random.RandomState(95)
    b, t = 6, 12
    lengths = np.int32([12, 7, 1, 9, 12, 5])
    score = (np.round(rng.randn(b, t, 1) * 4) / 4).astype(np.float32)
    label = rng.randint(0, 3, (b, t, 1)).astype(np.float32)
    label[4] = 1.0
    specs = {"Score": ("seq", score, lengths),
             "Label": ("seq", label, lengths)}
    jo, to = compare_op("lambda_rank_cost", specs, {"ndcg_num": 5},
                        ("Score",))
    cost = as_np(to["Out"][0])
    assert cost[2, 0] == 0 and cost[4, 0] == 0 and (cost > 0).sum() >= 3


def test_lambda_rank_cost_ranks_ties_by_position():
    """Equal scores rank by position (a stable sort): the cost is the
    reference's formula over that ranking, and reversing the tied
    documents' labels changes it as the reference's does."""
    score = np.zeros((1, 4, 1), np.float32)
    for label in ([2, 0, 1, 0], [0, 1, 0, 2]):
        lab = np.float32(label).reshape(1, 4, 1)
        specs = {"Score": ("seq", score, np.int32([4])),
                 "Label": ("seq", lab, np.int32([4]))}
        jo, to = compare_op("lambda_rank_cost", specs, {"ndcg_num": 3})
        assert abs(float(as_np(to["Out"][0])[0, 0])
                   - float(np.asarray(jo["Out"][0])[0, 0])) <= 1e-6


def test_auc_ties_rank_by_position_as_the_reference():
    """ROADMAP C9: tied scores are ranked by sort order, not averaged;
    the AUC of all-tied scores depends on where the positives sit."""
    score = np.full((6, 2), 0.5, np.float32)
    for label in ([1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 1, 1]):
        specs = {"Out": ("t", score),
                 "Indices": ("t", np.zeros((6, 1), np.int32)),
                 "Label": ("t", np.int32(label).reshape(6, 1))}
        jo, to = compare_op("auc", specs, {}, exact=True)
        assert float(as_np(to["AUC"][0])) in (0.0, 1.0)


def test_precision_recall_reads_no_weights_or_states():
    """ROADMAP C9: three batch macro means, whatever Weights and
    StatesInfo hold; bit for bit."""
    specs = {"MaxProbs": ("t", _u(96, 40, 1)),
             "Indices": ("t", _ints(97, 7, 40, 1)),
             "Labels": ("t", _ints(98, 7, 40, 1))}
    jo, to = compare_op("precision_recall", specs, {"class_number": 7},
                        exact=True)
    assert as_np(to["BatchMetrics"][0]).shape == (3,)


def test_ranking_sums_are_order_free():
    """``tree_sum`` is the same bits in any memory layout, and
    ``softplus_exact`` is within a float32 rounding of log1p(e^x)."""
    x = torch.tensor(_r(99, 3, 37))
    a = loss_ops.tree_sum(x)
    b = loss_ops.tree_sum(x.t().contiguous().t())
    assert torch.equal(a, b)
    assert rel_err(a.numpy(), x.double().sum(-1).numpy()) < 1e-6
    v = torch.linspace(-80, 80, 4001)
    want = torch.nn.functional.softplus(v.double(), threshold=200)
    err = (loss_ops.softplus_exact(v).double() - want).abs() / want
    assert float(err.max()) <= 2 ** -24


# -- the 26 layers build the reference's program bytes

def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    L = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = L.data("img", [3, 8, 8], "float32")
        rois = L.data("rois", [5], "float32")
        x = L.data("x", [6], "float32")
        y = L.data("y", [6], "float32")
        lbl = L.data("lbl", [1], "int64")
        prob = L.data("prob", [1], "float32")
        seq = L.data("seq", [6], "float32", lod_level=1)
        seq_lbl = L.data("seq_lbl", [1], "float32", lod_level=1)
        sel = L.data("sel", [3], "int32")
        idx6 = L.data("idx6", [6], "int32")
        shift = L.data("shift", [3], "float32")
        conv = L.conv2d(img, 4, 3, padding=1, act="relu")
        pooled, mask = L.max_pool2d_with_index(conv, 2)
        up = L.unpool(pooled, mask, [8, 8])
        roi = L.roi_pool(conv, rois, 2, 2, 0.5)
        spp = L.spp(up, 2)
        rot = L.rotate(L.bilinear_interp(conv, 4, 6))
        sub = L.scale_sub_region(rot, idx6, 0.5)
        act = L.maxout(L.prelu(sub, "channel"), 2)
        feat = L.concat([L.reshape(roi, [-1, 16]), L.reshape(act, [-1, 48])],
                        axis=0)
        h = L.fc(x, 6)
        p = L.sigmoid(L.fc(h, 1))
        sm = L.label_smooth(L.one_hot(lbl, 6), epsilon=0.2)
        padded = L.crop(L.pad(sm, [0, 0, 1, 1], 0.5), shape=[-1, 6],
                        offsets=[0, 1])
        costs = [L.smooth_l1(h, y), L.hsigmoid(h, lbl, 10),
                 L.selective_fc(h, 12, select=sel),
                 L.cross_entropy_with_selfnorm(L.softmax(h), lbl),
                 L.log_loss(p, prob), L.rank_loss(prob, p, p),
                 L.margin_rank_loss(prob, p, p), L.conv_shift(h, shift),
                 L.reduce_sum(padded, dim=1, keep_dim=True)]
        rc = L.row_conv(seq, 2)
        rs = L.lod_reset(rc, y=seq_lbl)
        rank = L.lambda_rank_cost(L.fc(rs, 1), seq_lbl, ndcg_num=3)
        ids = L.sampling_id(L.softmax(h))
        auc = L.auc(L.concat([L.scale(p, -1.0, 1.0), p], axis=1), lbl)
        beam = L.cross_entropy_over_beam([(L.softmax(h), sel, lbl)])
        loss = L.sums([L.mean(c) for c in costs]
                      + [L.mean(v) for v in (rank, feat, spp, beam)])
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, (ids, auc, rs, spp, roi)


def test_layers_build_the_reference_program():
    j, t = _layers_program(jfluid), _layers_program(tfluid)
    for a, b in zip(j[:2], t[:2]):
        assert b.serialize_to_string() == a.serialize_to_string()
    for a, b in zip(j[2], t[2]):
        assert (b.shape is None) == (a.shape is None)
        assert b.shape is None or tuple(b.shape) == tuple(a.shape)
    ops = [op.type for op in t[0].global_block().ops]
    for op in ("roi_pool", "roi_pool_grad", "spp", "unpool",
               "max_pool2d_with_index", "bilinear_interp", "rotate",
               "scale_sub_region", "prelu", "maxout", "smooth_l1_loss",
               "hsigmoid", "selective_fc", "cross_entropy_with_selfnorm",
               "log_loss", "rank_loss", "margin_rank_loss", "conv_shift",
               "label_smooth", "pad", "crop", "row_conv", "lod_reset",
               "lambda_rank_cost", "sampling_id", "auc",
               "cross_entropy_over_beam", "lambda_rank_cost_grad"):
        assert op in ops, op


def test_layers_are_exported_as_the_reference_s():
    names = ("smooth_l1", "auc", "hsigmoid", "sampling_id",
             "bilinear_interp", "prelu", "maxout", "selective_fc",
             "scale_sub_region", "rotate", "cross_entropy_over_beam",
             "cross_entropy_with_selfnorm", "pad", "crop", "lod_reset",
             "label_smooth", "rank_loss", "margin_rank_loss", "log_loss",
             "conv_shift", "row_conv", "roi_pool", "spp", "unpool",
             "max_pool2d_with_index", "lambda_rank_cost")
    assert len(names) == 26
    for n in names:
        assert hasattr(jfluid.layers, n) and hasattr(tfluid.layers, n), n
    assert set(names) - {"lambda_rank_cost"} <= set(
        tfluid.layers.nn.__all__)
    assert "lambda_rank_cost" in tfluid.layers.sequence.__all__
