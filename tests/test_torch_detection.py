"""SSD detection in the port (``fluid/ops/detection_ops.py``, its layers
and ``chip_smoke``'s MobileNet-SSD program) against the JAX package on
the CPU.

* Bit for bit (``compare_op(exact=True)``): ``prior_box`` with flip,
  clip and max sizes, ``iou_similarity``, ``bipartite_match`` (both
  match types, over tied distances), ``positive_negative_pair`` (unit
  weights: integer sums), ``multiclass_nms``'s rows over tied scores
  and overlapping boxes, and ``ssd_loss``'s matching: the port's
  ``ssd_match`` against the reference's claim loop (``_pairwise_iou``
  and the scan of ``detection_ops.py:ssd_loss``, run here in JAX) and
  its positives against the priors the reference's location gradient
  reaches.
* ``detection_output``'s rows (``rows_match``): the same classes in the
  same order, scores and corners within ROW_RTOL (its ``exp`` and
  softmax round differently in the two packages, by an ulp).
* ``ssd_loss`` and weighted ``positive_negative_pair``: outputs within
  OUT_RTOL of their largest, gradients within GRAD_RTOL of theirs.
* The SSD program (MobileNet backbone, heads, ``prior_box`` on six maps,
  ``ssd_loss``, Momentum; the test program's ``detection_output``)
  serializes to the reference's bytes at 300 px and full width and at
  the small width (64 px: see SMALL).  Three Momentum steps, each from the reference's
  scope before it, give its losses within LOSS_RTOL, and the inference
  program's rows from the initial scope match (``rows_match``).  Each
  step starts from the reference's state because the network at its
  initialization amplifies float32 rounding: chained, the two packages'
  third losses drift 2e-5 apart at lr 1e-4, though each step agrees
  within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.lod import SeqArray as JSeqArray
from paddle_tpu.fluid.ops import detection_ops as jdet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.ops import detection_ops as tdet
from tests.test_torch_amp import _emit
from tests.test_torch_conv_ops import as_np, compare_op, run_op

LOSS_RTOL = 1e-5
ROW_RTOL = 1e-6
# a power-of-two image: the reference's compiled program divides by the
# image size as a multiply by its reciprocal (XLA's rewrite), exact only
# for a power of two, so its priors are its op's (and the port's) to the
# bit only there; at 48 px they differ by an ulp, which flips IoU ties
# between a prior and its flipped twin
SMALL = dict(px=64, scale=0.125, repeats=0, classes=5, lr=1e-3)
PACKAGES = {"jax": jfluid, "port": tfluid}


def rows_match(got, want):
    """Detection rows [..., 6] alike: classes equal in the same order,
    scores and corners within ROW_RTOL (relative, or absolute near 0)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=ROW_RTOL,
                               atol=ROW_RTOL)


def _boxes(rng, *lead, lo=0.0, span=(0.05, 0.5)):
    xy = rng.uniform(lo, 0.7, lead + (2,))
    return np.concatenate([xy, xy + rng.uniform(*span, lead + (2,))],
                          axis=-1).astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(min_sizes=[30.0], aspect_ratios=[2.0], flip=True),
    dict(min_sizes=[40.0, 80.0], max_sizes=[80.0, 120.0],
         aspect_ratios=[2.0, 3.0, 2.0000001], flip=True, clip=True),
    dict(min_sizes=[20.0], max_sizes=[60.0], aspect_ratios=[1.0, 0.5],
         clip=True, offset=0.25, step_h=8.0, step_w=6.0,
         variances=[0.1, 0.2, 0.3, 0.4]),
])
def test_prior_box_matches_reference_bitwise(case):
    specs = {"Input": ("t", np.zeros((1, 2, 5, 7), np.float32)),
             "Image": ("t", np.zeros((1, 3, 60, 90), np.float32))}
    attrs = dict(case, max_sizes=case.get("max_sizes", []))
    compare_op("prior_box", specs, attrs, exact=True)


def test_iou_similarity_matches_reference_bitwise():
    rng = np.random.RandomState(1)
    x, y = _boxes(rng, 13), _boxes(rng, 17)
    y[3] = x[2]                           # identical boxes: IoU exactly 1
    y[4, 2:] = y[4, :2]                   # an empty box
    compare_op("iou_similarity", {"X": ("t", x), "Y": ("t", y)}, {},
               exact=True)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
@pytest.mark.parametrize("shape", [(5, 12), (9, 4)])
def test_bipartite_match_matches_reference_bitwise(match_type, shape):
    rng = np.random.RandomState(2)
    dist = np.round(rng.rand(*shape) * 8) / 8      # many ties
    compare_op("bipartite_match", {"DistMat": ("t", dist.astype(
        np.float32))}, {"match_type": match_type, "dist_threshold": 0.4},
        exact=True)


def _pair_specs(seed, n=24, weight=False, acc=False):
    rng = np.random.RandomState(seed)
    specs = {"Score": ("t", np.round(rng.rand(n, 2) * 6).astype(
                 np.float32)),
             "Label": ("t", rng.randint(0, 3, (n, 1)).astype(np.float32)),
             "QueryID": ("t", rng.randint(0, 4, (n, 1)).astype(np.int32))}
    if weight:
        specs["Weight"] = ("t", rng.rand(n, 1).astype(np.float32))
    if acc:
        for s in ("AccumulatePositivePair", "AccumulateNegativePair",
                  "AccumulateNeutralPair"):
            specs[s] = ("t", rng.rand(1).astype(np.float32) * 10)
    return specs


@pytest.mark.parametrize("column", [0, -1])
def test_positive_negative_pair_matches_reference_bitwise(column):
    compare_op("positive_negative_pair", _pair_specs(3), {"column": column},
               exact=True)


def test_positive_negative_pair_weighted_matches_reference():
    compare_op("positive_negative_pair", _pair_specs(4, weight=True,
                                                     acc=True), {})


@pytest.mark.parametrize("k", [(6, 6), (20, 9), (3, 30)])
def test_multiclass_nms_rows_match_reference_bitwise(k):
    rng = np.random.RandomState(5)
    boxes = _boxes(rng, 24, span=(0.2, 0.4))
    boxes[5] = boxes[4]                     # duplicates: IoU 1
    scores = np.round(rng.rand(4, 24) * 10) / 10   # ties
    scores[:, :3] = 0.005                           # below the threshold
    compare_op("multiclass_nms", {"BBoxes": ("t", boxes),
                                  "Scores": ("t", scores.astype(
                                      np.float32))},
               {"nms_top_k": k[0], "keep_top_k": k[1],
                "nms_threshold": 0.3}, exact=True)


def _ssd_inputs(seed, b=3, p=60, c=5, g=4):
    rng = np.random.RandomState(seed)
    prior = _boxes(rng, p, span=(0.1, 0.3))
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (p, 1))
    gb = _boxes(rng, b, g, span=(0.1, 0.4))
    gb[0, 1] = prior[7]                  # a gt exactly on a prior
    gl = rng.randint(1, c, (b, g, 1)).astype(np.int32)
    glen = np.array([g, 1, 2][:b], np.int32)
    return {"Location": ("t", rng.randn(b, p, 4).astype(np.float32) * 0.5),
            "Confidence": ("t", rng.randn(b, p, c).astype(np.float32)),
            "GTBox": ("seq", gb, glen), "GTLabel": ("seq", gl, glen),
            "PriorBox": ("t", prior), "PriorVar": ("t", var)}


@pytest.mark.parametrize("defaults", [True, False])
def test_detection_output_rows_match_reference(defaults):
    s = _ssd_inputs(6, p=80)
    specs = {k: s[k] for k in ("Location", "Confidence", "PriorBox",
                               "PriorVar")}
    attrs = {} if defaults else {"nms_top_k": 10, "keep_top_k": 7,
                                 "background_id": 2,
                                 "confidence_threshold": 0.15}
    rows = [as_np(run_op(pkg, "detection_output", specs, attrs)["Out"][0])
            for pkg in ("jax", "port")]
    rows_match(rows[1], rows[0])
    assert (rows[1][..., 0] >= 0).any()


@pytest.mark.parametrize("attrs", [{}, {"overlap_threshold": 0.3,
                                        "neg_pos_ratio": 2.0,
                                        "background_label": 1}])
def test_ssd_loss_matches_reference(attrs):
    compare_op("ssd_loss", _ssd_inputs(7), attrs,
               ("Location", "Confidence"))


def _reference_claims(gb, glen, prior, thresh):
    """The matching inside the reference's ssd_loss
    (detection_ops.py:ssd_loss's ``claim`` scan and top-up), in JAX."""
    p, g = prior.shape[0], gb.shape[1]

    def one(gb_i, glen_i):
        iou = jdet._pairwise_iou(gb_i, prior)
        iou = jnp.where((jnp.arange(g) < glen_i)[:, None], iou, -1.0)
        neg = jnp.float32(-1e30)

        def claim(state, _):
            d, match = state
            flat = jnp.argmax(d)
            r, c = flat // p, flat % p
            live = d[r, c] > 0
            match = jnp.where(live, match.at[c].set(r), match)
            d = jnp.where(live, d.at[r, :].set(neg).at[:, c].set(neg), d)
            return (d, match), None

        (_, match), _ = jax.lax.scan(
            claim, (iou, jnp.full((p,), -1, jnp.int32)), None,
            length=min(g, p))
        best_gt = jnp.argmax(iou, axis=0).astype(jnp.int32)
        return jnp.where((match < 0) & (jnp.max(iou, axis=0) >= thresh),
                         best_gt, match)

    return np.asarray(jax.vmap(one)(jnp.asarray(gb), jnp.asarray(glen)))


@pytest.mark.parametrize("thresh", [0.5, 0.2])
def test_ssd_matching_is_the_reference_bitwise(thresh):
    s = _ssd_inputs(8, b=3, p=120, g=6)
    gb, glen = s["GTBox"][1], s["GTBox"][2]
    prior = s["PriorBox"][1]
    want = _reference_claims(gb, glen, prior, thresh)
    got = tdet.ssd_match(torch.tensor(gb), torch.tensor(glen),
                         torch.tensor(prior), thresh).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 0
    # the positives are the priors the reference's location gradient
    # reaches
    ins = {k: [JSeqArray(jnp.asarray(v[1]), jnp.asarray(v[2]))]
           if v[0] == "seq" else [jnp.asarray(v[1])] for k, v in s.items()}

    def loss(loc):
        return _emit(jreg, JOpDesc, "ssd_loss", dict(ins, Location=[loc]),
                     {"overlap_threshold": thresh})["Out"][0].sum()

    reached = np.abs(np.asarray(jax.grad(loss)(ins["Location"][0]))
                     ).sum(-1) > 0
    np.testing.assert_array_equal(got >= 0, reached)


def _ssd(pkg, dims=SMALL):
    return chip_smoke.build_ssd(PACKAGES[pkg], **dims)


def _same_bytes(j, t):
    for a, b in zip(j[:3], t[:3]):
        assert b.serialize_to_string() == a.serialize_to_string()
    ops = [op.type for op in t[0].global_block().ops]
    assert ops.count("prior_box") == 6
    for op in ("ssd_loss", "ssd_loss_grad", "momentum",
               "detection_output", "batch_norm_grad"):
        assert op in ops, op


def test_mobilenet_ssd_programs_match_reference_bytes():
    j, t = _ssd("jax", chip_smoke.SSD), _ssd("port", chip_smoke.SSD)
    _same_bytes(j, t)
    assert tuple(t[4].shape) == (-1, 1917, 4)
    assert tuple(t[5].shape) == (-1, 1917, 21)


def _feed(fluid):
    return chip_smoke.ssd_batch(np, fluid, np.random.RandomState(9), 4,
                                SMALL["px"], SMALL["classes"], (1, 4))


def test_ssd_trains_and_detects_as_the_reference():
    j, t = _ssd("jax"), _ssd("port")
    _same_bytes(j, t)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    cpu = tfluid.CPUPlace()
    texe = tfluid.Executor(cpu)
    with jfluid.scope_guard(scope):
        exe.run(j[1])
        states, want = [], []
        for _ in range(3):
            states.append({n: np.asarray(scope.find_var(n))
                           for n in scope.vars
                           if scope.find_var(n) is not None})
            want.append(float(np.asarray(exe.run(
                j[0], feed=_feed(jfluid), fetch_list=[j[3]])[0])))
        jrows = np.asarray(exe.run(j[2], feed=_feed(jfluid),
                                   fetch_list=[j[6]], mode="infer")[0])
    got = []
    for st in states:
        tscope = tfluid.scope_from_numpy(st, cpu)
        got.append(float(texe.run(t[0], feed=_feed(tfluid),
                                  fetch_list=[t[3]], scope=tscope)[0]))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    rows = texe.run(t[2], feed=_feed(tfluid), fetch_list=[t[6]],
                    scope=tscope, mode="infer")[0]
    assert rows.shape == (4, 200, 6)
    assert (rows[..., 0] >= 1).any()
    rows_match(rows, jrows)


def test_nms_walk_is_the_reference_order_on_ties():
    """Equal scores rank lower box index first (``jax.lax.top_k``):
    of two identical boxes with one score, the lower index is kept."""
    boxes = np.float32([[0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.5],
                        [0.6, 0.6, 0.9, 0.9]])
    scores = np.float32([[0.0, 0.0, 0.0], [0.7, 0.7, 0.2]])
    out = run_op("port", "multiclass_nms", {"BBoxes": ("t", boxes),
                                            "Scores": ("t", scores)},
                 {"keep_top_k": 4, "nms_top_k": 3})["Out"][0].numpy()
    np.testing.assert_array_equal(out[:2, :2],
                                  np.float32([[1, 0.7], [1, 0.2]]))
    np.testing.assert_array_equal(out[0, 2:], boxes[0])
    assert (out[2:] == -1).all()
