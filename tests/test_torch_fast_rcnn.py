"""Fast R-CNN (VGG-16) in the port: ``chip_smoke.build_fast_rcnn``'s
program through both packages on the CPU.

* The program (VGG-16's 13 conv + relu layers and four max pools,
  ``roi_pool`` 7 x 7 at 1/16, fc6 / fc7 with dropout 0.5, softmax
  cross-entropy over the classes and ``smooth_l1`` on the RoI's class's
  box columns, Momentum with L2 decay) serializes to the reference's
  bytes at 600 x 800 and full width, and at the small size below.
* Three Momentum steps from the reference's initial scope, the port's
  dropout drawing the reference's masks (``reference_seeds``): each
  step's loss within LOSS_RTOL of the reference's, and every parameter
  after them within PARAM_ATOL.  Among the RoIs is one 7 feature cells
  a side (corners at 0 and 96 pixels): there the reference's Executor
  puts bin edges an ulp past an integer (rh * fl(i / 7)), and the port's
  ``roi_pool`` follows it.
"""

import numpy as np
import pytest

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from tests.test_torch_conv_ops import run_op
from tests.test_torch_image import reference_seeds

# 128 x 160 images (an 8 x 10 conv5_3 map), channels / 8, fc 64, 5
# classes
SMALL = dict(height=128, width=160, classes=5, fc=64, scale=0.125,
             lr=1e-3)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
PACKAGES = {"jax": jfluid, "port": tfluid}


def _build(pkg, dims=SMALL):
    return chip_smoke.build_fast_rcnn(PACKAGES[pkg], **dims)


def _same_bytes(j, t):
    for a, b in zip(j[:3], t[:3]):
        assert b.serialize_to_string() == a.serialize_to_string()
    ops = [op.type for op in t[0].global_block().ops]
    assert ops.count("conv2d") == 13 and ops.count("pool2d") == 4
    for op in ("roi_pool", "roi_pool_grad", "smooth_l1_loss",
               "smooth_l1_loss_grad", "softmax_with_cross_entropy",
               "dropout", "momentum"):
        assert op in ops, op


def test_fast_rcnn_program_matches_reference_bytes():
    j, t = _build("jax", chip_smoke.FRCNN), _build("port", chip_smoke.FRCNN)
    _same_bytes(j, t)
    pool5 = t[6]
    assert tuple(pool5.shape) == (-1, 512, 7, 7)
    params = {p.name: tuple(p.shape)
              for p in t[0].global_block().all_parameters()}
    assert (25088, 4096) in params.values()
    assert (4096, 84) in params.values()


def _feeds(steps=3):
    rng = np.random.RandomState(7)
    feeds = [chip_smoke.frcnn_batch(np, rng, 2, 8, SMALL["height"],
                                    SMALL["width"], SMALL["classes"])
             for _ in range(steps)]
    for f in feeds:
        f["rois"][3] = [0, 0, 0, 96, 96]        # 7 x 7 cells: bins on edges
    return feeds


def test_fast_rcnn_trains_as_the_reference(monkeypatch):
    j, t = _build("jax"), _build("port")
    _same_bytes(j, t)
    feeds = _feeds()
    params = [p.name for p in t[0].global_block().all_parameters()]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(j[1])
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        rng_at = (scope._rng_seed, scope._rng_step)
        want = [float(np.asarray(exe.run(j[0], feed=f,
                                         fetch_list=[j[3]])[0]))
                for f in feeds]
        want_params = {n: np.asarray(scope.find_var(n)) for n in params}
    monkeypatch.setattr(texecutor, "step_seeds", reference_seeds)
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    tscope._rng_seed, tscope._rng_step = rng_at
    texe = tfluid.Executor(cpu)
    got = [float(texe.run(t[0], feed=f, fetch_list=[t[3]],
                          scope=tscope)[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n in params:
        np.testing.assert_allclose(np.asarray(tscope.find_var(n)),
                                   want_params[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("rois", [[0, 0, 0, 159, 127], [1, 0, 0, 96, 96],
                                  [1, 16, 16, 47, 63], [0, 40, 8, 40, 8]])
def test_roi_pool_matches_the_reference_executor_on_its_features(rois):
    """The reference Executor's pool5 on one RoI (the whole image, 7 x 7
    cells, one on cell boundaries, one pixel) and the port's
    ``roi_pool`` on the conv5_3 map that Executor computed: bit for
    bit."""
    j = _build("jax")
    feed = dict(_feeds(1)[0])
    feed["rois"] = np.float32([rois])
    for k in ("label", "bbox_target", "inside_w"):
        feed[k] = feed[k][:1]
    op = next(o for o in j[2].global_block().ops if o.type == "roi_pool")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(j[1])
        conv5, want = (np.asarray(v) for v in exe.run(
            j[2], feed=feed, fetch_list=[op.input("X")[0], j[6]]))
    got = run_op("port", "roi_pool", {"X": ("t", conv5),
                                      "ROIs": ("t", feed["rois"])},
                 dict(op.attrs))["Out"][0].numpy()
    assert got.shape == want.shape == (1, 64, 7, 7)
    np.testing.assert_array_equal(got, want)
