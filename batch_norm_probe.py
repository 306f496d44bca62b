"""Two probes of the image path's ``batch_norm`` on the card.

1. Faults planted in ``fluid/ops/nn_ops.py:_BatchNormTrain`` on CUDA
   tensors only (the CPU port, which the card is held to, stays right):
   X's gradient halved in every norm, the terms through the statistics
   dropped, the offset gradients halved, the unbiased variance.  Each
   runs ``chip_smoke.resnet_compare`` in bf16 and float32, and each must
   fail it; the unchanged op last, which must pass.
2. Autograd through the reference's formula written out op by op against
   the Function, ResNet-50 in bench.py's recipe at batch 128, bf16 and
   float32, in turns (Function, plain, plain, Function): step ms, peak
   memory, the losses.

Run on the card: ``python3 batch_norm_probe.py``; one JSON line a case on
standard output, then the summary line.  Exits 1 if a fault passes the
compare or the unchanged op fails it.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def planted(Orig, torch, dx_scale=1.0, stats=True, db_scale=1.0,
            correction=0):
    """A subclass of the Function whose forward (``correction``) or
    backward (the other knobs) is wrong on CUDA tensors only."""

    class Planted(Orig):
        @staticmethod
        def forward(ctx, x, scale, bias, eps, axes, shape):
            if not x.is_cuda or correction == 0:
                return Orig.forward(ctx, x, scale, bias, eps, axes, shape)
            var, mean = torch.var_mean(x.float(), dim=axes,
                                       correction=correction)
            inv = torch.rsqrt(var + eps)
            mean_b = mean.reshape(shape)
            y = (x - mean_b) * (inv * scale).reshape(shape) \
                + bias.reshape(shape)
            ctx.save_for_backward(x, scale, mean_b, inv.reshape(shape))
            ctx.axes = axes
            ctx.mark_non_differentiable(mean, var, inv)
            return y.to(x.dtype), mean, var, inv

        @staticmethod
        def backward(ctx, dy, *rest):
            x, scale, mean_b, inv_b = ctx.saved_tensors
            if not x.is_cuda:
                return Orig.backward(ctx, dy, *rest)
            n = x.numel() // mean_b.numel()
            dyf = dy.float()
            xhat = (x - mean_b) * inv_b
            dbias = dyf.sum(dim=ctx.axes)
            dscale = (dyf * xhat).sum(dim=ctx.axes)
            shape = mean_b.shape
            g = dyf
            if stats:
                g = g - (dbias / n).reshape(shape) \
                    - xhat * (dscale / n).reshape(shape)
            dx = (dx_scale * g * (scale.reshape(shape) * inv_b)).to(x.dtype)
            return (dx, dscale.to(scale.dtype),
                    (db_scale * dbias).to(scale.dtype), None, None, None)

    return Planted


class Plain:
    """The reference's formula op by op, its gradient autograd's."""

    @staticmethod
    def apply(x, scale, bias, eps, axes, shape):
        import torch

        xf = x.float()
        var, mean = torch.var_mean(xf, dim=axes, correction=0)
        inv = torch.rsqrt(var + eps)
        y = (xf - mean.reshape(shape)) * inv.reshape(shape)
        y = y * scale.reshape(shape) + bias.reshape(shape)
        return y.to(x.dtype), mean.detach(), var.detach(), inv.detach()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("batch_norm_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke as cs
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.ops import nn_ops

    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    Orig = nn_ops._BatchNormTrain
    faults = {"halved_dx": dict(dx_scale=0.5),
              "no_stat_terms": dict(stats=False),
              "half_offset_grad": dict(db_scale=0.5),
              "unbiased_var": dict(correction=1), "none": {}}
    fault_rec, bad = {}, []
    try:
        for name, knobs in faults.items():
            nn_ops._BatchNormTrain = planted(Orig, torch, **knobs)
            for dtype in ("bfloat16", "float32"):
                r, ok = cs.resnet_compare(torch, np, fluid, dtype)
                rec = {"fault": name, "dtype": dtype, "ok": ok,
                       **{k: v for k, v in r.items()
                          if k not in ("replay", "warm_losses")}}
                fault_rec[f"{name}/{dtype}"] = rec
                print(json.dumps(rec), flush=True)
                if ok != (name == "none"):
                    bad.append(f"{name}/{dtype}")
        plain = []
        for dtype in ("bfloat16", "float32"):
            for variant, cls in (("function", Orig), ("plain", Plain),
                                 ("plain", Plain), ("function", Orig)):
                nn_ops._BatchNormTrain = cls
                main_p, startup, loss = cs.build_image(fluid, "resnet50",
                                                       dtype)
                feed = cs.image_feed(torch, np, "resnet50", cs.IMAGE_BATCH,
                                     dtype)
                run = cs.train_images(torch, np, fluid, main_p, startup,
                                      loss, [feed], cs.RESNET_STEPS)
                row = {"dtype": dtype, "variant": variant,
                       **{k: run[k] for k in (
                           "step_ms_median", "images_per_s", "peak_mem_gib",
                           "peak_reserved_gib", "first_step_ms")},
                       "loss_first_last": [run["losses"][0],
                                           run["losses"][-1]]}
                plain.append(row)
                print(json.dumps(row), flush=True)
    finally:
        nn_ops._BatchNormTrain = Orig
    print(json.dumps({"batch_norm_probe": {
        "card": card, "faults_passed_or_control_failed": bad,
        "plain_vs_function": plain,
        "seconds": time.perf_counter() - t0}}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
