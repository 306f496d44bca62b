"""Miscellaneous ops — the port of ``paddle_tpu/fluid/ops/misc_ops.py``,
cut to ``lrn``, the local response normalization of AlexNet."""

from __future__ import annotations

import torch.nn.functional as F

from ..core.registry import primitive
from .math_ops import weak_scalar


@primitive("lrn", outputs=["Out", "MidOut"])
def lrn(ctx, x):
    """reference lrn_op.cc: across-channel local response normalization
    of NCHW X, Out = X / MidOut ** beta with MidOut = k + alpha * (the
    sum of X^2 over a window of n channels centred on each channel, zero
    past the edges).  Computed in X's dtype, the window summed in the
    reference's order (from its first channel up) and alpha rounded to
    X's dtype as the reference's weak typing rounds it; the gradient is
    autograd's through these ops."""
    n = ctx.attr("n", 5)
    k = ctx.attr("k", 2.0)
    alpha = ctx.attr("alpha", 1e-4)
    beta = ctx.attr("beta", 0.75)
    half = n // 2
    channels = x.shape[1]
    padded = F.pad(x * x, (0, 0, 0, 0, half, half))
    acc = 0
    for i in range(n):
        acc = acc + padded[:, i: i + channels]
    mid = k + weak_scalar(alpha, acc) * acc
    return x / (mid ** beta), mid
