"""Normalization, dropout and fused attention ops — the port of
``paddle_tpu/fluid/ops/nn_ops.py``, cut to what the Transformer emits."""

from __future__ import annotations

import torch

from ...kernels.flash_attention import flash_attention, keep_scale
from ..core.registry import primitive


@primitive("layer_norm", inputs=["X", "Scale?", "Bias?"],
           outputs=["Y", "Mean", "Variance"])
def layer_norm(ctx, x, scale, bias):
    """reference layer_norm_op.cc: normalize over dims [begin_norm_axis:)
    in fp32; Mean and Variance carry no gradient."""
    eps = ctx.attr("epsilon", 1e-5)
    axis = ctx.attr("begin_norm_axis", 1)
    lead = x.shape[:axis]
    x2 = x.reshape(*lead, -1).float()
    mu = x2.mean(dim=-1, keepdim=True)
    var = x2.var(dim=-1, keepdim=True, correction=0)
    y = (x2 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.reshape(-1)
    if bias is not None:
        y = y + bias.reshape(-1)
    return (y.reshape(x.shape).to(x.dtype), mu.reshape(lead).detach(),
            var.reshape(lead).detach())


@primitive("dropout", outputs=["Out", "Mask"])
def dropout(ctx, x):
    """reference dropout_op.cc, with the reference's mask: the attention
    kernels' counter hash (``keep_scale``) over the flat element index,
    seeded by the op's seed.  Out = x * {0, 1/(1-p)}; Mask is the 0/1
    view."""
    p = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False) or ctx.mode == "infer" or p == 0.0:
        return x, torch.ones_like(x)
    if x.device.type == "meta":
        return torch.empty_like(x), torch.empty_like(x)
    idx = torch.arange(x.numel(), device=x.device)
    scale = keep_scale(ctx.seed, 0, idx, 0, float(p))
    scale = scale.reshape(x.shape).to(x.dtype)
    return x * scale, (scale > 0).to(x.dtype)


@primitive("fused_attention", inputs=["Q", "K", "V", "Bias?"],
           outputs=["Out"])
def fused_attention(ctx, q, k, v, bias):
    """Fused scaled-dot-product attention: ``kernels.flash_attention``
    (the flash kernels on the card), with attention-probability dropout
    keyed on the op's seed.  One card: the reference's sequence-parallel
    routes need a mesh, which the port does not have."""
    if ctx.attr("impl") is not None:
        raise NotImplementedError("fused_attention: the impl attr (the "
                                  "reference's pallas/xla switch) is not "
                                  "ported")
    rate = ctx.attr("dropout_rate", 0.0)
    if ctx.attr("is_test", False) or ctx.mode == "infer":
        rate = 0.0
    return flash_attention(q, k, v, bias=bias,
                           causal=ctx.attr("causal", False),
                           sm_scale=ctx.attr("sm_scale", None),
                           dropout_rate=rate,
                           dropout_seed=ctx.seed or 0,
                           layout=ctx.attr("layout", "bhld"))
