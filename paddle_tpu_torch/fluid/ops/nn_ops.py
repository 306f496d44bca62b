"""Convolution, pooling, normalization, dropout and fused attention ops —
the port of ``paddle_tpu/fluid/ops/nn_ops.py``.  The convolutions are
``torch.nn.functional``'s (cuDNN on the card, TF32 off), as the
reference leaves its convolutions to XLA: ``conv2d``,
``depthwise_conv2d`` (groups = channels), ``conv2d_transpose`` (an IOHW
filter, output (in - 1) * stride + filter - 2 * pad) and ``conv3d``;
``pool2d`` / ``pool3d`` pad by hand so their windows, output shape and
average counts are the reference's; ``batch_norm`` writes out the
reference's formula (biased batch variance in float32) with a
closed-form backward; ``nce`` draws its negatives on the device from
the op's seed; ``im2sequence`` is ``F.unfold``, whose patch features
are channel-major as ``conv_general_dilated_patches``' are."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...kernels.flash_attention import (counter_hash, flash_attention,
                                         keep_scale)
from ..core.registry import primitive
from .math_ops import match_master_dtype, weak_scalar


@primitive("conv2d", inputs=["Input", "Filter"], outputs=["Output"])
def conv2d(ctx, x, w):
    """NCHW convolution with an OIHW filter (reference conv_op.cc), in
    X's dtype: a bf16 input casts its f32 master filter down."""
    p = ctx.attr("paddings", [0, 0])
    return F.conv2d(x, match_master_dtype(x, w),
                    stride=tuple(ctx.attr("strides", [1, 1])),
                    padding=(p[0], p[1]),
                    dilation=tuple(ctx.attr("dilations", [1, 1])),
                    groups=ctx.attr("groups", 1))


def _ceil_extra_pad(in_size, k, s, p, ceil_mode):
    """Padding past ``p`` on the high side that keeps the last, partial
    window under ceil_mode (reference nn_ops.py ``_ceil_extra_pad``)."""
    if not ceil_mode:
        return 0
    out = -((in_size + 2 * p - k) // -s) + 1
    return max((out - 1) * s + k - (in_size + 2 * p), 0)


def _window_sum(x, pad, ksize, strides):
    """Sum over each window of ``x`` zero-padded by ``pad`` (F.pad's
    order: the last dim's low and high pads first), 2-D or 3-D by the
    window's rank."""
    pool = F.avg_pool2d if len(ksize) == 2 else F.avg_pool3d
    return pool(F.pad(x, pad) if any(pad) else x, ksize, strides,
                divisor_override=1)


def _pool(ctx, x, nd):
    """The reference's pooling over the last ``nd`` dims, as it computes
    it: windows over X padded by ``paddings`` on both sides, plus under
    ``ceil_mode`` the extra high-side pad that keeps a last partial
    window (PyTorch's own ceil_mode drops a window that starts in the
    padding, the reference keeps it); ``global_pooling`` pools the
    whole of those dims.  Max pads with -inf; average divides by the
    count of unpadded elements in the window (exclusive)."""
    ptype = ctx.attr("pooling_type", "max")
    ceil_mode = ctx.attr("ceil_mode", False)
    if ctx.attr("global_pooling", False):
        ksize = list(x.shape[2:])
        strides, pads, ceil_mode = ksize, [0] * nd, False
    else:
        ksize = ctx.attr("ksize", [2] * nd)
        strides = ctx.attr("strides", [2] * nd)
        pads = ctx.attr("paddings", [0] * nd)
    hi = [p + _ceil_extra_pad(x.shape[i + 2], ksize[i], strides[i], p,
                              ceil_mode) for i, p in enumerate(pads)]
    pad = tuple(v for i in reversed(range(nd)) for v in (pads[i], hi[i]))
    if ptype == "max":
        xp = F.pad(x, pad, value=-torch.inf) if any(pad) else x
        return (F.max_pool2d if nd == 2 else F.max_pool3d)(xp, ksize,
                                                            strides)
    total = _window_sum(x, pad, ksize, strides)
    if not any(pads) and not ceil_mode:
        return total / math.prod(ksize)
    return total / _window_sum(torch.ones_like(x), pad, ksize, strides)


@primitive("pool2d")
def pool2d(ctx, x):
    """reference pool_op.cc (``_pool`` over H and W)."""
    return _pool(ctx, x, 2)


@primitive("pool3d")
def pool3d(ctx, x):
    """NCDHW pooling, the reference's Pool3DLayer capability (``_pool``
    over D, H and W)."""
    return _pool(ctx, x, 3)


@primitive("depthwise_conv2d", inputs=["Input", "Filter"], outputs=["Output"])
def depthwise_conv2d(ctx, x, w):
    """reference conv_op.cc's depthwise variant: one group per input
    channel (the reference reads no dilations here)."""
    p = ctx.attr("paddings", [0, 0])
    return F.conv2d(x, match_master_dtype(x, w),
                    stride=tuple(ctx.attr("strides", [1, 1])),
                    padding=(p[0], p[1]), groups=x.shape[1])


@primitive("conv2d_transpose", inputs=["Input", "Filter"], outputs=["Output"])
def conv2d_transpose(ctx, x, w):
    """reference conv_transpose_op.cc: the IOHW filter over X with
    ``strides`` and ``paddings``, output (in - 1) * stride + filter -
    2 * pad (the reference's lhs-dilated convolution with the flipped
    filter; it reads no dilations)."""
    p = ctx.attr("paddings", [0, 0])
    return F.conv_transpose2d(x, match_master_dtype(x, w),
                              stride=tuple(ctx.attr("strides", [1, 1])),
                              padding=(p[0], p[1]))


@primitive("conv3d", inputs=["Input", "Filter"], outputs=["Output"])
def conv3d(ctx, x, w):
    """NCDHW convolution with an OIDHW filter (the reference's
    Conv3DLayer capability)."""
    return F.conv3d(x, match_master_dtype(x, w),
                    stride=tuple(ctx.attr("strides", [1, 1, 1])),
                    padding=tuple(ctx.attr("paddings", [0, 0, 0])),
                    dilation=tuple(ctx.attr("dilations", [1, 1, 1])),
                    groups=ctx.attr("groups", 1))


def _bn_axes(x, layout):
    """(reduced axes, the [1, C, 1, 1]-style shape of a per-channel
    vector) of a batch_norm input: NCHW reduces over (0, 2, 3), anything
    else over every axis but the last (the 2-D [N, C] of an fc)."""
    nchw = x.dim() == 4 and layout == "NCHW"
    axes = (0, 2, 3) if nchw else tuple(range(max(x.dim() - 1, 1)))
    c_axis = 1 if nchw else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    return axes, shape


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode batch norm over the batch statistics, as the
    reference computes it: mean and biased variance of X in float32 over
    ``axes``, Y = (X - mean) * rsqrt(var + eps) * scale + bias in float32,
    rounded to X's dtype.  Saves X in its own dtype and the per-channel
    mean and inverse deviation (not float32 copies of X); the backward is
    the closed form of autograd's through that formula, gradients
    through the statistics included:

        dbias = sum(dy), dscale = sum(dy * xhat),
        dx = scale * inv * (dy - dbias / N - xhat * dscale / N),

    with xhat = (x - mean) * inv and N the count a channel reduces over.
    Autograd through the plain formula is slower and larger: ResNet-50 at
    batch 128 on an H100 (batch_norm_probe.py), 129.5 ms and 26.1 GiB a
    bf16 step against 107.5 ms and 20.7 GiB, 203.7 ms against 177.8 in
    float32."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, axes, shape):
        var, mean = torch.var_mean(x.float(), dim=axes, correction=0)
        inv = torch.rsqrt(var + eps)
        mean_b = mean.reshape(shape)
        y = (x - mean_b) * (inv * scale).reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(x, scale, mean_b, inv.reshape(shape))
        ctx.axes = axes
        ctx.mark_non_differentiable(mean, var, inv)
        return y.to(x.dtype), mean, var, inv

    @staticmethod
    def backward(ctx, dy, *_):
        x, scale, mean_b, inv_b = ctx.saved_tensors
        axes = ctx.axes
        n = x.numel() // mean_b.numel()
        dyf = dy.float()
        xhat = (x - mean_b) * inv_b
        dbias = dyf.sum(dim=axes)
        dscale = (dyf * xhat).sum(dim=axes)
        shape = mean_b.shape
        dx = None
        if ctx.needs_input_grad[0]:
            dx = ((dyf - (dbias / n).reshape(shape)
                   - xhat * (dscale / n).reshape(shape))
                  * (scale.reshape(shape) * inv_b)).to(x.dtype)
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None,
                None, None)


@primitive("batch_norm",
           inputs=["X", "Scale", "Bias", "Mean", "Variance"],
           outputs=["Y", "MeanOut", "VarianceOut", "SavedMean",
                    "SavedVariance"],
           stop_grad_slots=("Mean", "Variance"))
def batch_norm(ctx, x, scale, bias, mean, variance):
    """reference batch_norm_op.cc, as the reference computes it.  Train:
    the batch's mean and biased variance (divided by N, not N - 1) in
    float32, and the moving averages ``momentum * moving + (1 -
    momentum) * batch`` as MeanOut / VarianceOut, which the program
    writes back onto the persistable Mean / Variance.  Test (``is_test``,
    which ``Program.clone(for_test=True)`` sets, or the infer mode): the
    moving statistics, passed through unchanged.  SavedMean is the mean
    used and SavedVariance its inverse deviation rsqrt(var + eps).  Y
    has X's dtype; the statistics are float32 whatever X's dtype, so in
    the bf16 recipe a moving stat that starts bf16 (the startup program
    fills it in X's dtype) is float32 from the first step on, as in the
    reference."""
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    axes, shape = _bn_axes(x, ctx.attr("data_layout", "NCHW"))
    if ctx.attr("is_test", False) or ctx.mode == "infer":
        inv = torch.rsqrt(variance.float() + eps)
        y = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        y = y * scale.reshape(shape) + bias.reshape(shape)
        return y.to(x.dtype), mean, variance, mean, inv
    y, bm, bv, inv = _BatchNormTrain.apply(x, scale, bias, eps, axes, shape)
    return (y, weak_scalar(momentum, mean) * mean + (1 - momentum) * bm,
            weak_scalar(momentum, variance) * variance + (1 - momentum) * bv,
            bm, inv)


@primitive("layer_norm", inputs=["X", "Scale?", "Bias?"],
           outputs=["Y", "Mean", "Variance"])
def layer_norm(ctx, x, scale, bias):
    """reference layer_norm_op.cc: normalize over dims [begin_norm_axis:)
    in fp32; Mean and Variance carry no gradient.

    Where no gradient is taken (a step run under ``no_grad``, as serving
    runs), Y, Mean and the reciprocal deviation come from one fused
    ``native_layer_norm``, and Variance from that reciprocal.  Under
    autograd (a training forward whose ``layer_norm_grad`` follows) the
    reference's formula is written out op by op (eight kernels), and its
    gradient is autograd's of those ops: the fused backward moved the
    card's float32 gradients 12x farther from the CPU's at the
    Transformer's step 3."""
    eps = ctx.attr("epsilon", 1e-5)
    axis = ctx.attr("begin_norm_axis", 1)
    lead = x.shape[:axis]
    x2 = x.reshape(*lead, -1).float()
    if not torch.is_grad_enabled():
        y, mu, rstd = torch.native_layer_norm(
            x2, (x2.shape[-1],),
            None if scale is None else scale.reshape(-1),
            None if bias is None else bias.reshape(-1), eps)
        return (y.reshape(x.shape).to(x.dtype), mu.reshape(lead),
                rstd.reshape(lead) ** -2 - eps)
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


@primitive("l2_normalize")
def l2_normalize(ctx, x):
    """X over sqrt(sum(X * X, axis) + epsilon)."""
    norm = torch.sqrt((x * x).sum(dim=ctx.attr("axis", -1), keepdim=True)
                      + ctx.attr("epsilon", 1e-12))
    return x / norm


def nce_negatives(seed, batch: int, k: int, n_classes: int, device):
    """[batch, k] negative class ids, uniform over [0, n_classes): the
    top bits of ``counter_hash(seed, 0, row, col)`` times n_classes.  A
    function of the op's seed alone, drawn on the device (a captured
    step reads a new seed at each replay)."""
    rows = torch.arange(batch, device=device)[:, None]
    cols = torch.arange(k, device=device)[None, :]
    return (counter_hash(seed, 0, rows, cols) * n_classes) >> 32


def nce_loss(x, label, w, b, neg):
    """The reference nce's cost over given negatives ``neg`` [b, k]: the
    logistic loss of each row's label as positive and its k negatives as
    negatives, summed -> [b, 1]."""
    batch = x.shape[0]
    ids = torch.cat([label.reshape(batch, 1).long(), neg.long()], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, w[ids]) + b[ids]
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1.0
    loss = (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.sum(dim=1, keepdim=True)


@primitive("nce", inputs=["Input", "Label", "Weight", "Bias"],
           outputs=["Cost"], stop_grad_slots=("Label",))
def nce(ctx, x, label, w, b):
    """Noise-contrastive estimation (reference nce_op.cc): per row, the
    label and ``num_neg_samples`` uniform negatives (``nce_negatives``
    from the op's seed; the reference draws with ``jax.random``, so the
    ids differ and the rule is the same), scored by ``nce_loss``."""
    k = ctx.attr("num_neg_samples", 10)
    if ctx.seed is None:                     # shape inference: no draw
        neg = torch.zeros(x.shape[0], k, dtype=torch.int64,
                          device=x.device)
    else:
        neg = nce_negatives(ctx.seed, x.shape[0], k,
                            ctx.attr("num_total_classes"), x.device)
    return nce_loss(x, label, w, b, neg)


@primitive("im2sequence")
def im2sequence(ctx, x):
    """reference im2sequence_op.cc: the image's patches as a sequence,
    [b, n_patches, c * kh * kw], features channel-major."""
    k = ctx.attr("kernels", [1, 1])
    s = ctx.attr("strides", [1, 1])
    p = ctx.attr("paddings", [0, 0])
    return F.unfold(x, kernel_size=tuple(k), stride=tuple(s),
                    padding=(p[0], p[1])).transpose(1, 2)


@primitive("fused_attention", inputs=["Q", "K", "V", "Bias?"],
           outputs=["Out"])
def fused_attention(ctx, q, k, v, bias):
    """Fused scaled-dot-product attention: ``kernels.flash_attention``
    (the flash kernels on the card), with attention-probability dropout
    keyed on the op's seed (a tensor on the card, read by the kernels).
    One card: the reference's sequence-parallel
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
                           # no seed in shape inference, where no draw
                           dropout_seed=0 if ctx.seed is None else ctx.seed,
                           layout=ctx.attr("layout", "bhld"))
