"""Miscellaneous ops — the port of ``paddle_tpu/fluid/ops/misc_ops.py``,
whole but ``lstmp``: shape surgery (``pad``, ``crop``,
``rotate``, ``scale_sub_region``, ``lod_reset``), ``selective_fc``,
``lrn``, the small losses (``label_smooth``, ``rank_loss``,
``margin_rank_loss``, ``log_loss``, ``modified_huber_loss``), the
sequence ops ``conv_shift`` and ``row_conv``, the spatial pooling family
(``max_pool2d_with_index``, ``unpool``, ``roi_pool``, ``spp``,
``bilinear_interp``), and ``minus``, ``l1_norm``, ``is_empty``,
``assign_value``, ``isfinite``, ``bilinear_tensor_product``,
``hsigmoid`` and ``sampling_id``.

Each op is the reference's formula in PyTorch, with three rules of the
port: a float attr beside a bf16 input is rounded to bf16 first
(``weak_scalar``); a gather whose gradient sums repeated rows goes
through ``take_rows`` (the fixed-order ``segment_sum`` backward, never
an atomic scatter), so a replayed step is the eager step to the bit; and
no emitter reads a value on the host or copies one to the card (the
constants are fills), so a step that runs them is captured whole.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels.flash_attention import counter_hash
from ..core.lod import SeqArray
from ..core.registry import primitive
from .detection_ops import fills
from .loss_ops import relu_even
from .math_ops import weak_scalar
from .tensor_ops import take_rows


# ---------------------------------------------------------------------------
# shape surgery
# ---------------------------------------------------------------------------


@primitive("pad")
def pad(ctx, x):
    """reference pad_op.cc: paddings = [before0, after0, before1, ...],
    constant ``pad_value``."""
    paddings = ctx.attr("paddings")
    cfg = []
    for i in reversed(range(x.dim())):
        cfg += [paddings[2 * i], paddings[2 * i + 1]]
    return F.pad(x, cfg, value=weak_scalar(ctx.attr("pad_value", 0.0), x))


@primitive("crop", inputs=["X", "Y?"])
def crop(ctx, x, y):
    """reference crop_op.cc: the ``shape`` (an attr, or Y's shape) block
    of X at ``offsets``; -1 keeps the rest of that axis."""
    offsets = ctx.attr("offsets", [0] * x.dim())
    shape = list(y.shape) if y is not None else list(ctx.attr("shape"))
    shape = [x.shape[i] - offsets[i] if s in (None, -1) else s
             for i, s in enumerate(shape)]
    return x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]


@primitive("rotate")
def rotate(ctx, x):
    """reference RotateLayer.cpp: each [H, W] map turned 90 degrees
    clockwise, y[j, i] = x[H - 1 - i, j]; the last two axes swap."""
    return torch.flip(x, dims=(-2,)).transpose(-2, -1)


@primitive("scale_sub_region", inputs=["X", "Indices"],
           stop_grad_slots=("Indices",))
def scale_sub_region(ctx, x, indices):
    """reference ScaleSubRegionOp.cpp: each sample's CHW block
    Indices [b, 6] = 1-based inclusive [c0, c1, h0, h1, w0, w1] times
    ``value``; the gradient is scaled there too."""
    value = weak_scalar(ctx.attr("value", 1.0), x)
    ind = indices.reshape(x.shape[0], 6).to(torch.int32)
    mask = None
    for axis, (lo, hi) in enumerate([(0, 1), (2, 3), (4, 5)]):
        n = x.shape[axis + 1]
        p = torch.arange(n, dtype=torch.int32, device=x.device).reshape(
            (1,) + (1,) * axis + (n,) + (1,) * (2 - axis))
        inside = (p >= (ind[:, lo] - 1).reshape(-1, 1, 1, 1)) \
            & (p <= (ind[:, hi] - 1).reshape(-1, 1, 1, 1))
        mask = inside if mask is None else (mask & inside)
    return torch.where(mask, x * value, x)


@primitive("selective_fc", inputs=["X", "W", "Select", "Bias?"],
           stop_grad_slots=("Select",))
def selective_fc(ctx, x, w, sel, bias):
    """reference SelectiveFullyConnectedLayer.cpp: an fc computed only
    at each row's selected columns, out[b, k] = x[b] . W[:, sel[b, k]]
    (+ bias[sel[b, k]]), 0 at a -1 slot.  The selected columns are
    gathered as rows of W^T by ``take_rows``, so their gradient is
    summed into W in a fixed order."""
    sel_i = sel.data if isinstance(sel, SeqArray) else sel
    sel_i = sel_i.reshape(x.shape[0], -1).to(torch.int32)
    valid = sel_i >= 0
    idx = torch.clamp(sel_i, 0, w.shape[1] - 1)
    wsel = take_rows(w.t(), idx)                       # [b, k, in]
    # summed in float32 from X and the float32 columns (a bf16 X is
    # widened, as the reference's mixed einsum widens it)
    out = torch.einsum("bi,bki->bk", x.float(), wsel.float()).to(x.dtype)
    if bias is not None:
        out = (out + take_rows(bias.reshape(-1), idx)).to(x.dtype)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype,
                                               device=out.device))


@primitive("lod_reset", inputs=["X", "Y?"])
def lod_reset(ctx, x, y):
    """reference lod_reset_op.cc: the same [b, t, ...] data under new
    lengths, Y's when Y is a sequence, else those of the offsets
    ``target_lod``."""
    data = x.data if isinstance(x, SeqArray) else x
    if y is not None and isinstance(y, SeqArray):
        return SeqArray(data, y.lengths)
    target = ctx.attr("target_lod")
    lengths = fills([target[i + 1] - target[i]
                     for i in range(len(target) - 1)], data.device,
                    torch.int32)
    return SeqArray(data, lengths)


# ---------------------------------------------------------------------------
# normalization / losses
# ---------------------------------------------------------------------------


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


@primitive("label_smooth", inputs=["X", "PriorDist?"])
def label_smooth(ctx, x, prior):
    """reference label_smooth_op.cc: (1 - eps) label + eps prior, the
    prior uniform 1 / K when none is given."""
    eps = ctx.attr("epsilon", 0.1)
    if prior is not None:
        return weak_scalar(1.0 - eps, x) * x + weak_scalar(eps, x) * prior
    return weak_scalar(1.0 - eps, x) * x + weak_scalar(eps / x.shape[-1], x)


@primitive("rank_loss", inputs=["Label", "Left", "Right"],
           stop_grad_slots=("Label",))
def rank_loss(ctx, label, left, right):
    """reference rank_loss_op.cc (RankNet): C = left - right, out =
    log(1 + e^C) - label C."""
    c = left - right
    return torch.logaddexp(torch.zeros((), dtype=c.dtype, device=c.device),
                           c) - label * c


@primitive("margin_rank_loss", inputs=["Label", "X1", "X2"],
           outputs=["Out", "Activated"], stop_grad_slots=("Label",))
def margin_rank_loss(ctx, label, x1, x2):
    """reference margin_rank_loss_op.cc: out = max(0, -label (x1 - x2)
    + margin); Activated marks out > 0 (no gradient)."""
    raw = -label * (x1 - x2) + weak_scalar(ctx.attr("margin", 0.0), x1)
    return relu_even(raw), (raw > 0).to(x1.dtype).detach()


@primitive("log_loss", inputs=["Predicted", "Labels"],
           outputs=["Loss"], stop_grad_slots=("Labels",))
def log_loss(ctx, pred, label):
    """reference log_loss_op.cc: -l log(p + eps) - (1 - l) log(1 - p +
    eps)."""
    eps = weak_scalar(ctx.attr("epsilon", 1e-4), pred)
    return (-label * torch.log(pred + eps)
            - (1.0 - label) * torch.log(1.0 - pred + eps))


@primitive("modified_huber_loss", inputs=["X", "Y"],
           outputs=["Out", "IntermediateVal"], stop_grad_slots=("Y",))
def modified_huber_loss(ctx, x, y):
    """reference modified_huber_loss_op.cc (labels {0, 1} -> {-1, +1}):
    v = (2y - 1) x; out = max(0, 1 - v)^2 for v >= -1, else -4v."""
    v = (2.0 * y - 1.0) * x
    out = torch.where(v < -1.0, -4.0 * v, torch.square(relu_even(1.0 - v)))
    return out, v.detach()


# ---------------------------------------------------------------------------
# sequence kernels
# ---------------------------------------------------------------------------


@primitive("conv_shift", inputs=["X", "Y"])
def conv_shift(ctx, x, y):
    """reference conv_shift_op.cc: per-row circular correlation (the NTM
    rotation), x [b, w], y [b, m], m odd: out[b, i] = sum_j
    x[b, (i + j - m // 2) mod w] y[b, j]."""
    m = y.shape[1]
    half = m // 2
    shifted = torch.stack([torch.roll(x, shifts=half - j, dims=1)
                           for j in range(m)], dim=-1)
    return torch.einsum("bwm,bm->bw", shifted, y)


@primitive("row_conv", inputs=["X", "Filter"])
def row_conv(ctx, x, w):
    """reference row_conv_op.cc, DeepSpeech2's lookahead convolution:
    out[t] = sum_{j <= ctx} x[t + j] * w[j] within each sequence (frames
    past a sequence's end add nothing), summed from j = 0 up."""
    assert isinstance(x, SeqArray), "row_conv expects a sequence input"
    data = x.data
    ctx_len = w.shape[0]
    t = data.shape[1]
    valid = (torch.arange(t, device=data.device)[None, :, None]
             < x.lengths.to(data.device)[:, None, None])
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    padded = F.pad(torch.where(valid, data, zero),
                   (0, 0, 0, ctx_len - 1))
    out = 0
    for j in range(ctx_len):
        out = out + padded[:, j: j + t] * w[j]
    return SeqArray(torch.where(valid, out, zero), x.lengths)


# ---------------------------------------------------------------------------
# spatial pooling family
# ---------------------------------------------------------------------------


@primitive("max_pool2d_with_index", outputs=["Out", "Mask"])
def max_pool2d_with_index(ctx, x):
    """reference pool_with_index_op.cc: max pool (no padding) and the
    flat h * W + w index of each window's first maximum (``Mask``, what
    ``unpool`` reads).  Tied maxima share the gradient evenly, as the
    reference's ``jnp.max``."""
    k = ctx.attr("ksize", [2, 2])
    s = ctx.attr("strides", list(k))
    b, c, h, w = x.shape
    oh = (h - k[0]) // s[0] + 1
    ow = (w - k[1]) // s[1] + 1
    win = x[:, :, :(oh - 1) * s[0] + k[0], :(ow - 1) * s[1] + k[1]] \
        .unfold(2, k[0], s[0]).unfold(3, k[1], s[1]) \
        .reshape(b, c, oh, ow, k[0] * k[1])
    out = torch.amax(win, dim=-1)
    arg = torch.argmax(win.detach(), dim=-1)
    dev = x.device
    rows = torch.arange(oh, device=dev)[:, None] * s[0] + arg // k[1]
    cols = torch.arange(ow, device=dev)[None, :] * s[1] + arg % k[1]
    return out, (rows * w + cols).to(torch.int32)


@primitive("unpool", inputs=["X", "Indices"], stop_grad_slots=("Indices",))
def unpool(ctx, x, indices):
    """reference unpool_op.cc: each pooled value written back at its
    flat position from ``max_pool2d_with_index``, zeros elsewhere."""
    out_hw = ctx.attr("unpooled_size")
    b, c, oh, ow = x.shape
    flat = torch.zeros(b, c, out_hw[0] * out_hw[1], dtype=x.dtype,
                       device=x.device)
    flat = flat.scatter(2, indices.reshape(b, c, oh * ow).long(),
                        x.reshape(b, c, oh * ow))
    return flat.reshape(b, c, out_hw[0], out_hw[1])


def roi_bins(rois, scale, ph, pw, h, w):
    """Each RoI's image and bin bounds, as the reference's Executor
    computes them (``misc_ops.py:roi_pool``, compiled): corners rounded
    half to even, the RoI's extent at least 1, bin edges
    floor(y1 + rh c_i) and ceil(y1 + rh c_{i + 1}) with c_i the float32
    product of i and the float32 reciprocal of ph (XLA folds ``i * rh /
    ph`` into rh times that constant) -> (image [R], row masks [R, ph,
    h], column masks [R, pw, w]); bins clipped to the map."""
    scale = float(torch.tensor(scale, dtype=torch.float32))
    r = rois.to(torch.float32)
    bi = r[:, 0].to(torch.int32)
    x1, y1, x2, y2 = (torch.round(r[:, i] * scale) for i in (1, 2, 3, 4))
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)

    def masks(lo, extent, n, size):
        inv = np.float32(1.0) / np.float32(n)
        edges = [float(np.float32(i) * inv) for i in range(n + 1)]
        pos = torch.arange(size, dtype=torch.float32, device=r.device)
        out = []
        for i in range(n):
            start = torch.floor(lo + extent * edges[i])
            end = torch.ceil(lo + extent * edges[i + 1])
            out.append((pos[None, :] >= start[:, None])
                       & (pos[None, :] < end[:, None]))
        return torch.stack(out, dim=1)

    return bi, masks(y1, rh, ph, h), masks(x1, rw, pw, w)


class _RoIPool(torch.autograd.Function):
    """Max over each RoI bin, columns first, then rows, with the
    reference's tie rule: a bin's gradient is split evenly among every
    element equal to its maximum (``jnp.max``'s), an empty bin gives 0
    and no gradient.  Never more than one [R, W, C, H] block is held: a
    bin column at a time, its maximum taken over W with C and H
    contiguous (and each bin row's over H with C contiguous), so every
    reduction runs over an outer axis.  Every sum of the backward runs
    in a fixed order (bins in index order, then RoIs in index order into
    their images), so the gradient is the same bits on every device and
    at every run."""

    @staticmethod
    def forward(ctx, x, bi, ymask, xmask):
        pw = xmask.shape[1]
        xg = x.permute(0, 3, 1, 2).index_select(0, bi.long())  # [R,W,C,H]
        ninf = torch.full((), -torch.inf, dtype=x.dtype, device=x.device)
        cm, cc = [], []
        for j in range(pw):
            t = torch.where(xmask[:, j, :, None, None], xg, ninf)
            m = torch.amax(t, dim=1)                         # [R, C, H]
            cm.append(m)
            cc.append((t == m[:, None]).sum(dim=1).to(x.dtype))
        cm = torch.stack(cm, dim=1)                          # [R, pw, C, H]
        cc = torch.stack(cc, dim=1).transpose(2, 3)          # [R, pw, H, C]
        t2 = torch.where(ymask[:, :, None, :, None],
                         cm.transpose(2, 3)[:, None], ninf)  # [R,ph,pw,H,C]
        m2 = torch.amax(t2, dim=3)                           # [R, ph, pw, C]
        eq2 = t2 == m2[:, :, :, None]
        count = torch.where(eq2, cc[:, None], 0).sum(dim=3)
        ctx.save_for_backward(x, bi, xmask, cm, eq2, m2, count)
        out = torch.where(torch.isfinite(m2), m2, 0)
        return out.permute(0, 3, 1, 2)                       # [R, C, ph, pw]

    @staticmethod
    def backward(ctx, g):
        x, bi, xmask, cm, eq2, m2, count = ctx.saved_tensors
        R, ph, pw = eq2.shape[:3]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        share = torch.where(torch.isfinite(m2),
                            g.permute(0, 2, 3, 1) / count, zero)
        g_cm = torch.where(eq2[:, 0], share[:, 0, :, None], zero)
        for i in range(1, ph):                               # [R, pw, H, C]
            g_cm = g_cm + torch.where(eq2[:, i], share[:, i, :, None], zero)
        g_cm = g_cm.transpose(2, 3)                          # [R, pw, C, H]
        xg = x.permute(0, 3, 1, 2).index_select(0, bi.long())
        g_roi = None
        for j in range(pw):
            hit = (xg == cm[:, None, j]) & xmask[:, j, :, None, None]
            part = torch.where(hit, g_cm[:, None, j], zero)
            g_roi = part if g_roi is None else g_roi + part
        gx = xg.new_zeros((x.shape[0],) + tuple(xg.shape[1:]))  # [B,W,C,H]
        for r in range(R):          # one RoI at a time: one add an element
            gx.index_add_(0, bi[r:r + 1].long(), g_roi[r:r + 1])
        return gx.permute(0, 2, 3, 1), None, None, None


@primitive("roi_pool", inputs=["X", "ROIs"], outputs=["Out"],
           stop_grad_slots=("ROIs",))
def roi_pool(ctx, x, rois):
    """reference roi_pool_op.cc: per RoI [image, x1, y1, x2, y2] (input
    coordinates, times ``spatial_scale``) a max pool to [pooled_height,
    pooled_width] bins -> [R, C, ph, pw].  The reference takes each of
    the ph x pw bins as a masked max over the whole map, vmapped over
    RoIs; here a bin column's masked max over W, then a bin row's over
    H (``_RoIPool``), with the reference's bin edges (``roi_bins``) and
    tie rule."""
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    b, c, h, w = x.shape
    if x.device.type == "meta":
        return torch.empty((rois.shape[0], c, ph, pw), dtype=x.dtype,
                           device="meta")
    bi, ymask, xmask = roi_bins(rois, ctx.attr("spatial_scale", 1.0), ph,
                                pw, h, w)
    return _RoIPool.apply(x, bi, ymask, xmask)


@primitive("spp", outputs=["Out"])
def spp(ctx, x):
    """reference spp_op.cc: spatial pyramid pooling, max (or average)
    pools of 2^l x 2^l bins for levels l < ``pyramid_height`` (row i's
    bin i * bins // H), each flattened channel-major, concatenated ->
    [b, c * sum(4^l)].  A max bin with no element is 0; tied maxima
    share the gradient evenly (the reference's segment max)."""
    levels = ctx.attr("pyramid_height", 3)
    pool_type = ctx.attr("pooling_type", "max")
    b, c, h, w = x.shape
    flat = x.reshape(b, c, 1, h * w)
    outs = []
    for lv in range(levels):
        bins = 2 ** lv
        ys = (torch.arange(h, device=x.device) * bins) // h
        xs = (torch.arange(w, device=x.device) * bins) // w
        seg = (ys[:, None] * bins + xs[None, :]).reshape(-1)
        member = seg[None, :] == torch.arange(bins * bins,
                                              device=x.device)[:, None]
        if pool_type == "max":
            pooled = torch.amax(torch.where(member, flat, -torch.inf),
                                dim=-1)
            pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
        else:
            pooled = torch.where(member, flat, 0.0).sum(dim=-1) \
                / member.sum(dim=-1).to(x.dtype)
        outs.append(pooled.reshape(b, -1))
    return torch.cat(outs, dim=1)


@primitive("bilinear_interp", inputs=["X"])
def bilinear_interp(ctx, x):
    """Bilinear upsampling of [B, C, H, W] to (out_h, out_w) with the
    reference's align-corners ratio (in - 1) / (out - 1)
    (BilinearInterpLayer.cpp), the reference's formula op for op; the
    corner rows and columns are gathered by ``take_rows``."""
    out_h = int(ctx.attr("out_h"))
    out_w = int(ctx.attr("out_w"))
    b, ch, h, wdt = x.shape
    ry = (h - 1) / (out_h - 1) if out_h > 1 else 0.0
    rx = (wdt - 1) / (out_w - 1) if out_w > 1 else 0.0
    dev = x.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) \
        * float(np.float32(ry))
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) \
        * float(np.float32(rx))
    y0 = torch.clamp(torch.floor(ys).to(torch.int32), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int32), 0, wdt - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, wdt - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]

    def at(yi, xi):
        rows = take_rows(x.permute(2, 0, 1, 3), yi)        # [oh, B, C, W]
        cols = take_rows(rows.permute(3, 1, 2, 0), xi)     # [ow, B, C, oh]
        return cols.permute(1, 2, 3, 0)

    a, b_, cc, d = at(y0, x0), at(y0, x1), at(y1, x0), at(y1, x1)
    top = a * (1 - wx) + b_ * wx
    bot = cc * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# small ops
# ---------------------------------------------------------------------------


@primitive("minus", inputs=["X", "Y"], seq_transparent=True)
def minus(ctx, x, y):
    """reference minus_op.cc: X - Y."""
    return x - y


@primitive("l1_norm")
def l1_norm(ctx, x):
    """reference l1_norm_op.cc: sum(|X|), a scalar."""
    return torch.sum(torch.abs(x))


@primitive("is_empty", no_grad=True)
def is_empty(ctx, x):
    """reference is_empty_op.cc: a boolean scalar, true iff X has no
    element; a function of X's static shape, filled on X's device."""
    data = x.data if isinstance(x, SeqArray) else x
    return torch.full((), 0 in tuple(data.shape), dtype=torch.bool,
                      device=data.device)


@primitive("assign_value", inputs=[], no_grad=True)
def assign_value(ctx):
    """reference assign_value_op.cc: a constant of ``shape`` from
    ``fp32_values`` (float32) or else ``int32_values`` (int32), filled
    on the op's device."""
    shape = ctx.attr("shape")
    fp32 = ctx.attr("fp32_values", None)
    int32 = ctx.attr("int32_values", None)
    if fp32:
        return fills([float(v) for v in fp32], ctx.device).reshape(shape)
    return fills([int(v) for v in int32 or []], ctx.device,
                 torch.int32).reshape(shape)


def all_finite(values) -> torch.Tensor:
    """A 0-d bool tensor on the values' device: true iff every element of
    every float tensor among ``values`` (SeqArrays: their data) is
    finite.  Non-float values are vacuously finite.  One reduction per
    tensor, no host read: the guarded step's sentinel
    (``resilience/guardrails.py``) captures it in the step's graph."""
    flag = None
    for v in values:
        data = v.data if isinstance(v, SeqArray) else v
        if not (isinstance(data, torch.Tensor)
                and data.dtype.is_floating_point):
            continue
        ok = torch.isfinite(data).all()
        flag = ok if flag is None else torch.logical_and(flag, ok)
    if flag is None:
        dev = next((t.device for t in (
            v.data if isinstance(v, SeqArray) else v for v in values)
            if isinstance(t, torch.Tensor)), torch.device("cpu"))
        flag = torch.ones((), dtype=torch.bool, device=dev)
    return flag


@primitive("isfinite", inputs=["X*"], no_grad=True)
def isfinite(ctx, xs):
    """reference isfinite_op.cc (fluid ``layers.isfinite``): Out = a
    scalar bool, true iff EVERY element of every input tensor is finite;
    non-float inputs are vacuously finite, as the reference scans float
    tensors only."""
    return all_finite(xs)


@primitive("bilinear_tensor_product",
           inputs=["X", "Y", "Weight", "Bias?"])
def bilinear_tensor_product(ctx, x, y, w, bias):
    """reference bilinear_tensor_product_op.cc: Out[b, k] = X[b] W[k]
    Y[b]^T (+ bias[k]), W [size, dx, dy]."""
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return out


def hsigmoid_path_length(c) -> torch.Tensor:
    """floor(log2 c) of int codes c as the reference computes it: float32
    log c over log 2 (``jnp.log2``), floored; int32."""
    two = torch.full((), 2.0, dtype=torch.float32, device=c.device)
    return torch.floor(torch.log(c.to(torch.float32))
                       / torch.log(two)).to(torch.int32)


@primitive("hsigmoid", inputs=["X", "Label", "W", "Bias?"],
           outputs=["Out"])
def hsigmoid(ctx, x, label, w, bias):
    """Hierarchical sigmoid cost over the default complete binary tree
    (reference HierarchicalSigmoidLayer.cpp with MatrixBitCode's
    SimpleCode: c = label + num_classes, node j = (c >> (j + 1)) - 1,
    bit j = (c >> j) & 1, length floor(log2 c) in float32 as the
    reference's ``jnp.log2`` computes it): per row the sum over its path
    of softplus(pre) - bit pre, pre = W[node] . x + bias[node] clipped
    to +-40 -> [B, 1].  W's rows are gathered by ``take_rows``: the top
    nodes, shared by every row, get their gradient summed in a fixed
    order."""
    num_classes = int(ctx.attr("num_classes"))
    lab = label.reshape(-1).to(torch.int32)
    c = lab + num_classes
    max_len = max(1, int(np.ceil(np.log2(2 * num_classes - 1))))
    js = torch.arange(max_len, dtype=torch.int32, device=x.device)
    length = hsigmoid_path_length(c)
    valid = js[None, :] < length[:, None]
    idx = torch.clamp((c[:, None] >> (js[None, :] + 1)) - 1, 0,
                      num_classes - 2)
    bit = ((c[:, None] >> js[None, :]) & 1).to(torch.float32)
    rows = take_rows(w, idx)                           # [B, D, F]
    pre = torch.einsum("bdf,bf->bd", rows.float(), x.float())
    if bias is not None:
        pre = pre + take_rows(bias.reshape(-1), idx).float()
    pre = torch.clamp(pre, -40.0, 40.0)
    per = torch.logaddexp(pre, torch.zeros((), device=pre.device)) \
        - bit * pre
    return torch.where(valid, per, 0.0).sum(dim=1, keepdim=True)


@primitive("sampling_id", inputs=["X"], no_grad=True)
def sampling_id(ctx, x):
    """One class id per row drawn from the row's distribution (reference
    SamplingIdLayer.cpp) -> [B, 1] int32: the Gumbel-max rule of the
    reference's ``jax.random.categorical`` over log(max(x, 1e-20)), its
    uniforms from the op's seed by the kernels' counter hash (the
    reference draws with ``jax.random``: the ids differ, their law is
    the same)."""
    b, n = x.shape[0], x.shape[-1]
    if ctx.seed is None:                     # shape inference: no draw
        return torch.zeros(b, 1, dtype=torch.int32, device=x.device)
    logits = torch.log(torch.clamp(x.reshape(b, n).to(torch.float32),
                                   min=1e-20))
    rows = torch.arange(b, device=x.device)[:, None]
    cols = torch.arange(n, device=x.device)[None, :]
    u = (counter_hash(ctx.seed, 1, rows, cols).to(torch.float64) + 0.5) \
        * 2.0 ** -32
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.double() + gumbel, dim=-1).reshape(
        b, 1).to(torch.int32)
