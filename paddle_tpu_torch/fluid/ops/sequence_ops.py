"""Sequence ops over SeqArray (padded data + lengths) — the port of
``paddle_tpu/fluid/ops/sequence_ops.py``, cut to ``sequence_pool``,
``sequence_softmax`` and ``sequence_conv``.  Offset walking becomes
masking: dense work over [batch, max_len, ...] with the validity
mask."""

from __future__ import annotations

import torch

from ..core.lod import SeqArray, seq_mask
from ..core.registry import primitive


def _mask(x: SeqArray):
    m = seq_mask(x.lengths, x.max_len)
    return m.reshape(m.shape + (1,) * (x.data.dim() - 2))


@primitive("sequence_pool", inputs=["X"], outputs=["Out", "MaxIndex"])
def sequence_pool(ctx, x):
    """reference sequence_pool_op.cc: pooltype in {sum, average, sqrt,
    max, last, first}; reduces the time axis -> dense [batch, ...].  A
    row of length 0 pools to 0 (sum, average, sqrt), -inf (max) or its
    padding (first, last)."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_pool expects a sequence input")
    ptype = ctx.attr("pooltype", "sum").lower()
    data = x.data
    m = _mask(x)
    feat = (1,) * (data.dim() - 2)
    if ptype == "max":
        neg = torch.where(m, data.float(), -torch.inf)
        # amax spreads the gradient over tied maxima, as jnp.max does
        return (neg.amax(dim=1).to(data.dtype),
                torch.argmax(neg, dim=1).to(torch.int32))
    if ptype in ("sum", "average", "sqrt"):
        s = (data * m.to(data.dtype)).sum(dim=1)
        n = x.lengths.to(data.dtype).reshape((-1,) + feat)
        if ptype == "average":
            s = s / torch.clamp(n, min=1)
        elif ptype == "sqrt":
            s = s / torch.sqrt(torch.clamp(n, min=1))
        return s, torch.zeros(s.shape, dtype=torch.int32, device=s.device)
    if ptype == "last":
        idx = torch.clamp(x.lengths.to(torch.int64) - 1, min=0)
        idx = idx.reshape((-1, 1) + feat).expand(
            (data.shape[0], 1) + tuple(data.shape[2:]))
        out = torch.gather(data, 1, idx).squeeze(1)
        return out, idx.squeeze(1).to(torch.int32)
    if ptype == "first":
        out = data[:, 0]
        return out, torch.zeros(out.shape, dtype=torch.int32,
                                device=out.device)
    raise ValueError(f"unknown pooltype {ptype}")


@primitive("sequence_softmax")
def sequence_softmax(ctx, x):
    """reference sequence_softmax_op.cc: softmax over each sequence's
    valid positions (the time axis), padding 0."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_softmax expects a sequence input")
    m = _mask(x)
    logits = torch.where(m, x.data.float(), -torch.inf)
    out = torch.softmax(logits, dim=1)
    return SeqArray(torch.where(m, out, 0.0).to(x.data.dtype), x.lengths)


@primitive("sequence_conv", inputs=["X", "Filter"])
def sequence_conv(ctx, x, w):
    """reference sequence_conv_op.cc (ContextProjection): each step's
    window of ``context_length`` steps from ``context_start`` on, zero
    outside the sequence, concatenated and projected by the filter
    [context_length * D, F].  The product is ``torch.matmul`` summed in
    float32, as the reference's ``jnp.matmul`` is."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_conv expects a sequence input")
    ctx_len = ctx.attr("context_length", 3)
    ctx_start = ctx.attr("context_start", -((ctx_len - 1) // 2))
    m = _mask(x).to(x.data.dtype)
    data = x.data * m                                  # padding zeroed
    t = data.shape[1]
    pos = torch.arange(t, device=data.device)
    cols = []
    for off in range(ctx_start, ctx_start + ctx_len):
        shifted = torch.roll(data, -off, dims=1)
        valid = ((pos + off >= 0) & (pos + off < t)).reshape(1, t, 1)
        cols.append(torch.where(valid, shifted, 0.0))
    ctx_mat = torch.cat(cols, dim=-1)                  # [b, t, L * D]
    if ctx_mat.dtype == torch.float32:
        out = torch.matmul(ctx_mat, w)
    else:
        out = torch.matmul(ctx_mat.float(), w.float()).to(data.dtype)
    return SeqArray(out * m, x.lengths)
