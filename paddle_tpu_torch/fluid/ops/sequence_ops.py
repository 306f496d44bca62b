"""Sequence ops over SeqArray (padded data + lengths) — the port of
``paddle_tpu/fluid/ops/sequence_ops.py``, cut to ``sequence_pool``.
Offset walking becomes masking: a dense reduction over
[batch, max_len, ...] with the validity mask."""

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
