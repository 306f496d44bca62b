"""Sequence ops over SeqArray (padded data + lengths) and NestedSeqArray
(padded on two levels) — the port of
``paddle_tpu/fluid/ops/sequence_ops.py``, every op of it.  Offset
walking becomes masking: dense work over [batch, max_len, ...] with the
validity mask.

A gather along the time (or outer) axis goes through ``take_rows`` on
the flattened rows, so its gradient sums repeated positions in a fixed
order (``segment_sum``): a replayed step is the eager step to the bit.
Index and length outputs are the reference's integers exactly; ties in
``kmax_seq_score`` rank the lower position first, as ``lax.top_k``
does (``stable_top_k``)."""

from __future__ import annotations

import torch

from ..core.lod import NestedSeqArray, SeqArray, seq_mask
from ..core.registry import primitive
from ..core.types import runtime_dtype, torch_dtype
from .beam_ops import stable_top_k
from .tensor_ops import take_rows


def _mask(x: SeqArray):
    m = seq_mask(x.lengths, x.max_len)
    return m.reshape(m.shape + (1,) * (x.data.dim() - 2))


def _take_along(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data [b, t, ...] at per-row positions idx [b, k] (in [0, t)) ->
    [b, k, ...], ``take_along_axis`` on axis 1 through ``take_rows``."""
    b, t = data.shape[:2]
    rows = (torch.arange(b, device=idx.device)[:, None] * t
            + idx.long())
    return take_rows(data.reshape((b * t,) + tuple(data.shape[2:])), rows)


def _windows(data: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """Each step's window of ``length`` steps from ``start`` on, zero
    outside [0, t), concatenated on the last axis (data [b, t, d])."""
    t = data.shape[1]
    pos = torch.arange(t, device=data.device)
    cols = []
    for off in range(start, start + length):
        shifted = torch.roll(data, -off, dims=1)
        valid = ((pos + off >= 0) & (pos + off < t)).reshape(1, t, 1)
        cols.append(torch.where(valid, shifted, 0.0))
    return torch.cat(cols, dim=-1)


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
    ctx_mat = _windows(x.data * m, ctx_start, ctx_len)  # [b, t, L * D]
    if ctx_mat.dtype == torch.float32:
        out = torch.matmul(ctx_mat, w)
    else:
        out = torch.matmul(ctx_mat.float(), w.float()).to(data.dtype)
    return SeqArray(out * m, x.lengths)


@primitive("sequence_context", inputs=["X"])
def sequence_context(ctx, x):
    """The context window gather without the projection (the reference's
    ContextProjection): each step's ``context_length`` steps from
    ``context_start`` on, zero outside the sequence, concatenated ->
    [b, t, context_length * d], padding zeroed."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_context expects a sequence input")
    ctx_len = ctx.attr("context_length", 3)
    ctx_start = ctx.attr("context_start", -((ctx_len - 1) // 2))
    m = _mask(x).to(x.data.dtype)
    out = _windows(x.data * m, ctx_start, ctx_len)
    return SeqArray(out * m.to(out.dtype), x.lengths)


@primitive("sequence_expand", inputs=["X", "Y"])
def sequence_expand(ctx, x, y):
    """reference sequence_expand_op.cc: each batch row of X ([B, ...], or
    [B, 1, ...]) broadcast across the steps of Y's sequence in that row,
    padding zeroed by a multiply (the reference's), with Y's lengths.

    A level-2 Y: X is a batch over Y's OUTER axis ([B, N, ...]); each
    outer element broadcasts across its sub-sequence's steps, giving a
    NestedSeqArray with Y's lengths."""
    if isinstance(y, NestedSeqArray):
        xd = x.data if isinstance(x, SeqArray) else x     # [B, N, ...]
        expanded = xd[:, :, None].expand(
            tuple(xd.shape[:2]) + (y.data.shape[2],) + tuple(xd.shape[2:]))
        m = y.inner_mask()
        m = m.reshape(m.shape + (1,) * (expanded.dim() - 3))
        return NestedSeqArray(expanded * m.to(xd.dtype), y.outer_lengths,
                              y.inner_lengths)
    if not isinstance(y, SeqArray):
        raise TypeError("sequence_expand: Y must be a sequence")
    xd = x.data if isinstance(x, SeqArray) else x
    if xd.dim() == y.data.dim():            # [B, 1, ...] -> expand time
        xd = xd[:, 0]
    expanded = xd[:, None].expand((xd.shape[0], y.max_len)
                                  + tuple(xd.shape[1:]))
    m = seq_mask(y.lengths, y.max_len)
    m = m.reshape(m.shape + (1,) * (expanded.dim() - 2))
    return SeqArray(expanded * m.to(xd.dtype), y.lengths)


@primitive("nested_sequence_pool", inputs=["X"])
def nested_sequence_pool(ctx, x):
    """Pool the INNER level of a level-2 batch (paragraphs of sentences
    of words to paragraphs of sentence vectors): NestedSeqArray
    [b, n, m, ...] -> SeqArray [b, n, ...] with the outer lengths.
    ``pool_type`` sum, average (over max(length, 1)) or max (0 where a
    sub-sequence is empty; the gradient spread over tied maxima, as
    ``jnp.max``'s)."""
    if not isinstance(x, NestedSeqArray):
        raise TypeError("nested_sequence_pool expects a level-2 sequence")
    ptype = ctx.attr("pool_type", "sum")
    m = x.inner_mask()
    m = m.reshape(m.shape + (1,) * (x.data.dim() - 3))
    if ptype == "sum":
        out = torch.where(m, x.data, 0.0).sum(dim=2)
    elif ptype == "average":
        cnt = torch.clamp(x.inner_lengths.to(torch.float32), min=1.0)
        out = (torch.where(m, x.data, 0.0).sum(dim=2)
               / cnt.reshape(cnt.shape + (1,) * (x.data.dim() - 3)))
    elif ptype == "max":
        out = torch.where(m, x.data, -torch.inf).amax(dim=2)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        raise ValueError(f"nested_sequence_pool: unknown type {ptype!r}")
    return SeqArray(out, x.outer_lengths)


@primitive("sequence_concat", inputs=["X*"])
def sequence_concat(ctx, xs):
    """reference sequence_concat_op.cc.  axis=0 (the default): each row's
    sequences joined end to end in time, lengths summed, padding zero;
    axis=1: the features of aligned sequences side by side."""
    if not all(isinstance(v, SeqArray) for v in xs):
        raise TypeError("sequence_concat expects sequence inputs")
    axis = int(ctx.attr("axis", 0))
    if axis not in (0, 1):
        raise ValueError(f"sequence_concat: axis must be 0 (time) or 1 "
                         f"(feature), got {axis}")
    if axis == 1:
        return SeqArray(torch.cat([v.data for v in xs], dim=-1),
                        xs[0].lengths)
    # out[j] takes from the input whose window of the row's joined
    # lengths holds j
    total_t = sum(v.data.shape[1] for v in xs)
    dev = xs[0].data.device
    pos = torch.arange(total_t, dtype=torch.int32, device=dev)[None, :]
    out = None
    lengths = torch.zeros_like(xs[0].lengths)
    offset = torch.zeros_like(xs[0].lengths).to(torch.int32)
    for v in xs:
        ln = v.lengths.to(torch.int32)
        rel = pos - offset[:, None]                          # [b, T]
        inside = (rel >= 0) & (rel < ln[:, None])
        gathered = _take_along(v.data,
                               torch.clamp(rel, 0, v.data.shape[1] - 1))
        piece = torch.where(
            inside.reshape(inside.shape + (1,) * (v.data.dim() - 2)),
            gathered, 0)
        out = piece if out is None else out + piece
        offset = offset + ln
        lengths = lengths + v.lengths
    return SeqArray(out, lengths)


@primitive("sequence_reshape")
def sequence_reshape(ctx, x):
    """reference sequence_reshape_op.cc: a new feature width; the time
    axis and the lengths grow or shrink by the same factor (the padded
    extent must divide evenly)."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_reshape expects a sequence input")
    new_dim = ctx.attr("new_dim")
    b, t, d = x.data.shape
    factor = d // new_dim if d >= new_dim else -(new_dim // d)
    if factor > 0:
        return SeqArray(x.data.reshape(b, t * factor, new_dim),
                        x.lengths * factor)
    return SeqArray(x.data.reshape(b, t // (-factor), new_dim),
                    x.lengths // (-factor))


@primitive("sequence_slice", inputs=["X", "Offset", "Length"],
           stop_grad_slots=("Offset", "Length"))
def sequence_slice(ctx, x, offset, length):
    """reference sequence_slice_op.cc: each row's window [offset,
    offset + length) moved to the front (positions clamped to the padded
    extent), length min(length, row length - offset)."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_slice expects a sequence input")
    off = offset.reshape(-1).to(torch.int32)
    ln = length.reshape(-1).to(torch.int32)
    t = x.data.shape[1]
    pos = torch.arange(t, dtype=torch.int32, device=x.data.device)
    gathered = _take_along(x.data, torch.clamp(off[:, None] + pos[None, :],
                                               0, t - 1))
    return SeqArray(gathered, torch.minimum(ln, x.lengths - off))


@primitive("sequence_erase", no_grad=True)
def sequence_erase(ctx, x):
    """reference sequence_erase_op.cc: the tokens in ``tokens`` dropped
    and each sequence compacted in its order (a stable sort of the kept
    positions first), padding zero."""
    if not isinstance(x, SeqArray):
        raise TypeError("sequence_erase expects a sequence input")
    data = x.data
    b, t = data.shape[:2]
    flat = data.reshape(b, t, -1)[:, :, 0]
    keep = seq_mask(x.lengths, t)
    for tok in ctx.attr("tokens", []):
        keep = keep & (flat != tok)
    pos = torch.arange(t, device=data.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, t + 1), dim=1, stable=True)
    feat = (1,) * (data.dim() - 2)
    compacted = torch.gather(
        data, 1, order.reshape((b, t) + feat).expand(data.shape))
    new_len = keep.sum(dim=1).to(torch.int32)
    m = seq_mask(new_len, t).reshape((b, t) + feat)
    return SeqArray(compacted * m.to(data.dtype), new_len)


@primitive("sequence_mask_op", inputs=["X"], no_grad=True)
def sequence_mask_op(ctx, lengths):
    """[b] lengths -> [b, maxlen] mask in ``out_dtype`` (the runtime's
    narrowing: int64 is int32)."""
    return seq_mask(lengths.reshape(-1), ctx.attr("maxlen")).to(
        torch_dtype(runtime_dtype(ctx.attr("out_dtype", "float32"))))


def _topk_indices(scores, lengths, beam):
    """The top-``beam`` positions by score along the last axis of each
    row, among the first ``lengths`` (broadcast over scores[..., :]),
    as float, -1 past min(beam, length) (the reference's real-matrix
    index convention, KmaxSeqScoreLayer.cpp:104-116)."""
    t = scores.shape[-1]
    pos = torch.arange(t, dtype=torch.int32, device=scores.device)
    live = pos < lengths.to(torch.int32)[..., None]
    masked = torch.where(live, scores.float(), -torch.inf)
    k = min(beam, t)
    _, idx = stable_top_k(masked, k)
    k_eff = torch.clamp(lengths.to(torch.int32), max=beam)
    rank = torch.arange(k, dtype=torch.int32, device=scores.device)
    out = torch.where(rank < k_eff[..., None], idx.float(), -1.0)
    if beam > k:                # more slots than steps: -1 padded
        out = torch.cat([out, out.new_full(out.shape[:-1] + (beam - k,),
                                           -1.0)], dim=-1)
    return out


@primitive("kmax_seq_score", inputs=["X"], no_grad=True)
def kmax_seq_score(ctx, x):
    """reference gserver/layers/KmaxSeqScoreLayer.cpp: width-1 scores over
    a sequence -> the positions of its top ``beam_size`` scores, -1 past
    min(beam, length).  A level-2 input scores each sub-sequence: the
    rows ride a SeqArray over the outer axis, a vacant outer slot all
    -1.  No gradient, as in the reference."""
    beam = int(ctx.attr("beam_size", 1))
    if isinstance(x, NestedSeqArray):
        out = _topk_indices(x.data.reshape(x.data.shape[:3]),
                            x.inner_lengths, beam)
        out = torch.where(x.outer_mask()[..., None], out, -1.0)
        return SeqArray(out, x.outer_lengths)
    if not isinstance(x, SeqArray):
        raise TypeError("kmax_seq_score expects a sequence input")
    return _topk_indices(x.data.reshape(x.data.shape[:2]), x.lengths, beam)


@primitive("sub_nested_seq", inputs=["X", "Selection"],
           stop_grad_slots=("Selection",))
def sub_nested_seq(ctx, x, sel):
    """reference gserver/layers/SubNestedSequenceLayer.cpp: whole
    sub-sequences of a level-2 batch picked by per-row indices [b, k];
    the first -1 ends a row's selection (calSelectedRows' break).  Row i
    holds its picks in selection order; the gradient adds the output's
    onto the picked sub-sequences (addToRows), in a fixed order."""
    if not isinstance(x, NestedSeqArray):
        raise TypeError("sub_nested_seq: X must be a level-2 sequence")
    sel = sel.data if isinstance(sel, SeqArray) else sel
    b, n = x.data.shape[:2]
    sel = sel.reshape(b, -1).to(torch.int32)
    valid = torch.cumprod((sel >= 0).to(torch.int32), dim=1).to(torch.bool)
    idx = torch.clamp(sel, 0, n - 1)
    picked = _take_along(x.data, idx)
    vmask = valid.reshape(valid.shape + (1,) * (x.data.dim() - 2))
    inner = torch.where(valid, torch.gather(
        x.inner_lengths.to(torch.int32), 1, idx.long()), 0)
    return NestedSeqArray(picked * vmask.to(picked.dtype),
                          valid.sum(dim=1).to(torch.int32), inner)


@primitive("sequence_pad", inputs=["X"], outputs=["Out", "Mask"])
def sequence_pad(ctx, x):
    """A SeqArray as (its padded data [B, T, ...], a float mask [B, T]
    in its dtype): the bridge to dense ops (reference
    sequence_pad_op.cc).  The gradient reaches the sequence through Out;
    what lands on padding is dropped there."""
    return x.data, seq_mask(x.lengths, x.data.shape[1]).to(x.data.dtype)
