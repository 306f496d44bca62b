"""Softmax, losses and metrics — the port of
``paddle_tpu/fluid/ops/loss_ops.py``, cut to ``softmax``,
``cross_entropy``, ``softmax_with_cross_entropy``,
``fused_vocab_cross_entropy``, ``square_error_cost`` and ``accuracy``."""

from __future__ import annotations

import torch

from ..core.lod import SeqArray
from ..core.registry import primitive


@primitive("softmax", seq_transparent=True)
def softmax(ctx, x):
    return torch.softmax(x, dim=-1)


def _label_ce(logp, label, soft_label):
    """Cross-entropy core (reference operators/math/cross_entropy.cc)."""
    if soft_label:
        return -(label * logp).sum(dim=-1, keepdim=True)
    ids = label
    if ids.dim() == logp.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return -torch.gather(logp, -1, ids.long()[..., None])


@primitive("cross_entropy", inputs=["X", "Label"], stop_grad_slots=("Label",),
           seq_transparent=True)
def cross_entropy(ctx, x, label):
    """X is a probability distribution (after a softmax), as in the
    reference's cross_entropy_op.cc."""
    logp = torch.log(torch.clamp(x, min=1e-8))
    return _label_ce(logp, label, ctx.attr("soft_label", False))


@primitive("accuracy", inputs=["Out", "Indices", "Label"],
           outputs=["Accuracy", "Correct", "Total"], no_grad=True)
def accuracy(ctx, out, indices, label):
    """reference accuracy_op.cc: a row is correct when its label is among
    its top-k indices.  Correct and Total are int32 scalars; Total is the
    batch size, filled on the device (no host copy)."""
    if isinstance(indices, SeqArray):
        indices, label = indices.data, label.data
    lbl = label.reshape(label.shape[0], -1)[:, :1].to(torch.int32)
    hit = (indices.to(torch.int32) == lbl).any(dim=-1)
    total = torch.full((), hit.shape[0], dtype=torch.int32,
                       device=hit.device)
    correct = hit.sum().to(torch.int32)
    return correct.float() / total.float(), correct, total


@primitive("softmax_with_cross_entropy", inputs=["Logits", "Label"],
           outputs=["Softmax", "Loss"], stop_grad_slots=("Label",))
def softmax_with_cross_entropy(ctx, logits, label):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.exp(logp), _label_ce(logp, label,
                                      ctx.attr("soft_label", False))


@primitive("square_error_cost", inputs=["X", "Y"], seq_transparent=True)
def square_error_cost(ctx, x, y):
    """reference square_error_cost: (X - Y)^2 elementwise."""
    d = x - y
    return d * d


def _mm_f32(a, b):
    """a @ b of 2-d operands as float32, summed in float32: for bf16
    operands the reference's ``preferred_element_type=float32`` product,
    which the card computes on the bf16 tensor cores (``out_dtype``)
    and the CPU in float32, where every bf16 product is exact."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _vocab_chunks(v: int, chunk: int):
    """(start, width) of each vocab chunk; the last carries the rest."""
    starts = list(range(0, v, max(1, chunk)))
    return [(s, min(chunk, v - s)) for s in starts]


class _ChunkedVocabXent(torch.autograd.Function):
    """Streaming projection + cross-entropy over vocab chunks: the [N, V]
    logits are never held whole.  The forward keeps a running max and sum
    per row (online logsumexp) and saves only the [N] lse; the backward
    recomputes each chunk's logits and folds (softmax - onehot) into the
    dW and dX products.  The reference's custom_vjp, as a plain torch
    Function (the reference has no kernel here either).  Under the amp
    recipe X is bf16 and W an f32 master: W's chunks are cast down, every
    product is summed and kept in f32 (``_mm_f32``) and only the logit
    gradients are rounded to X's dtype, as the reference does."""

    @staticmethod
    def forward(ctx, x2, w, ids, chunk):
        n = x2.shape[0]
        m = torch.full((n,), -torch.inf, device=x2.device)
        s = torch.zeros(n, device=x2.device)
        lab = torch.zeros(n, device=x2.device)
        for start, width in _vocab_chunks(w.shape[1], chunk):
            logits = _mm_f32(x2, w[:, start:start + width].to(x2.dtype))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            rel = ids - start
            in_c = (rel >= 0) & (rel < width)
            ll = torch.gather(logits, 1,
                              rel.clamp(0, width - 1)[:, None])[:, 0]
            lab = torch.where(in_c, ll, lab)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x2, w, ids, lse)
        ctx.chunk = chunk
        return lse - lab

    @staticmethod
    def backward(ctx, dloss):
        x2, w, ids, lse = ctx.saved_tensors
        dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        dw = []
        for start, width in _vocab_chunks(w.shape[1], ctx.chunk):
            wc = w[:, start:start + width].to(x2.dtype)
            p = torch.exp(_mm_f32(x2, wc) - lse[:, None])
            rel = ids - start
            in_c = (rel >= 0) & (rel < width)
            # softmax - onehot, as a scatter: a boolean index would wait
            # for the card to count the selected rows
            p.scatter_add_(1, torch.where(in_c, rel, 0)[:, None],
                           -in_c.to(p.dtype)[:, None])
            dlog = (p * dloss[:, None]).to(x2.dtype)
            dx += _mm_f32(dlog, wc.t())
            dw.append(_mm_f32(x2.t(), dlog))
        return (dx.to(x2.dtype), torch.cat(dw, dim=1).to(w.dtype), None,
                None)


@primitive("fused_vocab_cross_entropy", inputs=["X", "W", "Label"],
           outputs=["Loss"], stop_grad_slots=("Label",))
def fused_vocab_cross_entropy(ctx, x, w, label):
    """Streaming fc + softmax + cross-entropy over the vocab axis: the
    same math as fc(no bias) + softmax_with_cross_entropy up to fp32
    summation order.  X [.., D], W [D, V], Label [.., 1] or [..] ->
    Loss [.., 1] fp32."""
    lead = tuple(x.shape[:-1])
    if x.device.type == "meta":
        return torch.empty(lead + (1,), dtype=torch.float32, device="meta")
    ids = label
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    loss = _ChunkedVocabXent.apply(x.reshape(-1, x.shape[-1]), w,
                                   ids.reshape(-1).long(),
                                   int(ctx.attr("chunk", 8192)))
    return loss.reshape(*lead, 1)
