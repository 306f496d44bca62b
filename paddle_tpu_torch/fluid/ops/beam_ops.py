"""Beam search ops on a dense [batch, beam] grid — the port of
``paddle_tpu/fluid/ops/beam_ops.py``.

* ``beam_search``: one step.  Each beam's top-K candidates expand to a
  [batch, beam * K] grid of accumulated log-probabilities; a finished
  beam (``pre_id == end_id``) offers exactly one candidate, ``end_id``
  at its frozen score, so it survives the ranking without growing; the
  best ``beam_size`` of the grid are selected, with their parent beam.
* ``beam_search_decode``: the backtrace of the per-step (ids, parents)
  arrays into whole hypotheses, trimmed after the first ``end_id``,
  best first, as a ``NestedSeqArray``.
* ``batch_gather``: ``out[b, j] = x[b, index[b, j]]``, the dense beam's
  cache reorder; its gradient is the scatter-add transpose autograd
  derives.

Ties rank as ``jax.lax.top_k`` ranks them, the lower index first: the
selection is a stable descending sort, on the CPU and on the card.  Ties
are common here: every other candidate of a finished beam sits at
exactly ``NEG_INF``, and the first step's empty beams start at -1e9,
where a float32 ulp is 64, so ``-1e9 + log p`` collapses many
candidates to one value.  No emitter reads a value on the host: the
beam step is captured in a CUDA graph.
"""

from __future__ import annotations

import torch

from ..core.lod import NestedSeqArray
from ..core.registry import primitive

__all__ = ["NEG_INF", "stable_top_k", "beam_search", "beam_search_decode",
           "batch_gather"]

NEG_INF = -1e9


def stable_top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis and their int64
    indices, in descending order, equal values in ascending index order
    (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@primitive("beam_search",
           inputs=["pre_ids", "pre_scores", "ids", "scores"],
           outputs=["selected_ids", "selected_scores", "parent_idx"],
           no_grad=True)
def beam_search(ctx, pre_ids, pre_scores, ids, scores):
    """One beam-search step.  ``pre_ids`` / ``pre_scores`` [B, W]: the
    beams' last tokens and accumulated log-probabilities; ``ids`` /
    ``scores`` [B, W, K]: each beam's top-K candidate tokens and their
    probabilities (attr ``is_accumulated=True``: already accumulated
    log-probabilities).  Returns (selected ids [B, W], selected scores
    [B, W], parent beam [B, W] int32)."""
    beam_size = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    accumulated = bool(ctx.attr("is_accumulated", False))

    B, W, K = scores.shape
    if accumulated:
        total = scores
    else:
        total = pre_scores[..., None] + torch.log(
            torch.clamp(scores.to(torch.float32), min=1e-12))
    finished = (pre_ids == end_id)[..., None]                 # [B, W, 1]
    only = torch.arange(K, device=scores.device) == 0         # [K]
    frozen = torch.where(only, pre_scores[..., None],
                         torch.full_like(total, NEG_INF))
    total = torch.where(finished, frozen, total)
    ids = torch.where(finished, torch.full_like(ids, end_id), ids)

    sel_scores, flat_idx = stable_top_k(total.reshape(B, W * K), beam_size)
    parent = (flat_idx // K).to(torch.int32)
    sel_ids = torch.gather(ids.reshape(B, W * K), 1, flat_idx) \
        .to(pre_ids.dtype)
    return sel_ids, sel_scores, parent


@primitive("beam_search_decode",
           inputs=["Ids", "Scores", "Parents"],
           outputs=["SentenceIds", "SentenceScores"], no_grad=True)
def beam_search_decode(ctx, ids_arr, scores_arr, parents_arr):
    """Backtrace the decode loop's per-step arrays (SeqArrays whose data
    is [T, B, W]: index 0 the start tokens, index t >= 1 step t's
    selected ids, scores and parents) into hypotheses.  Returns
    SentenceIds as a NestedSeqArray (data [B, W, T-1], ``end_id`` after
    the first ``end_id``; outer lengths W; inner lengths up to and
    including the first ``end_id``, the whole row without one) and
    SentenceScores [B, W], beams best first.  The reverse walk is a loop
    over T, the steps taken, which each call fixes."""
    end_id = int(ctx.attr("end_id"))
    ids = ids_arr.data
    parents = parents_arr.data.to(torch.long)
    scores = scores_arr.data
    T, B, W = ids.shape

    final_scores = scores[T - 1]                              # [B, W]
    cursor = torch.arange(W, device=ids.device).expand(B, W)
    toks = []
    for t in range(T - 1, 0, -1):
        toks.append(torch.gather(ids[t], 1, cursor))
        cursor = torch.gather(parents[t], 1, cursor)
    sents = (torch.stack(toks[::-1], dim=-1) if toks
             else ids.new_zeros((B, W, 0)))                   # [B, W, T-1]

    # everything after the first end_id becomes end_id padding
    is_end = sents == end_id
    seen = torch.cumsum(is_end.to(torch.int32), dim=-1)
    sents = torch.where(seen > 1, torch.full_like(sents, end_id), sents)

    # best first, a stable sort as jnp.argsort's
    order = torch.argsort(-final_scores, dim=1, stable=True)  # [B, W]
    sents = torch.gather(sents, 1, order[..., None].expand_as(sents))
    final_scores = torch.gather(final_scores, 1, order)

    is_end = sents == end_id
    first_end = torch.argmax(is_end.to(torch.int32), dim=-1)
    inner = torch.where(is_end.any(dim=-1), first_end + 1,
                        torch.full_like(first_end, sents.shape[-1]))
    outer = torch.full((B,), W, dtype=torch.int32, device=ids.device)
    return (NestedSeqArray(sents, outer, inner.to(torch.int32)),
            final_scores)


@primitive("batch_gather", inputs=["X", "Index"], stop_grad_slots=("Index",))
def batch_gather(ctx, x, index):
    """Reorder along axis 1 by per-batch indices: out[b, j] = x[b,
    index[b, j]] (the index broadcast over X's trailing dims)."""
    idx = index.to(torch.long)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - idx.dim()))
    return torch.take_along_dim(x, idx, dim=1)
