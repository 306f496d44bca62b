"""Linear-chain CRF and chunk evaluation — the port of
``paddle_tpu/fluid/ops/crf_ops.py`` (the reference's
linear_chain_crf_op.cc, crf_decoding_op.cc and chunk_eval_op.cc).

The reference runs the forward algorithm and Viterbi as ``lax.scan``s
over the padded time axis; here they are Python loops of a static trip
count (the padded length), plain PyTorch ops with no host sync, so a
training step that holds them is captured in one CUDA graph like
``dynamic_recurrent``.  ``linear_chain_crf``'s gradient is autograd's
through the loop, as the reference's is JAX's vjp through the scan.

The gold path's scores read ``start[label_0]``, ``trans[prev, cur]``
and ``stop[last]`` with many repeated indices.  Autograd's adjoint of a
repeated-index gather is ``index_put_(accumulate=True)``, float atomics
on the card, whose sum order changes from run to run; so those scores
are products with one-hot tensors instead (a one-hot row times the
table, then times the one-hot of the next tag), whose adjoints are
matmuls and batch reductions in a fixed order.  Each product adds one
table entry to exact zeros, so the scores are the gathered values
bitwise.

Transition layout as in the reference: row 0 start scores, row 1 stop
scores, rows 2.. the [tags, tags] transition matrix.
"""

from __future__ import annotations

import torch

from ..core.lod import SeqArray, seq_mask
from ..core.registry import primitive


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]


def _labels(label, b: int, t: int) -> torch.Tensor:
    lbl = label.data if isinstance(label, SeqArray) else label
    return lbl.reshape(b, t).long()


def _one_hot(ids: torch.Tensor, k: int, dtype) -> torch.Tensor:
    return (ids[..., None] == torch.arange(k, device=ids.device)).to(dtype)


@primitive("linear_chain_crf", inputs=["Emission", "Transition", "Label"],
           outputs=["LogLikelihood"], stop_grad_slots=("Label",))
def linear_chain_crf(ctx, emission, transition, label):
    """Negative log-likelihood per sequence, [batch, 1] (the reference's
    output: its sum or mean is the training loss): the forward
    algorithm's log-partition less the gold path's score."""
    assert isinstance(emission, SeqArray)
    e = emission.data.float()                          # [b, t, k]
    b, t, k = e.shape
    lbl = _labels(label, b, t)
    mask = seq_mask(emission.lengths, t)               # [b, t]
    start, stop, trans = _split_transition(transition.float())

    # partition function: the forward algorithm over time, a finished
    # sequence's alpha carried through its padding
    alpha = start[None] + e[:, 0]
    for i in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + e[:, i]
        alpha = torch.where(mask[:, i, None], new, alpha)
    log_z = torch.logsumexp(alpha + stop[None], dim=1)  # [b]

    # gold path score, through one-hot products (fixed-order adjoints)
    oh = _one_hot(lbl, k, e.dtype)                      # [b, t, k]
    maskf = mask.to(e.dtype)
    path = (oh[:, 0] * start[None]).sum(-1) + (oh[:, 0] * e[:, 0]).sum(-1)
    trans_scores = (torch.matmul(oh[:, :-1], trans) * oh[:, 1:]).sum(-1)
    emis_scores = (oh * e).sum(-1)                      # [b, t]
    path = path + (trans_scores * maskf[:, 1:]).sum(dim=1)
    path = path + (emis_scores[:, 1:] * maskf[:, 1:]).sum(dim=1)
    last_idx = (emission.lengths.long() - 1).clamp_min(0)
    last_tag = lbl.gather(1, last_idx[:, None])[:, 0]
    path = path + (_one_hot(last_tag, k, e.dtype) * stop[None]).sum(-1)
    return (log_z - path)[:, None]


@primitive("crf_decoding", inputs=["Emission", "Transition", "Label?"],
           outputs=["ViterbiPath"], no_grad=True)
def crf_decoding(ctx, emission, transition, label):
    """Viterbi decode, int32 [batch, t, 1] tags, zero past each length.
    With Label, the per-step correctness mask instead (the reference's
    behaviour).  Viterbi only adds and takes maxima, in the reference's
    order, and ``torch.argmax`` takes the first of tied maxima as
    ``jnp.argmax`` does, so equal emissions give equal paths."""
    assert isinstance(emission, SeqArray)
    e = emission.data.float()
    b, t, k = e.shape
    mask = seq_mask(emission.lengths, t)
    start, stop, trans = _split_transition(transition.float())

    alpha = start[None] + e[:, 0]
    back = []                                          # [b, k] per step
    for i in range(1, t):
        scores = alpha[:, :, None] + trans[None]       # [b, k_prev, k]
        back.append(torch.argmax(scores, dim=1))
        new = scores.amax(dim=1) + e[:, i]
        alpha = torch.where(mask[:, i, None], new, alpha)
    last = torch.argmax(alpha + stop[None], dim=1)     # [b]

    # backtrace from each sequence's true last position: a tag moves
    # only while position i + 1 lies inside the sequence
    lengths = emission.lengths.long()
    tag, cols = last, [last]
    for i in range(t - 2, -1, -1):
        prev_tag = back[i].gather(1, tag[:, None])[:, 0]
        tag = torch.where((i + 1) < lengths, prev_tag, tag)
        cols.append(tag)
    path = torch.stack(cols[::-1], dim=1) * mask       # [b, t]
    if label is not None:
        correct = (path == _labels(label, b, t)) & mask
        return SeqArray(correct.to(torch.int32)[..., None],
                        emission.lengths)
    return SeqArray(path.to(torch.int32)[..., None], emission.lengths)


def _iob_chunks(tags, lengths, max_len):
    """IOB chunks of a [b, t] batch, tag = 2 * type for B and
    2 * type + 1 for I: (type, chunk id (-1 outside a sequence),
    chunk starts, validity), each [b, t]."""
    pos = torch.arange(max_len, device=tags.device)
    valid = pos[None] < lengths[:, None]
    odd = torch.remainder(tags, 2) == 1
    is_b = ~odd & valid
    typ = torch.div(tags, 2, rounding_mode="floor")
    prev_typ = torch.cat([torch.full_like(typ[:, :1], -1), typ[:, :-1]], 1)
    prev_valid = torch.cat([torch.zeros_like(valid[:, :1]), valid[:, :-1]],
                           1)
    is_i = odd & valid
    # a chunk starts at B, or at an I whose predecessor is absent or of
    # another type
    starts = is_b | (is_i & (~prev_valid | (prev_typ != typ)))
    chunk_id = torch.cumsum(starts.to(torch.int32), dim=1) * valid - 1
    return typ, chunk_id, starts, valid


@primitive("chunk_eval", inputs=["Inference", "Label"],
           outputs=["Precision", "Recall", "F1-Score", "NumInferChunks",
                    "NumLabelChunks", "NumCorrectChunks"], no_grad=True)
def chunk_eval(ctx, inference, label):
    """IOB chunk counts, precision, recall and F1 over the batch.  A
    label chunk counts as correct when every position of it agrees with
    the inference on chunk starts, type and membership.  The reference's
    per-sequence ``vmap`` is one batched computation here, and its
    ``.at[cid].min`` a ``scatter_reduce("amin")``.

    Like the reference, this reads none of the op's ``chunk_scheme``,
    ``num_chunk_types`` or ``excluded_chunk_types`` attributes: the
    scheme is always IOB with every type counted."""
    assert isinstance(inference, SeqArray) and isinstance(label, SeqArray)
    b = inference.data.shape[0]
    inf = inference.data.reshape(b, -1).to(torch.int32)
    lbl = label.data.reshape(b, -1).to(torch.int32)
    t = inf.shape[1]
    lengths = inference.lengths.to(torch.int32)
    ityp, icid, istarts, valid = _iob_chunks(inf, lengths, t)
    ltyp, lcid, lstarts, _ = _iob_chunks(lbl, lengths, t)
    n_inf = istarts.sum(dim=1)
    n_lbl = lstarts.sum(dim=1)
    agree = (istarts == lstarts) & (ityp == ltyp) & \
        ((icid >= 0) == (lcid >= 0))
    ok = torch.where(valid, agree, True)
    # a label chunk is correct iff all its positions agree: a min over
    # the positions of each chunk id
    cid = lcid.clamp(0, t - 1).long()
    seg = torch.ones_like(inf).scatter_reduce(
        1, cid, torch.where(valid, ok.to(torch.int32), 1), "amin",
        include_self=True)
    chunk_ids = torch.arange(t, device=inf.device)
    n_cor = torch.where(chunk_ids[None] < n_lbl[:, None], seg, 0).sum(dim=1)
    ni = n_inf.sum().float()
    nl = n_lbl.sum().float()
    nc = n_cor.sum().float()
    p = nc / ni.clamp_min(1e-6)
    r = nc / nl.clamp_min(1e-6)
    f1 = 2 * p * r / (p + r).clamp_min(1e-6)
    return p, r, f1, ni[None], nl[None], nc[None]
