"""Softmax, losses and metrics — the port of
``paddle_tpu/fluid/ops/loss_ops.py``, whole.

A float attr beside a bf16 input is rounded to bf16 first
(``math_ops.weak_scalar``), as the reference's weak typing rounds it.

The ranking metrics hold on every device to the bit: ``auc`` and
``precision_recall`` count in exact integers and sum their class means
in class order; ``lambda_rank_cost`` ranks with stable sorts (as
``jnp.argsort``), reads its discounts from a table computed with
correctly rounded float64 operations only, takes ``log(1 + e^-d)`` from
``softplus_exact`` (the same: no library ``exp`` or ``log``, whose last
bits differ between the card and the CPU) and sums each query's pairs in
a fixed pairwise order (``tree_sum``).  They stay within float32
rounding of the reference, whose XLA ``exp`` and ``log`` and summation
orders are its own."""

from __future__ import annotations

import math

import torch

from ..core.lod import NestedSeqArray, SeqArray
from ..core.registry import primitive
from .math_ops import weak_scalar


@primitive("softmax", seq_transparent=True)
def softmax(ctx, x):
    return torch.softmax(x, dim=-1)


@primitive("log_softmax", seq_transparent=True)
def log_softmax(ctx, x):
    return torch.log_softmax(x, dim=-1)


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


@primitive("sigmoid_cross_entropy_with_logits", inputs=["X", "Label"],
           stop_grad_slots=("Label",), seq_transparent=True)
def sigmoid_ce_logits(ctx, x, label):
    """Binary cross-entropy on logits, elementwise, in the reference's
    stable form max(x, 0) - x * label + log1p(exp(-|x|))."""
    return (torch.clamp(x, min=0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))


@primitive("squared_l2_norm")
def squared_l2_norm(ctx, x):
    return (x * x).sum()


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


@primitive("cross_entropy_with_selfnorm", inputs=["X", "Label"],
           stop_grad_slots=("Label",))
def cross_entropy_with_selfnorm(ctx, x, label):
    """Self-normalized cross-entropy (reference CostLayer.cpp:113):
    X holds unnormalized positive scores; per row -log x[label] + log Z
    + alpha log(Z)^2 with Z the row's sum, clipped below at 1e-8 as the
    reference clips it."""
    alpha = weak_scalar(ctx.attr("softmax_selfnorm_alpha", 0.1), x)
    eps = weak_scalar(1e-8, x)
    z = x.sum(dim=-1, keepdim=True)
    logz = torch.log(torch.clamp(z, min=eps))
    picked = torch.gather(x, 1, label.reshape(x.shape[0], 1).long())
    return (-torch.log(torch.clamp(picked, min=eps)) + logz
            + alpha * logz * logz)


def _data(v):
    return v.data if isinstance(v, (SeqArray, NestedSeqArray)) else v


def _pick(t, idx):
    """t[b, idx[b, ...]] over the flattened trailing axes of t."""
    flat = t.reshape(t.shape[0], -1)
    return torch.gather(flat, 1, idx.reshape(t.shape[0], -1)).reshape(
        idx.shape)


@primitive("cross_entropy_over_beam", inputs=["Scores*", "Ids*", "Gold*"],
           outputs=["Out"], stop_grad_slots=("Ids", "Gold"))
def cross_entropy_over_beam(ctx, scores, ids, gold):
    """Learning-to-search beam cost (reference
    CrossEntropyOverBeam.cpp; the reference's ``one_seq`` vmapped over
    the batch, here computed for the whole batch at once).  Expansion i
    gives Scores [B, R_i, C_i] (step 0 may be [B, C_0]), Ids [B, R_i,
    K_i] selected candidate ids, -1 padded, and Gold [B] the gold
    candidate.  The gold is tracked through the expansions; the first
    expansion it falls off ends the valid ones, and the cost is -log of
    the gold path's softmax weight over every live path of that
    expansion, a fallen-off gold joining as one extra path.  Dead slots
    enter the softmax at -1e30.  Gradients reach Scores through the
    score gathers."""
    E = len(scores)
    assert E and len(ids) == E and len(gold) == E, \
        "cross_entropy_over_beam: Scores/Ids/Gold must align per expansion"
    sc, idl, gl = [], [], []
    for i in range(E):
        sd = _data(scores[i])
        if sd.dim() > 2 and sd.shape[-1] == 1:
            sd = sd[..., 0]
        if sd.dim() == 2:
            sd = sd[:, None, :]
        sc.append(sd.float())
        dd = _data(ids[i])
        if dd.dim() == 2:
            dd = dd[:, None, :]
        idl.append(dd.long())
        gd = _data(gold[i])
        gl.append(gd.reshape(gd.shape[0]).long())
    B = sc[0].shape[0]
    if sc[0].device.type == "meta":
        return torch.empty((B, 1), dtype=torch.float32, device="meta")
    dev = sc[0].device
    neg = -1e30

    # the gold's row and column through the expansions
    gr = torch.zeros(B, dtype=torch.long, device=dev)
    found_l, grow_l, gcol_l = [], [], []
    for i in range(E):
        R, K = idl[i].shape[1:]
        row_ids = torch.gather(idl[i], 1, gr[:, None, None].expand(
            B, 1, K))[:, 0]
        eq = row_ids == gl[i][:, None]
        fnd = eq.any(dim=1)
        gc = torch.where(fnd, eq.to(torch.int32).argmax(dim=1), 0)
        grow_l.append(gr)
        found_l.append(fnd)
        gcol_l.append(gc)
        live = idl[i].reshape(B, -1) >= 0
        before = torch.arange(R * K, device=dev)[None, :] \
            < (gr * K + gc)[:, None]
        gr = torch.where(fnd, (live & before).sum(dim=1), gr)
    miss = ~torch.stack(found_l, dim=1)
    f = torch.where(miss.any(dim=1), miss.to(torch.int32).argmax(dim=1),
                    E - 1)

    costs = []
    for f0 in range(E):
        R, K = idl[f0].shape[1:]
        C = sc[f0].shape[2]
        flat = idl[f0].reshape(B, -1)
        alive = flat >= 0
        row = (torch.arange(R * K, device=dev) // K)[None, :].expand(
            B, R * K)
        total = _pick(sc[f0], row * C + flat.clamp(0, C - 1))
        for i in range(f0 - 1, -1, -1):
            Ri, Ki = idl[i].shape[1:]
            Ci = sc[i].shape[2]
            flat_i = idl[i].reshape(B, -1)
            live_i = flat_i >= 0
            nrows = idl[i + 1].shape[1]
            compact = torch.cumsum(live_i.long(), dim=1) - 1
            tgt = torch.where(live_i & (compact < nrows), compact, nrows)
            # slot nrows takes the dead slots' writes and is never read
            pos_of = torch.zeros(B, nrows + 1, dtype=torch.long,
                                 device=dev).scatter_(
                1, tgt, torch.arange(Ri * Ki, device=dev).expand(B, -1))
            s_flat = torch.gather(pos_of, 1, row.clamp(0, nrows))
            ci = torch.gather(flat_i, 1, s_flat).clamp(0, Ci - 1)
            total = total + _pick(sc[i], (s_flat // Ki) * Ci + ci)
            row = s_flat // Ki
        gscore = torch.zeros(B, device=dev)
        for i in range(f0 + 1):
            Ci = sc[i].shape[2]
            gscore = gscore + _pick(sc[i], grow_l[i] * Ci
                                    + gl[i].clamp(0, Ci - 1))
        goldflat = grow_l[f0] * K + gcol_l[f0]
        extra = ~found_l[f0]
        logits = torch.cat([torch.where(alive, total, neg),
                            torch.where(extra, gscore, neg)[:, None]],
                           dim=1)
        lse = torch.logsumexp(logits, dim=1)
        gold_logit = torch.where(found_l[f0], _pick(total, goldflat),
                                 gscore)
        costs.append(lse - gold_logit)
    cost = torch.gather(torch.stack(costs, dim=1), 1, f[:, None])
    return cost.reshape(-1, 1)


@primitive("smooth_l1_loss", inputs=["X", "Y"], outputs=["Diff", "Out"])
def smooth_l1_loss(ctx, x, y):
    """reference smooth_l1_loss_op.cc: per element 0.5 (sigma d)^2 where
    |d| < 1 / sigma^2, else |d| - 0.5 / sigma^2, summed over the last
    axis; Diff = X - Y."""
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    a = torch.abs(d)
    loss = torch.where(a < weak_scalar(1.0 / s2, x),
                       weak_scalar(0.5 * s2, x) * d * d,
                       a - weak_scalar(0.5 / s2, x))
    return d, loss.sum(dim=-1, keepdim=True)


@primitive("huber_loss", inputs=["X", "Y"], outputs=["Residual", "Out"])
def huber_loss(ctx, x, y):
    """reference huber_loss_op.cc: r = Y - X; 0.5 r^2 where |r| <=
    delta, else delta (|r| - 0.5 delta)."""
    delta = ctx.attr("delta", 1.0)
    r = y - x
    a = torch.abs(r)
    loss = torch.where(a <= weak_scalar(delta, x),
                       weak_scalar(0.5, x) * r * r,
                       weak_scalar(delta, x)
                       * (a - weak_scalar(0.5 * delta, x)))
    return r, loss


def relu_even(t):
    """max(t, 0) whose gradient at a tie is half, as ``jnp.maximum``'s."""
    return torch.maximum(t, torch.zeros((), dtype=t.dtype, device=t.device))


@primitive("hinge_loss", inputs=["Logits", "Labels"],
           stop_grad_slots=("Labels",))
def hinge_loss(ctx, logits, labels):
    """reference hinge_loss_op.cc: max(0, 1 - (2 label - 1) logit)."""
    return relu_even(1.0 - (2.0 * labels - 1.0) * logits)


@primitive("squared_l2_distance", inputs=["X", "Y"],
           outputs=["sub_result", "Out"])
def squared_l2_distance(ctx, x, y):
    """reference squared_l2_distance_op.cc: sub_result = X - Y (Y's rows
    flattened and broadcast when the shapes differ), Out its row sums of
    squares [B, 1]."""
    d = x - y.reshape(y.shape[0], -1) if x.shape != y.shape else x - y
    return d, (d * d).sum(dim=-1, keepdim=True)


def _exact_sum(t) -> torch.Tensor:
    """The sum of integer-valued terms in float64 (exact below 2^53, so
    in any order), rounded once to float32."""
    return t.to(torch.float64).sum().to(torch.float32)


@primitive("auc", inputs=["Out", "Indices", "Label"], outputs=["AUC"],
           no_grad=True)
def auc(ctx, out, indices, label):
    """reference auc_op.cc: rank-based AUC of the positive-class score
    (column 1 of a two-column Out, else Out itself) against 0/1 labels:
    (sum of the positives' ranks - P (P + 1) / 2) / max(P N, 1).  Ranks
    come from one stable sort, so tied scores rank by position and are
    not averaged, as in the reference; ``curve`` and ``num_thresholds``
    are not read (ROADMAP C9).  The rank sum is an exact integer sum,
    then the reference's float32 arithmetic."""
    score = out[:, 1] if out.dim() == 2 and out.shape[1] == 2 \
        else out.reshape(-1)
    lbl = label.reshape(-1).to(torch.float32)
    n = score.shape[0]
    order = torch.argsort(score, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=score.device)) + 1
    npos = _exact_sum(lbl)
    nneg = n - npos
    pos_rank_sum = _exact_sum(ranks * lbl.to(torch.float64))
    return (pos_rank_sum - npos * (npos + 1) / 2.0) / torch.clamp(
        npos * nneg, min=1.0)


def class_order_mean(v) -> torch.Tensor:
    """The mean of a float32 vector as the reference's ``jnp.mean``
    of a short vector computes it: summed in index order, times the
    float32 reciprocal of its length; the same bits on every device."""
    acc = v[0]
    for i in range(1, v.shape[0]):
        acc = acc + v[i]
    return acc * float(torch.tensor(1.0 / v.shape[0], dtype=torch.float32))


@primitive("precision_recall", inputs=["MaxProbs", "Indices", "Labels"],
           outputs=["BatchMetrics"], no_grad=True)
def precision_recall(ctx, probs, indices, labels):
    """reference precision_recall_op.cc as the reference reduces it: the
    batch's confusion counts over ``class_number`` classes, then the
    macro means of per-class precision, recall and F1 -> [3].  Weights
    and states are not read (ROADMAP C9).  Counts are exact; the means
    are summed in class order."""
    ncls = int(ctx.attr("class_number"))
    pred = indices.reshape(-1).long()
    lbl = labels.reshape(-1).long()
    cm = torch.zeros(ncls * ncls, dtype=torch.int64, device=pred.device)
    cm = cm.index_add(0, lbl * ncls + pred, torch.ones_like(lbl))
    # counts below 2^24: every float32 sum of them is exact
    cm = cm.reshape(ncls, ncls).to(torch.float32)
    tp = torch.diagonal(cm)
    prec = tp / torch.clamp(cm.sum(dim=0), min=1.0)
    rec = tp / torch.clamp(cm.sum(dim=1), min=1.0)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-6)
    return torch.stack([class_order_mean(prec), class_order_mean(rec),
                        class_order_mean(f1)])


# -- the same bits on every device ------------------------------------------

_LN2_HI = 6.93147180369123816490e-01      # ln 2 split as fdlibm splits it
_LN2_LO = 1.90821492927058770002e-10
_INV_LN2 = 1.44269504088896338700e+00


def tree_sum(x) -> torch.Tensor:
    """The sum over the last axis in a fixed pairwise order (zero-padded
    to a power of two, then halved): elementwise adds only, so the same
    bits on the card and on the CPU."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _exp_neg64(a):
    """exp(-a) for float64 a in [0, 700], from correctly rounded + - *
    and floor only: a = n ln2 - r, e^r by its Taylor series to r^12
    (|r| <= ln2 / 2: error below 1e-14), times 2^-n built in the
    exponent bits."""
    n = torch.floor(a * _INV_LN2 + 0.5)
    r = (n * _LN2_HI - a) + n * _LN2_LO
    p = torch.full_like(r, 1.0 / math.factorial(12))
    for k in range(11, -1, -1):
        p = p * r + 1.0 / math.factorial(k)
    scale = ((1023 - n).to(torch.int64) << 52).view(torch.float64)
    return p * scale


def _log1p64(e):
    """log(1 + e) for float64 e in [0, 1] by 2 atanh(e / (2 + e)) to
    u^31 (u <= 1/3: error below 1e-15); + - * / only."""
    u = e / (2.0 + e)
    w = u * u
    s = torch.full_like(w, 1.0 / 31)
    for k in range(14, -1, -1):
        s = s * w + 1.0 / (2 * k + 1)
    return 2.0 * u * s


def _log64(v):
    """log(v) for float64 v > 0: v = m 2^k with m in [1, 2) (frexp),
    log m as log1p(m - 1) with u = (m - 1) / (m + 1) <= 1/3."""
    m, k = torch.frexp(v)                  # v = m 2^k, m in [0.5, 1)
    return _log1p64(2.0 * m - 1.0) + (k - 1).to(torch.float64) * (
        _LN2_HI + _LN2_LO)


class _SoftplusExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        d = x.to(torch.float64)
        a = torch.clamp(torch.abs(d), max=700.0)
        out = torch.clamp(d, min=0.0) + _log1p64(_exp_neg64(a))
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.sigmoid(x)


def softplus_exact(x):
    """log(1 + e^x) (``jnp.logaddexp(0, x)``) within float32 rounding,
    the same bits on every device: computed in float64 from correctly
    rounded operations only, then rounded.  Its gradient is
    sigmoid(x)."""
    return _SoftplusExact.apply(x)


def dcg_discounts(t: int, device) -> torch.Tensor:
    """1 / log2(2 + r) for ranks r in [0, t), float32, computed in
    float64 by ``_log64`` (the same table on every device)."""
    r = torch.arange(t, dtype=torch.float64, device=device)
    return ((_LN2_HI + _LN2_LO) / _log64(2.0 + r)).to(torch.float32)


@primitive("lambda_rank_cost", inputs=["Score", "Label"],
           stop_grad_slots=("Label",))
def lambda_rank_cost(ctx, score, label):
    """LambdaRank cost per query (reference CostLayer.cpp LambdaCost, as
    the reference's LambdaLoss form): over pairs i, j of one query with
    l_i > l_j, |dNDCG_ij| log(1 + e^-(s_i - s_j)); dNDCG_ij, the NDCG
    change of swapping i and j in the current ranking truncated at
    ``ndcg_num`` and normalized by the ideal DCG, carries no gradient.
    Score and Label are sequences [B, T, 1] -> [B, 1].  The ranks come
    from stable sorts, as ``jnp.argsort``'s (graded labels and saturated
    scores tie often); the cost is the same bits on every device (see
    the module's docstring)."""
    assert isinstance(score, SeqArray), "lambda_rank_cost expects sequences"
    ndcg_num = int(ctx.attr("ndcg_num", 5))
    s = score.data.reshape(score.data.shape[0], -1)          # [B, T]
    lab = label.data if isinstance(label, SeqArray) else label
    lv = lab.reshape(lab.shape[0], -1).to(torch.float32)     # [B, T]
    b, t = s.shape
    if s.device.type == "meta":
        return torch.empty((b, 1), dtype=s.dtype, device="meta")
    dev = s.device
    pos = torch.arange(t, device=dev)
    live = pos[None, :] < score.lengths.to(dev)[:, None]
    mask = live.to(torch.float32)
    neg = -1e30

    with torch.no_grad():
        s_rank = torch.where(live, s.detach(), neg)
        order = torch.argsort(-s_rank, dim=1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            1, order, pos[None, :].expand(b, t))             # 0 = best
        table = dcg_discounts(t, dev)
        gain = torch.exp2(lv) - 1.0
        disc = torch.where(ranks < ndcg_num, table[ranks], 0.0) * mask
        l_sorted = torch.sort(torch.where(live, lv, neg), dim=1,
                              descending=True).values
        real = l_sorted > neg / 2
        ideal_disc = torch.where((pos[None, :] < ndcg_num) & real,
                                 table[None, :], 0.0)
        max_dcg = tree_sum((torch.exp2(torch.where(real, l_sorted, 0.0))
                            - 1.0) * ideal_disc)[:, None]  # [B, 1]
        safe_max = torch.where(max_dcg > 0, max_dcg, 1.0)
        dg = gain[:, :, None] - gain[:, None, :]
        dd = disc[:, :, None] - disc[:, None, :]
        dndcg = torch.abs(dg * dd) / safe_max[:, :, None]
        pair_live = ((lv[:, :, None] > lv[:, None, :])
                     & (live[:, :, None] & live[:, None, :])
                     & (max_dcg[:, :, None] > 0))
    diff = s[:, :, None] - s[:, None, :]
    pair_cost = torch.where(pair_live, dndcg * softplus_exact(-diff), 0.0)
    return tree_sum(pair_cost.reshape(b, t * t)).reshape(b, 1)
