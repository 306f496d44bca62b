"""Detection ops — the port of ``paddle_tpu/fluid/ops/detection_ops.py``:
SSD's priors, matching, loss and inference head, and the box metrics.

Static shapes throughout, as in the reference, and no host sync, so a
step that runs them is captured like any other: ``prior_box`` is a
function of the feature map's and the image's shapes, computed on the
device; the greedy bipartite matching runs a fixed number of rounds,
each taking every batch row's global argmax at once; NMS walks a fixed
number of candidates per class and keeps a fixed ``keep_top_k`` rows,
-1 padded.  Ranks break ties as the reference's do: ``jax.lax.top_k``
and ``jnp.argsort`` put equal values in ascending index order, so the
port sorts stably (``torch.sort(stable=True)``), and ``argmax`` takes
the first maximum on both.  The box arithmetic is the reference's
formulas op for op, so IoUs, matches and NMS rows are the reference's
bit for bit on the same inputs.
"""

from __future__ import annotations

import torch

from ..core.lod import SeqArray
from ..core.registry import primitive
from .beam_ops import stable_top_k

NEG = -1e30


def fills(values, device, dtype=torch.float32) -> torch.Tensor:
    """A vector of Python numbers made on ``device`` by fills (a
    host-to-device copy would be a host sync inside a captured step)."""
    if not len(values):
        return torch.empty(0, dtype=dtype, device=device)
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


@primitive("prior_box", inputs=["Input", "Image"],
           outputs=["Boxes", "Variances"], no_grad=True)
def prior_box(ctx, feat, image):
    """reference prior_box_op.cc: per feature-map cell, a box for every
    (min_size, aspect ratio) pair and, where there is one, the
    min_size's max_size (side sqrt(min * max)), normalized [xmin, ymin,
    xmax, ymax] -> Boxes [fh, fw, n_priors, 4] and the variances
    broadcast to that shape.  The aspect ratios are 1, then each
    attribute ratio not within 1e-6 of one already taken, followed by
    its inverse under ``flip``."""
    min_sizes = [float(s) for s in ctx.attr("min_sizes")]
    max_sizes = [float(s) for s in ctx.attr("max_sizes", [])]
    ratios = [float(r) for r in ctx.attr("aspect_ratios", [1.0])]
    flip = ctx.attr("flip", False)
    variances = [float(v) for v in ctx.attr("variances",
                                            [0.1, 0.1, 0.2, 0.2])]
    offset = ctx.attr("offset", 0.5)
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_h = ctx.attr("step_h", 0.0) or ih / fh
    step_w = ctx.attr("step_w", 0.0) or iw / fw

    ars = [1.0]
    for r in ratios:
        if all(abs(r - a) > 1e-6 for a in ars):
            ars.append(r)
            if flip:
                ars.append(1.0 / r)
    whs = []
    for k, ms in enumerate(min_sizes):
        for ar in ars:
            whs.append((ms * (ar ** 0.5), ms / (ar ** 0.5)))
        if k < len(max_sizes):
            s = (ms * max_sizes[k]) ** 0.5
            whs.append((s, s))
    n = len(whs)

    dev = feat.device
    cy = (torch.arange(fh, dtype=torch.float32, device=dev) + offset) \
        * step_h
    cx = (torch.arange(fw, dtype=torch.float32, device=dev) + offset) \
        * step_w
    cxg = cx[None, :, None].expand(fh, fw, n)
    cyg = cy[:, None, None].expand(fh, fw, n)
    bw = fills([w for w, _ in whs], dev) / 2.0
    bh = fills([h for _, h in whs], dev) / 2.0
    # divided by device tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, an ulp off the CPU's quotient
    iw_t, ih_t = fills([iw, ih], dev).unbind(0)
    boxes = torch.stack([(cxg - bw) / iw_t, (cyg - bh) / ih_t,
                         (cxg + bw) / iw_t, (cyg + bh) / ih_t], dim=-1)
    if ctx.attr("clip", False):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = fills(variances, dev).expand(boxes.shape).contiguous()
    return boxes, var


def greedy_match(d, rounds: int, live):
    """Greedy bipartite matching on similarities ``d`` [B, R, C]: each
    of ``rounds`` rounds takes every batch row's global argmax (the
    first maximum in row-major order), and where ``live(best)`` holds
    matches its column to its row and retires both (set to -1e30) ->
    (row of each column or -1 [B, C] int32, its similarity [B, C]
    float32)."""
    b, r, c = d.shape
    rows = torch.arange(r, device=d.device)[None, :, None]
    cols = torch.arange(c, device=d.device)[None, None, :]
    match = torch.full((b, c), -1, dtype=torch.int32, device=d.device)
    dist = torch.zeros(b, c, dtype=torch.float32, device=d.device)
    for _ in range(rounds):
        flat_d = d.reshape(b, -1)
        flat = flat_d.argmax(dim=1)
        best = flat_d.gather(1, flat[:, None])[:, 0]
        row, col = flat // c, flat % c
        hit = live(best)[:, None] & (cols[0] == col[:, None])     # [B, C]
        match = torch.where(hit, row[:, None].to(torch.int32), match)
        dist = torch.where(hit, best[:, None].float(), dist)
        retire = live(best)[:, None, None] & (
            (rows == row[:, None, None]) | (cols == col[:, None, None]))
        d = torch.where(retire, NEG, d)
    return match, dist


@primitive("bipartite_match", inputs=["DistMat"],
           outputs=["ColToRowMatchIndices", "ColToRowMatchDist"],
           no_grad=True)
def bipartite_match(ctx, dist):
    """reference bipartite_match_op.cc: greedy bipartite matching on a
    [rows, cols] similarity matrix (``greedy_match``, min(rows, cols)
    rounds, any similarity above -1e30 / 2 claims); with
    ``match_type='per_prediction'`` an unmatched column whose best row
    reaches ``dist_threshold`` takes that row.  Per column: the matched
    row (-1: none) and its similarity."""
    rows, cols = dist.shape
    match, mdist = greedy_match(dist.float()[None], min(rows, cols),
                                lambda best: best > NEG / 2)
    match, mdist = match[0], mdist[0]
    if ctx.attr("match_type", "bipartite") == "per_prediction":
        col_best = dist.max(dim=0).values
        col_best_row = dist.argmax(dim=0).to(torch.int32)
        fill = (match < 0) & (col_best >= ctx.attr("dist_threshold", 0.5))
        match = torch.where(fill, col_best_row, match)
        mdist = torch.where(fill, col_best.float(), mdist)
    return match, mdist


def pairwise_iou(a, b):
    """IoU of every box of ``a`` [..., n, 4] with every box of ``b``
    [..., m, 4] (xmin, ymin, xmax, ymax) -> [..., n, m]: the reference's
    ``_iou`` / ``_pairwise_iou``, op for op."""
    ix1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    aa = (torch.clamp(a[..., 2] - a[..., 0], min=0)
          * torch.clamp(a[..., 3] - a[..., 1], min=0))
    ba = (torch.clamp(b[..., 2] - b[..., 0], min=0)
          * torch.clamp(b[..., 3] - b[..., 1], min=0))
    return inter / torch.clamp(aa[..., :, None] + ba[..., None, :] - inter,
                               min=1e-10)


def nms_rows(bboxes, scores, score_thresh, iou_thresh, per_class_k,
             keep_k):
    """Greedy per-class NMS (the reference's ``_nms_core``) over boxes
    [B, n, 4] and scores [B, c, n] -> rows [B, keep, 6] (class, score,
    x1, y1, x2, y2), -1 rows where fewer pass.  Per class, the
    min(per_class_k, n) best boxes in score order (ties: lower index
    first) are walked in turn; a box is kept where its score reaches
    ``score_thresh`` and no box kept before it overlaps it by more than
    ``iou_thresh``.  Then the keep_k best kept (class, box) pairs over
    all classes, class-major on ties."""
    b, n_cls, n_box = scores.shape
    k = min(per_class_k, n_box)
    order_score, order_idx = stable_top_k(scores, k)             # [B, c, k]
    cand = torch.gather(bboxes[:, None].expand(b, n_cls, n_box, 4), 2,
                        order_idx[..., None].expand(b, n_cls, k, 4))
    over = pairwise_iou(cand, cand) > iou_thresh                 # [B,c,k,k]
    ok = order_score >= score_thresh
    kept = torch.zeros(b, n_cls, k, dtype=torch.bool, device=scores.device)
    for i in range(k):
        kept[..., i] = ok[..., i] & ~(kept & over[..., i, :]).any(dim=-1)
    kept_scores = torch.where(kept, order_score, -1.0).reshape(b, -1)
    cls = torch.arange(n_cls, dtype=torch.float32, device=scores.device)
    cls = cls[None, :, None].expand(b, n_cls, k).reshape(b, -1)
    top_scores, top_pos = stable_top_k(kept_scores,
                                       min(keep_k, kept_scores.shape[1]))
    box_idx = order_idx.reshape(b, -1).gather(1, top_pos)
    out = torch.cat([cls.gather(1, top_pos)[..., None], top_scores[..., None],
                     bboxes.gather(1, box_idx[..., None].expand(
                         *box_idx.shape, 4))], dim=-1)
    return torch.where(top_scores[..., None] >= score_thresh, out, -1.0)


@primitive("multiclass_nms", inputs=["BBoxes", "Scores"],
           outputs=["Out"], no_grad=True)
def multiclass_nms(ctx, bboxes, scores):
    """Per-class greedy NMS (``nms_rows``) over [n, 4] boxes with [c, n]
    scores -> [keep_top_k, 6] rows."""
    return nms_rows(bboxes[None], scores[None],
                    ctx.attr("score_threshold", 0.01),
                    ctx.attr("nms_threshold", 0.45),
                    ctx.attr("nms_top_k", 16),
                    ctx.attr("keep_top_k", 16))[0]


def _centers(boxes):
    """(cx, cy, w, h) of [..., 4] boxes, widths at least 1e-8."""
    return ((boxes[..., 0] + boxes[..., 2]) / 2,
            (boxes[..., 1] + boxes[..., 3]) / 2,
            torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-8),
            torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-8))


def detection_inputs(loc, conf, prior, prior_var, background_id=0):
    """What ``detection_output`` hands its NMS: Location [B, P, 4]
    decoded against the priors (the inverse of ``ssd_loss``'s variance
    encoding) -> boxes [B, P, 4], and Confidence [B, P, C] softmaxed
    with the background class masked to -1 -> scores [B, C, P]."""
    prior = prior.reshape(-1, 4).float()
    var = prior_var.reshape(-1, 4).float()
    pcx, pcy, pw, ph = _centers(prior)
    l = loc.float()
    cx = l[..., 0] * var[:, 0] * pw + pcx
    cy = l[..., 1] * var[:, 1] * ph + pcy
    w = pw * torch.exp(l[..., 2] * var[:, 2])
    h = ph * torch.exp(l[..., 3] * var[:, 3])
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    scores = torch.softmax(conf.float(), dim=-1).transpose(1, 2)  # [B,C,P]
    live = (torch.arange(scores.shape[1], device=scores.device)
            != background_id)
    return boxes, torch.where(live[None, :, None], scores, -1.0)


@primitive("detection_output",
           inputs=["Location", "Confidence", "PriorBox", "PriorVar"],
           outputs=["Out"], no_grad=True)
def detection_output(ctx, loc, conf, prior, prior_var):
    """SSD's inference head (the reference's DetectionOutputLayer):
    ``detection_inputs``, then ``nms_rows`` -> [B, keep_top_k, 6] rows
    (class, score, x1, y1, x2, y2), -1 padded."""
    boxes, scores = detection_inputs(loc, conf, prior, prior_var,
                                     int(ctx.attr("background_id", 0)))
    return nms_rows(boxes, scores, ctx.attr("confidence_threshold", 0.01),
                    ctx.attr("nms_threshold", 0.45),
                    ctx.attr("nms_top_k", 400), ctx.attr("keep_top_k", 200))


@primitive("iou_similarity", inputs=["X", "Y"], outputs=["Out"],
           no_grad=True)
def iou_similarity(ctx, x, y):
    """reference iou_similarity_op.cc: the IoU of every box of X [N, 4]
    with every box of Y [M, 4] -> [N, M], 0 where the union is empty."""
    x, y = x.float(), y.float()

    def area(b):
        return (torch.clamp(b[:, 2] - b[:, 0], min=0.0)
                * torch.clamp(b[:, 3] - b[:, 1], min=0.0))

    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(x)[:, None] + area(y)[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


@primitive("positive_negative_pair",
           inputs=["Score", "Label", "QueryID", "AccumulatePositivePair?",
                   "AccumulateNegativePair?", "AccumulateNeutralPair?",
                   "Weight?"],
           outputs=["PositivePair", "NegativePair", "NeutralPair"],
           no_grad=True)
def positive_negative_pair(ctx, score, label, query, acc_pos, acc_neg,
                           acc_neu, weight):
    """reference positive_negative_pair_op.h: over every pair of items
    of one query with different labels, weight (w_i + w_j) / 2; a pair
    ordered as its labels adds to PositivePair, any other to
    NegativePair, and a pair of equal scores to NeutralPair too (the
    reference's fall-through) -> three [1] sums, plus the accumulators
    given."""
    column = ctx.attr("column", 0)
    col = column if column >= 0 else score.shape[1] + column
    s = score[:, col].float()
    l = label.reshape(-1).float()
    q = query.reshape(-1)
    w = weight.reshape(-1).float() if weight is not None \
        else torch.ones_like(s)
    i, j = torch.triu_indices(s.shape[0], s.shape[0], offset=1,
                              device=s.device)
    valid = (q[i] == q[j]) & (l[i] != l[j])
    pw = torch.where(valid, (w[i] + w[j]) * 0.5, 0.0)
    ds, dl = s[i] - s[j], l[i] - l[j]
    neu = torch.where(ds == 0, pw, 0.0).sum()
    pos = torch.where(ds * dl > 0, pw, 0.0).sum()
    neg = pw.sum() - pos
    if acc_pos is not None:
        pos = pos + acc_pos.reshape(())
    if acc_neg is not None:
        neg = neg + acc_neg.reshape(())
    if acc_neu is not None:
        neu = neu + acc_neu.reshape(())
    return pos.reshape(1), neg.reshape(1), neu.reshape(1)


def ssd_match(gt_box, g_len, prior, threshold):
    """SSD's matching of ground-truth boxes [B, G, 4] (``g_len`` live
    per row) to priors [P, 4] -> [B, P] int32, the matched gt of each
    prior or -1.  First each live gt claims its best prior in a greedy
    bipartite round (min(G, P) rounds; a claim needs IoU > 0, so a gt
    with no overlapping prior trains only the confidence head), then an
    unclaimed prior takes its best gt where their IoU reaches
    ``threshold``; dead gts have IoU -1."""
    g = gt_box.shape[1]
    gmask = torch.arange(g, device=gt_box.device)[None, :] < g_len[:, None]
    iou = pairwise_iou(gt_box, prior[None])                      # [B, G, P]
    iou = torch.where(gmask[..., None], iou, -1.0)
    match, _ = greedy_match(iou, min(g, prior.shape[0]),
                            lambda best: best > 0)
    best_iou = iou.max(dim=1).values
    best_gt = iou.argmax(dim=1).to(torch.int32)
    return torch.where((match < 0) & (best_iou >= threshold), best_gt,
                       match)


@primitive("ssd_loss",
           inputs=["Location", "Confidence", "GTBox", "GTLabel",
                   "PriorBox", "PriorVar"],
           stop_grad_slots=("GTBox", "GTLabel", "PriorBox", "PriorVar"))
def ssd_loss(ctx, loc, conf, gt_box, gt_label, prior, prior_var):
    """SSD's MultiBox loss (the reference's MultiBoxLossLayer and fluid
    ssd_loss) -> Out [B, 1]: smooth-L1 between Location [B, P, 4] and
    the matched gts' variance encodings on the positive priors
    (``ssd_match``), plus the softmax cross-entropy of Confidence [B, P,
    C] against the matched gt's label (the background elsewhere) over
    the positives and the ``neg_pos_ratio`` x positives hardest
    negatives (ranked by a double stable argsort of their
    cross-entropy), over the positive count (at least 1).  GTBox [B, G,
    4] and GTLabel [B, G, 1] are padded sequences (their lengths mask
    G); PriorBox / PriorVar come from ``prior_box``."""
    thresh = float(ctx.attr("overlap_threshold", 0.5))
    neg_ratio = float(ctx.attr("neg_pos_ratio", 3.0))
    bg = int(ctx.attr("background_label", 0))
    prior = prior.reshape(-1, 4)
    var = prior_var.reshape(-1, 4)
    gb = gt_box.data if isinstance(gt_box, SeqArray) else gt_box
    gl = gt_label.data if isinstance(gt_label, SeqArray) else gt_label
    g_len = (gt_box.lengths if isinstance(gt_box, SeqArray)
             else torch.full((gb.shape[0],), gb.shape[1], dtype=torch.int32,
                             device=gb.device))
    gl = gl.reshape(gl.shape[0], -1).to(torch.int32)             # [B, G]
    b, p, _ = loc.shape
    g = gb.shape[1]

    match = ssd_match(gb, g_len, prior, thresh)                  # [B, P]
    pos = match >= 0
    npos = pos.sum(dim=1)
    midx = torch.clamp(match, 0, g - 1).long()
    mb = gb.gather(1, midx[..., None].expand(b, p, 4))           # [B, P, 4]
    pcx, pcy, pw, ph = _centers(prior)
    gcx, gcy, gw, gh = _centers(mb)
    tgt = torch.stack([(gcx - pcx) / pw / var[:, 0],
                       (gcy - pcy) / ph / var[:, 1],
                       torch.log(gw / pw) / var[:, 2],
                       torch.log(gh / ph) / var[:, 3]], dim=-1)
    ad = (loc - tgt.detach()).abs()
    sl1 = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(dim=-1)
    loc_loss = torch.where(pos, sl1, 0.0).sum(dim=1)

    lbl = torch.where(pos, gl.gather(1, midx), bg)               # [B, P]
    ce = torch.logsumexp(conf, dim=-1) \
        - conf.gather(-1, lbl[..., None].long())[..., 0]
    # hard negatives: the neg_ratio * npos largest cross-entropies
    neg_ce = torch.where(pos, -1.0, ce)
    order = torch.argsort(-neg_ce, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    n_neg = torch.minimum((neg_ratio * npos).to(torch.int32),
                          (~pos).sum(dim=1).to(torch.int32))
    neg_keep = ~pos & (rank < n_neg[:, None])
    conf_loss = torch.where(pos | neg_keep, ce, 0.0).sum(dim=1)
    denom = torch.clamp(npos.float(), min=1.0)
    return ((loc_loss + conf_loss) / denom).reshape(b, 1)
