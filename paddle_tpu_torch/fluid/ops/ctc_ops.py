"""CTC ops — the port of ``paddle_tpu/fluid/ops/ctc_ops.py``: the
``warpctc`` loss, ``edit_distance`` and ``ctc_align``.

* ``warpctc`` is the reference's log-space forward algorithm over the
  blank-interleaved labels, one time step at a time over the whole
  batch, with ``NEG = -1e30`` for an impossible state (not -inf:
  ``logaddexp`` of two of them stays finite, so no NaN reaches the
  gradient).  Its gradient is autograd's through that loop, as the
  reference's is JAX's through its scan (no Pallas kernel backs it).
* ``edit_distance`` is the Levenshtein table of each pair.  The
  reference fills it cell by cell (a scan of rows, each a scan of
  cells); here it is filled one anti-diagonal at a time for the whole
  batch, ``h + r`` steps for an h-step hypothesis and an r-step
  reference.  The table holds small integers in float32, so both orders
  give the same values exactly.
* ``ctc_align`` collapses greedy paths (repeats merged, blanks dropped)
  by a cumulative sum and a scatter.

Sequences are SeqArrays ([b, T, ...] padded data + lengths), as in the
reference.
"""

from __future__ import annotations

import torch

from ..core.lod import SeqArray
from ..core.registry import primitive

NEG = -1e30


def _squeeze_tokens(a):
    """SeqArray int sequences carry [b, T, 1]; the ops work on [b, T]."""
    if a.dim() == 3 and a.shape[-1] == 1:
        return a.squeeze(-1)
    return a


def _ctc_nll(logp, t_len, labels, l_len, blank):
    """The negative log-likelihood [b] of ``labels`` [b, L] (blank-free,
    valid up to ``l_len``) under CTC from the log-probabilities ``logp``
    [b, T, C] (valid up to ``t_len``): the alpha recursion over the
    extended labels [blank, l1, blank, l2, ..., blank] of
    ``_ctc_loss_single`` in the reference, for the whole batch at once.
    Past a sequence's end its alphas are frozen; an empty label's
    likelihood is the all-blank path's, ``alpha[0]``."""
    b, t_max, _ = logp.shape
    l_max = labels.shape[1]
    s = 2 * l_max + 1
    dev = logp.device
    s_idx = torch.arange(s, device=dev)
    lab_idx = torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                          0, max(l_max - 1, 0))
    lab = (labels[:, lab_idx] if l_max
           else torch.full((b, s), blank, dtype=torch.int64, device=dev))
    ext = torch.where(s_idx % 2 == 0, blank, lab)                # [b, S]
    ext_prev2 = torch.cat([torch.full((b, 2), blank, dtype=ext.dtype,
                                      device=dev), ext[:, :-2]], dim=1)
    # a skip into a non-blank position whose label differs from the
    # one two back (the CTC transition rule)
    allow_skip = (s_idx >= 2) & (ext != blank) & (ext != ext_prev2)
    # lp[b, t, s] = logp[b, t, ext[b, s]], as a product with the one-hot
    # ext: exact (one product by 1, the rest by 0), and its gradient a
    # product too, where a gather's would add the blank's many entries
    # with atomics on the card
    onehot = (ext[..., None] == torch.arange(logp.shape[-1], device=dev)
              ).to(logp.dtype)                                  # [b, S, C]
    lp = torch.bmm(logp, onehot.transpose(1, 2))                # [b, T, S]
    neg1 = torch.full((b, 1), NEG, dtype=logp.dtype, device=dev)
    neg2 = torch.full((b, 2), NEG, dtype=logp.dtype, device=dev)
    alpha = torch.cat([lp[:, 0, :2], torch.full(
        (b, s - 2), NEG, dtype=logp.dtype, device=dev)], dim=1) \
        if s > 1 else lp[:, 0, :1]
    live = torch.arange(t_max, device=dev)[:, None] < t_len[None, :]
    steps = live[..., None].unbind(0)
    for t in range(1, t_max):
        a1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        a2 = torch.cat([neg2, alpha[:, :-2]], dim=1)
        new = torch.logaddexp(alpha, a1)
        new = torch.where(allow_skip, torch.logaddexp(new, a2), new)
        alpha = torch.where(steps[t], new + lp[:, t], alpha)
    end = (2 * l_len).long()[:, None]
    last = torch.logaddexp(alpha.gather(1, end),
                           alpha.gather(1, torch.clamp(end - 1, min=0)))
    ll = torch.where(l_len[:, None] > 0, last, alpha[:, :1])
    return -ll[:, 0]


@primitive("warpctc", inputs=["Logits", "Label"], outputs=["Loss"],
           stop_grad_slots=("Label",))
def warpctc(ctx, logits, label):
    """CTC loss (reference warpctc_op.cc) of raw Logits (SeqArray [b, T,
    C]; class ``blank`` is the blank, 0 <= blank < C) against blank-free
    Label sequences -> Loss [b, 1] float32.  ``norm_by_times`` scales
    the gradient by 1 / T and leaves the value (warpctc_grad_op): value
    (L - L / T) + L / T, gradient grad(L) / T, as the reference
    computes it."""
    if not (isinstance(logits, SeqArray) and isinstance(label, SeqArray)):
        raise TypeError("warpctc expects SeqArray logits and labels")
    logp = torch.log_softmax(logits.data.float(), dim=-1)
    t_len = logits.lengths.to(torch.int32)
    loss = _ctc_nll(logp, t_len,
                    _squeeze_tokens(label.data.to(torch.int32)).long(),
                    label.lengths.to(torch.int32), ctx.attr("blank", 0))
    if ctx.attr("norm_by_times", False):
        scaled = loss / torch.clamp(t_len.float(), min=1.0)
        loss = (loss - scaled).detach() + scaled
    return loss[:, None]


def levenshtein(hyp, h_len, ref, r_len):
    """Levenshtein distances [b] float32 of ``hyp`` [b, H] (valid up to
    ``h_len``) from ``ref`` [b, R] (up to ``r_len``).  The table D[i][j]
    (hypothesis prefix i, reference prefix j) is filled by
    anti-diagonals k = i + j; ``diag`` holds D[i][k - i] indexed by i:
    D[i][j] = min(D[i-1][j] + 1, D[i][j-1] + 1, D[i-1][j-1] + (hyp[i-1]
    != ref[j-1])), with D[i][0] = i and D[0][j] = j.  Returns
    D[h_len][r_len], which lies on diagonal h_len + r_len at i = h_len."""
    b, h_max = hyp.shape
    r_max = ref.shape[1]
    dev = hyp.device
    i_idx = torch.arange(h_max + 1, device=dev)
    big = torch.full((b, 1), float(h_max + r_max + 1), device=dev)
    prev2 = None
    prev = torch.where(i_idx == 0, 0.0, float(h_max + r_max + 1)) \
        .expand(b, h_max + 1)                        # diagonal 0
    diags = [prev]
    hyp_i = torch.cat([hyp[:, :1], hyp], dim=1)      # hyp[i - 1] at i
    for k in range(1, h_max + r_max + 1):
        j = k - i_idx                                 # [H + 1]
        ref_j = ref[:, torch.clamp(j - 1, 0, max(r_max - 1, 0))] \
            if r_max else hyp_i
        up = torch.cat([big, prev[:, :-1]], dim=1) + 1.0     # D[i-1][j]
        left = prev + 1.0                                    # D[i][j-1]
        diag = (torch.cat([big, prev2[:, :-1]], dim=1) if prev2 is not None
                else big.expand(b, h_max + 1))               # D[i-1][j-1]
        sub = diag + (hyp_i != ref_j).float()
        cur = torch.minimum(torch.minimum(up, left), sub)
        cur = torch.where(j == 0, i_idx.float(), cur)        # D[i][0] = i
        cur = torch.where(i_idx == 0, float(k), cur)         # D[0][k] = k
        cur = torch.where((j < 0) | (j > r_max), big, cur)
        prev2, prev = prev, cur
        diags.append(cur)
    table = torch.stack(diags, dim=1)                # [b, H + R + 1, H + 1]
    h_len, r_len = h_len.long(), r_len.long()
    at = (h_len + r_len)[:, None, None].expand(b, 1, h_max + 1)
    return table.gather(1, at)[:, 0].gather(1, h_len[:, None])[:, 0]


@primitive("edit_distance", inputs=["Hyps", "Refs"], outputs=["Out"],
           no_grad=True)
def edit_distance(ctx, hyps, refs):
    """Levenshtein distance per sequence pair (reference
    edit_distance_op.cc) -> [b, 1] float32; ``normalized`` divides by
    the reference's length (at least 1)."""
    if not (isinstance(hyps, SeqArray) and isinstance(refs, SeqArray)):
        raise TypeError("edit_distance expects SeqArray inputs")
    rl = refs.lengths.to(torch.int32)
    dist = levenshtein(_squeeze_tokens(hyps.data.to(torch.int32)),
                       hyps.lengths.to(torch.int32),
                       _squeeze_tokens(refs.data.to(torch.int32)), rl)
    if ctx.attr("normalized", False):
        dist = dist / torch.clamp(rl.float(), min=1.0)
    return dist[:, None]


@primitive("ctc_align", inputs=["Input"], outputs=["Output"], no_grad=True)
def ctc_align(ctx, x):
    """Collapse greedy CTC paths (reference ctc_align): adjacent repeats
    merged and blanks dropped, the kept tokens left-aligned in a [b, T]
    int32 SeqArray with the new lengths.  A dropped slot scatters into
    column T of a T + 1 wide buffer, which is cut off (the reference's
    ``mode="drop"``)."""
    if not isinstance(x, SeqArray):
        raise TypeError("ctc_align expects a SeqArray input")
    blank = ctx.attr("blank", 0)
    ids = _squeeze_tokens(x.data.to(torch.int32))
    b, t_max = ids.shape
    in_range = (torch.arange(t_max, device=ids.device)[None, :]
                < x.lengths.to(torch.int32)[:, None])
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = (ids != blank) & (ids != prev) & in_range
    pos = torch.where(keep, torch.cumsum(keep, dim=1) - 1, t_max)
    out = torch.zeros(b, t_max + 1, dtype=ids.dtype, device=ids.device)
    out.scatter_(1, pos, ids)
    return SeqArray(out[:, :t_max],
                    keep.sum(dim=1).to(x.lengths.dtype))
