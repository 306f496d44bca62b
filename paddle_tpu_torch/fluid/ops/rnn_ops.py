"""Recurrent ops — the port of ``paddle_tpu/fluid/ops/rnn_ops.py``.
``dynamic_lstm``'s forward time loop is the fused kernel of
``kernels/lstm.py`` (one launch for all steps on the card), its gradient
the hand-written backward of that module's autograd Function, so the
lowering's generic grad takes the vjp through it.  ``dynamic_gru``,
``lstm_unit`` and ``gru_unit`` are the reference's step functions in
plain PyTorch: ``dynamic_gru`` loops over the padded time axis in
``_scan_seq`` as the reference scans it, and its gradient is autograd's
through that loop (the reference's is JAX's through its scan; no
Pallas kernel backs either).

Layout (the reference's): Input is the pre-projected sequence,
[batch, time, 4*size] for the LSTM (Weight [size, 4*size], gate blocks
c~, i, f, o; Bias [4*size], or [7*size] with use_peepholes) and
[batch, time, 3*size] for the GRU (Weight [size, 3*size]: the
update / reset recurrence [size, 2*size] beside the candidate's
[size, size]; Bias [3*size]).
"""

from __future__ import annotations

import torch

from ...kernels import lstm as _lstm
from ..core.lod import SeqArray
from ..core.registry import primitive

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "relu": torch.relu, "identity": lambda x: x}


def _scan_seq(x: SeqArray, step, init_carry, reverse: bool):
    """Run ``step(carry, x_t) -> (new carry, out_t)`` over the padded time
    axis of ``x`` and stack the outputs [batch, time, ...], as the
    reference's ``lax.scan`` does: the carry is merged ``m * new +
    (1 - m) * old`` with the step's mask, so it holds through padding,
    and every output is multiplied by the mask.  ``reverse`` flips the
    whole padded axis (the padded steps come first, the carry at its
    initial value through them) and flips the outputs back."""
    data = x.data.transpose(0, 1)                    # [T, B, ...]
    mask = x.mask(data.dtype).transpose(0, 1)[..., None]   # [T, B, 1]
    if reverse:
        data, mask = data.flip(0), mask.flip(0)
    # one view a step, whose gradients autograd stacks once (indexing
    # step by step would add a full-size gradient a step)
    carry, outs = init_carry, []
    for xt, mt, keep in zip(data.unbind(0), mask.unbind(0),
                            (1 - mask).unbind(0)):
        new, out = step(carry, xt)
        carry = tuple(mt * n + keep * o for n, o in zip(new, carry))
        outs.append(out * mt)
    outs = torch.stack(outs)
    if reverse:
        outs = outs.flip(0)
    return outs.transpose(0, 1)


def _gru_step(h, x_ur, x_c, w_ur, w_c, b_ur, b_c, gate_act, cand_act):
    """One GRU step (reference ``gru_kernel.h``): the update and reset
    gates, the candidate over the reset hidden state, and ``h' = (1 -
    u) * h + u * c`` (``gru_kernel.h:62``).  The products accumulate in
    float32 and are cast back (``preferred_element_type``).  -> (u, r,
    r * h, c, h')."""
    ur = gate_act(x_ur + torch.matmul(h, w_ur).to(h.dtype) + b_ur)
    u, r = ur.chunk(2, dim=-1)
    rh = r * h
    c = cand_act(x_c + torch.matmul(rh, w_c).to(h.dtype) + b_c)
    return u, r, rh, c, (1 - u) * h + u * c


@primitive("dynamic_lstm", inputs=["Input", "Weight", "Bias", "H0?", "C0?"],
           outputs=["Hidden", "Cell"])
def dynamic_lstm(ctx, x, w, b, h0, c0):
    """reference lstm_op.cc — the full hidden and cell sequences."""
    if not isinstance(x, SeqArray):
        raise TypeError("dynamic_lstm expects a sequence input")
    h, c = _lstm.dynamic_lstm(
        x.data, w, b, x.lengths, h0, c0,
        use_peepholes=ctx.attr("use_peepholes", True),
        is_reverse=ctx.attr("is_reverse", False),
        gate_activation=ctx.attr("gate_activation", "sigmoid"),
        cell_activation=ctx.attr("cell_activation", "tanh"),
        candidate_activation=ctx.attr("candidate_activation", "tanh"))
    return x.with_data(h), x.with_data(c)


@primitive("dynamic_gru", inputs=["Input", "Weight", "Bias?", "H0?"],
           outputs=["Hidden"])
def dynamic_gru(ctx, x, w, b, h0):
    """reference gru_op.cc: the hidden sequence of a GRU over the
    pre-projected Input [b, t, 3*size]; the weight slices and bias are
    cut once, outside the time loop."""
    if not isinstance(x, SeqArray):
        raise TypeError("dynamic_gru expects a sequence input")
    size = w.shape[0]
    gate_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    cand_act = _ACTS[ctx.attr("activation", "tanh")]
    bias = (b.reshape(-1) if b is not None
            else torch.zeros(3 * size, dtype=x.data.dtype,
                             device=x.data.device))
    w_ur, w_c = w[:, :2 * size], w[:, 2 * size:]
    b_ur, b_c = bias[:2 * size], bias[2 * size:]
    h_init = h0 if h0 is not None else torch.zeros(
        x.data.shape[0], size, dtype=x.data.dtype, device=x.data.device)

    def step(carry, xt):
        h_new = _gru_step(carry[0], xt[..., :2 * size], xt[..., 2 * size:],
                          w_ur, w_c, b_ur, b_c, gate_act, cand_act)[-1]
        return (h_new,), h_new

    return x.with_data(_scan_seq(x, step, (h_init,),
                                 ctx.attr("is_reverse", False)))


@primitive("lstm_unit", inputs=["X", "C_prev"], outputs=["C", "H"])
def lstm_unit(ctx, x, c_prev):
    """One LSTM step (reference lstm_unit_op.cc): X [b, 4*size] holds
    the pre-projected gates in the slot order i, f, o, g
    (lstm_unit_op.h:63-66); ``forget_bias`` is added to f."""
    gi, gf, go, gg = x.chunk(4, dim=-1)
    i = torch.sigmoid(gi)
    f = torch.sigmoid(gf + ctx.attr("forget_bias", 0.0))
    c = f * c_prev + i * torch.tanh(gg)
    return c, torch.sigmoid(go) * torch.tanh(c)


@primitive("gru_unit", inputs=["Input", "HiddenPrev", "Weight", "Bias?"],
           outputs=["Gate", "ResetHiddenPrev", "Hidden"])
def gru_unit(ctx, x, h_prev, w, b):
    """One GRU step (reference gru_unit_op.cc) -> (Gate [u, r, c],
    ResetHiddenPrev r * h_prev, Hidden)."""
    size = h_prev.shape[-1]
    bias = (b.reshape(-1) if b is not None
            else torch.zeros(3 * size, dtype=x.dtype, device=x.device))
    u, r, rh, c, h = _gru_step(
        h_prev, x[..., :2 * size], x[..., 2 * size:], w[:, :2 * size],
        w[:, 2 * size:], bias[:2 * size], bias[2 * size:],
        _ACTS[ctx.attr("gate_activation", "sigmoid")],
        _ACTS[ctx.attr("activation", "tanh")])
    return torch.cat([u, r, c], dim=-1), rh, h
