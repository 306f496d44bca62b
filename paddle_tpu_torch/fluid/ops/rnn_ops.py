"""Recurrent ops — the port of ``paddle_tpu/fluid/ops/rnn_ops.py``, cut
to ``dynamic_lstm``.  Its forward time loop is the fused kernel of
``kernels/lstm.py`` (one launch for all steps on the card), its gradient
the hand-written backward of that module's autograd Function, so the
lowering's generic grad takes the vjp through it.  ``dynamic_gru``,
``lstm_unit`` and ``gru_unit`` are not ported.

Layout (the reference's): Input is the pre-projected sequence
[batch, time, 4*size]; Weight the recurrence [size, 4*size] with gate
blocks c~, i, f, o; Bias [4*size], or [7*size] with use_peepholes.
"""

from __future__ import annotations

from ...kernels import lstm as _lstm
from ..core.lod import SeqArray
from ..core.registry import primitive


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
