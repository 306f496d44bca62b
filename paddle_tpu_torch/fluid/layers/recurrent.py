"""Recurrent layers — the port of ``paddle_tpu/fluid/layers/recurrent.py``,
cut to ``dynamic_lstm``.  ``dynamic_gru`` and ``gru_unit`` are not
ported."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["dynamic_lstm"]


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 main_program=None, startup_program=None):
    """LSTM over a (pre-projected) sequence.  As in the reference
    (layers/nn.py dynamic_lstm), ``size`` is 4x the hidden width and
    equals the input's feature dim; the outputs have width size/4.
    Returns (hidden, cell) sequence variables."""
    if size % 4 != 0:
        raise ValueError("dynamic_lstm size must be 4*hidden (reference "
                         "API)")
    hidden_size = size // 4
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name, main_program=main_program,
                         startup_program=startup_program)
    weight = helper.create_parameter(
        helper.param_attr, shape=[hidden_size, 4 * hidden_size], dtype=dtype)
    bias_size = 7 * hidden_size if use_peepholes else 4 * hidden_size
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[bias_size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=1)
    cell = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op(
        "dynamic_lstm",
        {"Input": input, "Weight": weight, "Bias": bias},
        {"Hidden": hidden, "Cell": cell},
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation})
    return hidden, cell
