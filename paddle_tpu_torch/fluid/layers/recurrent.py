"""Recurrent layers — the port of ``paddle_tpu/fluid/layers/recurrent.py``:
``dynamic_lstm``, ``dynamic_gru`` and ``gru_unit``."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["dynamic_lstm", "dynamic_gru", "gru_unit"]


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


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32", name=None):
    """GRU over a (pre-projected) sequence whose feature width is
    3*size (reference layers/nn.py dynamic_gru); the hidden sequence has
    width size."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op("dynamic_gru",
                     {"Input": input, "Weight": weight, "Bias": bias},
                     {"Hidden": hidden},
                     {"is_reverse": is_reverse,
                      "gate_activation": gate_activation,
                      "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step (reference layers/nn.py gru_unit), for StaticRNN
    bodies.  Returns (hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[3 * size], dtype=dtype,
                                   is_bias=True)
    gate = helper.create_tmp_variable(dtype)
    reset_hidden_prev = helper.create_tmp_variable(dtype)
    updated_hidden = helper.create_tmp_variable(dtype)
    helper.append_op("gru_unit",
                     {"Input": input, "HiddenPrev": hidden,
                      "Weight": weight, "Bias": bias},
                     {"Gate": gate, "ResetHiddenPrev": reset_hidden_prev,
                      "Hidden": updated_hidden},
                     {"activation": activation,
                      "gate_activation": gate_activation})
    return updated_hidden, reset_hidden_prev, gate
