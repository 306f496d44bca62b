"""Sequence layers — the port of ``paddle_tpu/fluid/layers/sequence.py``,
cut to ``sequence_conv``, ``sequence_pool`` and its first / last step
forms, ``sequence_expand`` and ``sequence_pad``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["sequence_conv", "sequence_pool", "sequence_first_step",
           "sequence_last_step", "sequence_expand", "sequence_pad"]


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, main_program=None, startup_program=None):
    """Context-window projection (``ops/sequence_ops.sequence_conv``):
    a [filter_size * D, num_filters] filter over windows centred on each
    step, then the bias and the activation."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name,
                         main_program=main_program,
                         startup_program=startup_program)
    dtype = input.dtype
    feat = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[filter_size * feat, num_filters],
                                dtype=dtype)
    out = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op("sequence_conv", {"X": input, "Filter": w},
                     {"Out": out},
                     {"context_length": filter_size,
                      "context_start": -((filter_size - 1) // 2),
                      "context_stride": filter_stride})
    out = helper.append_bias_op(out, dim_start=2,
                                bias_shape=[num_filters])
    return helper.append_activation(out)


def sequence_pool(input, pool_type, name=None):
    helper = LayerHelper("sequence_pool", name=name)
    out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("sequence_pool", {"X": input},
                     {"Out": out, "MaxIndex": max_index},
                     {"pooltype": pool_type})
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_expand(x, y, name=None):
    """Each row of ``x`` broadcast across the steps of ``y``'s sequence
    in that row."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op("sequence_expand", {"X": x, "Y": y}, {"Out": out})
    return out


def sequence_pad(x, name=None):
    """A sequence batch as (dense [B, T, ...], mask [B, T]): the bridge
    to dense ops over padded data."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_tmp_variable(x.dtype)
    mask = helper.create_tmp_variable(x.dtype, stop_gradient=True)
    helper.append_op("sequence_pad", {"X": x}, {"Out": out, "Mask": mask})
    return out, mask
