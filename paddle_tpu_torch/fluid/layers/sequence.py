"""Sequence layers — the port of ``paddle_tpu/fluid/layers/sequence.py``,
cut to ``sequence_pool`` and its first / last step forms."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_first_step", "sequence_last_step"]


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
