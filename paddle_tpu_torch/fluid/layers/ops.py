"""Thin layer wrappers over registered ops — the port of
``paddle_tpu/fluid/layers/ops.py``, cut to the ops the Transformer and
the LSTM text classifiers build: ``softmax``, the ``elementwise_*``
family, ``mean``, ``scale`` and ``cast``."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["mean", "scale", "cast"]


def _generate_unary(op_type: str):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        helper.append_op(op_type, {"X": x}, {"Out": out}, attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"generated wrapper for the `{op_type}` op"
    return layer


_globals = globals()
for _op in ["softmax"]:
    _globals[_op] = _generate_unary(_op)
    __all__.append(_op)


def _generate_binary(op_type: str):
    def layer(x, y, axis=-1, act=None, name=None, **attrs):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
        attrs = dict(attrs)
        attrs["axis"] = axis
        helper.append_op(op_type, {"X": x, "Y": y}, {"Out": out}, attrs)
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


for _op in ["elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div"]:
    _globals[_op] = _generate_binary(_op)
    __all__.append(_op)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op("mean", {"X": x}, {"Out": out})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    helper.append_op("scale", {"X": x}, {"Out": out},
                     {"scale": float(scale), "bias": float(bias),
                      "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def cast(x, dtype):
    """X as ``dtype``: the amp recipe's one cast at the activation
    source."""
    helper = LayerHelper("cast")
    out = helper.create_tmp_variable(dtype, lod_level=x.lod_level)
    helper.append_op("cast", {"X": x}, {"Out": out},
                     {"in_dtype": x.dtype, "out_dtype": dtype})
    return out
