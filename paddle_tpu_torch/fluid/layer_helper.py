"""LayerHelper — the port of ``paddle_tpu/fluid/layer_helper.py``: the
shared machinery every layer function uses to create parameters (with
startup-program init ops), temporaries, bias ops and activations.  The
names it generates are the reference's, so programs serialize alike."""

from __future__ import annotations

from typing import Optional

from . import unique_name
from .framework import (Parameter, Variable, default_main_program,
                        default_startup_program)
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # -- inputs -------------------------------------------------------------
    def input(self, name="input"):
        inputs = self.kwargs.get(name)
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != 1:
                raise ValueError(f"{self.layer_type} expects one input")
            return inputs[0]
        return inputs

    def multiple_input(self, name="input"):
        inputs = self.kwargs.get(name)
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return [inputs]

    @property
    def param_attr(self) -> ParamAttr:
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        ba = self.kwargs.get("bias_attr")
        if ba is False:
            return None
        return ParamAttr.to_attr(ba)

    def input_dtype(self, name="input") -> str:
        dtype = None
        for v in self.multiple_input(name):
            d = v.dtype
            if dtype is None:
                dtype = d
            elif d != dtype:
                raise ValueError(f"{self.layer_type}: mixed input dtypes")
        return dtype

    # -- variable creation ---------------------------------------------------
    def create_parameter(self, attr: ParamAttr, shape, dtype,
                         is_bias: bool = False, default_initializer=None,
                         suffix: Optional[str] = None) -> Parameter:
        if str(dtype) in ("bfloat16", "float16") and \
                not getattr(attr, "keep_dtype", False):
            # master-weight rule: parameters live in f32 whatever the
            # activation dtype (the reference's amp recipe)
            dtype = "float32"
        suffix = suffix or ("b" if is_bias else "w")
        name = attr.name or unique_name.generate(f"{self.name}.{suffix}")
        init = (attr.initializer or default_initializer
                or attr.default_initializer(is_bias))
        main_block = self.main_program.global_block()
        if name in main_block.vars:
            # named parameter sharing (the reference's shared_w pattern in
            # book/test_word2vec.py): reuse, don't re-create/re-init
            existing = main_block.vars[name]
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"variable {name!r} already exists and is not a "
                    f"Parameter; cannot share it via ParamAttr(name=...)")
            if list(existing.shape) != list(shape) or \
                    existing.dtype != str(dtype):
                raise ValueError(
                    f"shared parameter {name!r} mismatch: existing "
                    f"{existing.dtype}{list(existing.shape)} vs requested "
                    f"{dtype}{list(shape)}")
            return existing
        param = main_block.create_parameter(
            name=name, shape=list(shape), dtype=dtype,
            trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            sharding=attr.sharding)
        # mirror into the startup program and emit its init op there
        sb = self.startup_program.global_block()
        sp = sb.create_parameter(
            name=name, shape=list(shape), dtype=dtype,
            trainable=attr.trainable, sharding=attr.sharding)
        init(sp, sb)
        return param

    def create_tmp_variable(self, dtype, lod_level: int = 0,
                            stop_gradient: bool = False) -> Variable:
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"), dtype=dtype,
            lod_level=lod_level, stop_gradient=stop_gradient)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None, stop_gradient=True) -> Variable:
        return self.main_program.global_block().create_var(
            name=name or unique_name.generate(f"{self.name}.global"),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=list(var.shape or []),
                           dtype=var.dtype, persistable=True)
        initializer(sv, sb)

    # -- op helpers ----------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None, **kw):
        return self.block.append_op(type, inputs, outputs, attrs, **kw)

    def append_bias_op(self, input_var: Variable, dim_start: int = 1,
                       bias_shape=None) -> Variable:
        bias_attr = self.bias_attr
        if bias_attr is None:
            return input_var
        size = bias_shape or list(input_var.shape[dim_start:])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_tmp_variable(input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op("elementwise_add", {"X": input_var, "Y": b},
                       {"Out": out}, {"axis": dim_start})
        return out

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, dict):
            act_type = act["type"]
            attrs = {k: v for k, v in act.items() if k != "type"}
        else:
            act_type, attrs = act, {}
        out = self.create_tmp_variable(input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(act_type, {"X": input_var}, {"Out": out}, attrs)
        return out
