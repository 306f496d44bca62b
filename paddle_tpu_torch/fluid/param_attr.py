"""ParamAttr — a copy of ``paddle_tpu/fluid/param_attr.py``.  The
``sharding`` annotation is kept for the wire format; the port runs on one
card, and a layer that would shard raises (``mp_shard``)."""

from __future__ import annotations

from typing import Optional, Sequence

from .initializer import ConstantInitializer, XavierInitializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None,
                 sharding: Optional[Sequence[Optional[str]]] = None,
                 keep_dtype: bool = False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.sharding = sharding
        self.keep_dtype = keep_dtype

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            a = ParamAttr()
            a.trainable = arg
            return a
        # an Initializer instance
        return ParamAttr(initializer=arg)

    def default_initializer(self, is_bias: bool):
        if self.initializer is not None:
            return self.initializer
        return ConstantInitializer(0.0) if is_bias else XavierInitializer()
