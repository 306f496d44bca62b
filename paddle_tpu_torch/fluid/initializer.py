"""Parameter initializers — the port of ``paddle_tpu/fluid/initializer.py``,
cut to what the Transformer and Adam create: constant, uniform (Xavier's
default) and normal.  Each appends an init op to the startup program;
the random ops draw from a seeded CPU ``torch.Generator``
(``ops/tensor_ops.py``), so one seed gives the same weights on every
device."""

from __future__ import annotations

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier",
           "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "XavierInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        """Reference initializer.py _compute_fans: FC weights are [in, out];
        conv filters are [out_c, in_c, *receptive]."""
        shape = var.shape
        if len(shape) < 2:
            return (int(np.prod(shape)) or 1,) * 2
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": var},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": var},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": float(self.low), "max": float(self.high)})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": var},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale)})


class XavierInitializer(Initializer):
    """Glorot — reference initializer.py XavierInitializer."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            UniformInitializer(-limit, limit)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fi + fo)))
            NormalInitializer(0.0, std)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
