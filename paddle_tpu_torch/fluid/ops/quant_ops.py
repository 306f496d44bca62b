"""Post-training int8 quantization ops — the port of
``paddle_tpu/fluid/ops/quant_ops.py``.

``abs_max_scale`` and ``quantize_array`` are the one calibration rule:
the KV pool's quantize-on-write (``cache_ops``), the quantize op and the
program rewrite (``transforms/quantize.py``) all call them, and they
give the JAX package's bytes bit for bit: the scale is ``max|x| / 127``
divided in float32 (a zero channel gets scale 1.0), and the quantized
value is ``clip(round(x / scale), -127, 127)``.  ``jnp.round`` and
``torch.round`` both round half to even, and both sides divide rather
than multiply by a reciprocal (on the card too: the divisor is a tensor),
so the results agree exactly.

Five inference-only ops (``no_grad``: you quantize after training):

* ``quantize`` — float X -> int8 Out + float32 Scale, per tensor or per
  channel (``axis``); ``dequantize`` — int8 X * Scale -> float Out.
* ``quantized_mul`` / ``quantized_matmul`` — ``mul`` / ``matmul`` with an
  int8 Y.  As in the reference, the 2-D product takes the int8 weight
  (``int8_dot``) and the scale multiplies its float32 output; the
  batched ``quantized_matmul`` dequantizes the weight first.
* ``quantized_conv2d`` — ``conv2d`` with an int8 OIHW filter, dequantized
  per output channel before the convolution.

The reference's products read int8 bytes on its MXU; here ``int8_dot``
is a plain float32 product of the int8 weight converted exactly (cuBLAS,
TF32 off, as everywhere in the port): the reference computes it outside
any Pallas kernel, and a product of a float32 (or bfloat16) value and an
int8 value is exact in float32, so the sums differ from the reference's
only in their order.  On the card the int8 weight saves memory, not
time: the conversion reads the int8 bytes and writes float32 ones.  The
bfloat16 input of ``quantized_conv2d`` (which the reference convolves
against a float32 filter) is cast to float32 and the result back.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.registry import primitive
from ..core.types import runtime_dtype, torch_dtype

__all__ = ["QMAX", "abs_max_scale", "quantize_array", "int8_dot"]

QMAX = 127.0

Axis = Union[None, int, Sequence[int]]


def _keep_axes(x_ndim: int, axis) -> Tuple[int, ...]:
    return tuple(sorted(a % x_ndim for a in
                        (axis if isinstance(axis, (tuple, list))
                         else (axis,))))


def _broadcast_scale(scale: torch.Tensor, x_ndim: int, axis) -> torch.Tensor:
    """Reshape a kept-axes scale so it broadcasts against rank-x_ndim."""
    if scale.dim() == 0:
        return scale
    shape = [1] * x_ndim
    for a, s in zip(_keep_axes(x_ndim, axis), scale.shape):
        shape[a] = s
    return scale.reshape(shape)


def abs_max_scale(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    """Symmetric max-abs scale: per-tensor (axis None -> scalar) or one
    scale per position of the kept ``axis`` (an int, or a tuple for
    block scales like the KV pool's per-(lane, slot)).  Zero channels
    get scale 1.0."""
    if axis is None:
        amax = x.abs().amax()
    else:
        keep = _keep_axes(x.dim(), axis)
        reduce_axes = tuple(i for i in range(x.dim()) if i not in keep)
        amax = x.abs().amax(dim=reduce_axes)
    amax = amax.to(torch.float32)
    # divided by a tensor, not the Python scalar: CUDA multiplies by the
    # scalar's reciprocal, an ulp off the CPU's (and the reference's)
    # quotient for some values
    scale = amax / torch.full_like(amax, QMAX)
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def quantize_array(x: torch.Tensor, scale: torch.Tensor,
                   axis: Axis = None) -> torch.Tensor:
    """clip(round(x / scale)) -> int8, scale broadcast at ``axis``."""
    xf = x.to(torch.float32)
    if axis is not None:
        scale = _broadcast_scale(scale, xf.dim(), axis)
    q = torch.round(xf / scale)
    return q.clamp(-QMAX, QMAX).to(torch.int8)


@primitive("quantize", inputs=["X"], outputs=["Out", "Scale"], no_grad=True,
           seq_transparent=True)
def quantize(ctx, x):
    """X (float) -> (int8 Out, float32 Scale).  ``axis`` attr selects the
    per-channel dim (absent -> one per-tensor scalar scale)."""
    axis = ctx.attr("axis", None)
    scale = abs_max_scale(x, axis)
    return quantize_array(x, scale, axis), scale


@primitive("dequantize", inputs=["X", "Scale"], no_grad=True,
           seq_transparent=True)
def dequantize(ctx, x, scale):
    """int8 X * Scale -> float Out (``out_dtype`` attr, default float32;
    float64 narrows to float32, the runtime's rule); ``axis`` must match
    the quantize that produced Scale."""
    axis = ctx.attr("axis", None)
    out_dt = torch_dtype(runtime_dtype(ctx.attr("out_dtype", "float32")))
    xf = x.to(torch.float32)
    if axis is not None:
        scale = _broadcast_scale(scale, xf.dim(), axis)
    return (xf * scale).to(out_dt)


def _flatten_2d(x: torch.Tensor, num_col_dims: int) -> torch.Tensor:
    lead = math.prod(x.shape[:num_col_dims]) if num_col_dims else 1
    return x.reshape(lead, -1)


def int8_dot(x2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """[M, K] float x [K, N] int8 -> [M, N] float32: the one product
    every quantized matmul reduces to (the int8 weight converted
    exactly, the product in float32)."""
    return torch.matmul(x2.to(torch.float32), w2.to(torch.float32))


@primitive("quantized_mul", inputs=["X", "Y", "Scale"], no_grad=True,
           seq_transparent=True)
def quantized_mul(ctx, x, y, scale):
    """``mul`` with an int8 Y and a per-output-channel (or scalar)
    float32 Scale: out = (X2 @ Y2_int8) * scale in float32, cast back to
    X's dtype; ``mul``'s x/y_num_col_dims flattening."""
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    x2 = _flatten_2d(x, xd)
    y2 = _flatten_2d(y, yd)
    out = int8_dot(x2, y2) * scale.to(torch.float32)
    out = out.to(x.dtype)
    return out.reshape(*x.shape[:xd], *y.shape[yd:])


@primitive("quantized_matmul", inputs=["X", "Y", "Scale"], no_grad=True,
           seq_transparent=True)
def quantized_matmul(ctx, x, y, scale):
    """``matmul`` with an int8 Y; Scale is per the result's last dim (the
    output channel after any transpose) or scalar."""
    if ctx.attr("transpose_X", False) and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.dim() >= 2:
        y = y.transpose(-1, -2)
    if x.dim() == 2 and y.dim() == 2:
        out = int8_dot(x, y) * scale.to(torch.float32)
    else:
        # batched: the weight dequantized first, as the reference does
        yf = y.to(torch.float32) * scale.to(torch.float32)
        out = torch.matmul(x.to(torch.float32), yf)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return out.to(x.dtype)


@primitive("quantized_conv2d", inputs=["Input", "Filter", "Scale"],
           outputs=["Output"], no_grad=True)
def quantized_conv2d(ctx, x, w, scale):
    """``conv2d`` with an int8 OIHW Filter and a per-output-channel
    Scale: the filter dequantized to float32, the convolution in float32,
    the result in X's dtype."""
    p = ctx.attr("paddings", [0, 0])
    sc = scale.to(torch.float32)
    if sc.dim() > 0:
        sc = sc.reshape(-1, 1, 1, 1)          # per-OC on OIHW dim 0
    wf = w.to(torch.float32) * sc
    return F.conv2d(x.to(torch.float32), wf,
                    stride=tuple(ctx.attr("strides", [1, 1])),
                    padding=(p[0], p[1]),
                    dilation=tuple(ctx.attr("dilations", [1, 1])),
                    groups=ctx.attr("groups", 1)).to(x.dtype)
