"""Math ops: the projection matmul, the batched ``matmul`` of the
unfused attention, the elementwise family, sum, scale, mean and
reductions — the port of ``paddle_tpu/fluid/ops/math_ops.py``, cut to
what the Transformer, the LSTM text classifiers, the book's first two
chapters, their backward and the optimizers emit.  ``mul``, ``matmul``,
``sum`` and ``elementwise_*`` see a SeqArray input's data and return a
SeqArray, as in the reference.  The matmuls are ``torch.matmul``
(cuBLAS on the card: fp32 with TF32 off, bf16 accumulating in fp32), as
the reference leaves them to XLA.

``match_master_dtype`` is the amp recipe's dtype rule, shared with the
conv ops: a bf16 activation meeting an f32 parameter casts the parameter
down, so the op computes in the activation's dtype."""

from __future__ import annotations

import math

import torch

from ..core.registry import primitive


def _flatten_2d(x, num_col_dims: int):
    """Leading num_col_dims dims into rows, the rest into cols (reference
    mul_op.cc:30)."""
    lead = math.prod(x.shape[:num_col_dims]) if num_col_dims else 1
    return x.reshape(lead, -1)


def weak_scalar(c: float, t: torch.Tensor) -> float:
    """A Python scalar as the reference combines it with ``t``: JAX's
    weak typing rounds it to ``t``'s dtype first (0.9 beside a bf16
    tensor is 0.8984375), where PyTorch would compute with it in
    float32."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(c, dtype=t.dtype))
    return c


def match_master_dtype(x, y):
    """Y in X's dtype when both are floating and differ (a bf16
    activation X over an f32 master parameter Y), else Y as it is
    (reference math_ops.py match_master_dtype).  Autograd casts Y's
    gradient back, so the master gradient stays f32."""
    if x.is_floating_point() and y.is_floating_point() \
            and x.dtype != y.dtype:
        return y.to(x.dtype)
    return y


@primitive("mul", inputs=["X", "Y"], seq_transparent=True)
def mul(ctx, x, y):
    """Projection matmul (reference mul_op.cc): X and Y flattened to 2-D
    per x_num_col_dims / y_num_col_dims, multiplied in X's dtype
    (accumulating in fp32), leading dims restored."""
    xd = ctx.attr("x_num_col_dims", 1)
    yd = ctx.attr("y_num_col_dims", 1)
    out = torch.matmul(_flatten_2d(x, xd),
                       _flatten_2d(match_master_dtype(x, y), yd))
    return out.reshape(*x.shape[:xd], *y.shape[yd:])


@primitive("matmul", inputs=["X", "Y"], seq_transparent=True)
def matmul(ctx, x, y):
    """Batched matmul with optional transposes of the last two axes and
    a scale ``alpha`` (reference matmul_op.cc), summed in fp32 and
    returned in X's dtype; 1-D operands follow numpy's vector rules."""
    if ctx.attr("transpose_X", False) and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.dim() >= 2:
        y = y.transpose(-1, -2)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0 and x.dtype != torch.float32:
        # scale the fp32 sums before they round to X's dtype
        return (torch.matmul(x.float(), y.float()) * alpha).to(x.dtype)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return out.to(x.dtype)


def _bcast_to_x(x, y, axis: int):
    """Reference broadcast rule (elementwise_op_function.h): Y's dims
    align with X's starting at ``axis`` (default: trailing alignment)."""
    if x.shape == y.shape or axis in (-1, None):
        return y
    pad_right = x.dim() - axis - y.dim()
    return y.reshape((1,) * axis + tuple(y.shape) + (1,) * pad_right)


def _elementwise(name, fn):
    @primitive(name, inputs=["X", "Y"], seq_transparent=True)
    def _op(ctx, x, y, _fn=fn):
        # a bf16 activation plus an f32 bias stays bf16
        y = _bcast_to_x(x, match_master_dtype(x, y), ctx.attr("axis", -1))
        return _fn(x, y)
    _op.__name__ = name
    return _op


_elementwise("elementwise_add", lambda x, y: x + y)
_elementwise("elementwise_sub", lambda x, y: x - y)
_elementwise("elementwise_mul", lambda x, y: x * y)
_elementwise("elementwise_div", lambda x, y: x / y)


@primitive("sum", inputs=["X*"], seq_transparent=True)
def sum_op(ctx, xs):
    """Variadic add — also the fan-in accumulator ``append_backward``
    inserts."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@primitive("mean")
def mean(ctx, x):
    """reference mean_op.cc — full reduction to a 0-d scalar."""
    return torch.mean(x)


@primitive("scale")
def scale(ctx, x):
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return x * s + b
    return (x + b) * s


def _reduce(name, fn):
    @primitive(name)
    def _op(ctx, x, _fn=fn):
        """reference reduce_op.cc: dim (list or int), keep_dim,
        reduce_all."""
        dim = ctx.attr("dim", [0])
        if ctx.attr("reduce_all", False):
            dim = tuple(range(x.dim()))
        elif isinstance(dim, int):
            dim = (dim,)
        return _fn(x, dim=tuple(dim), keepdim=ctx.attr("keep_dim", False))
    _op.__name__ = name
    return _op


_reduce("reduce_sum", torch.sum)
