"""Math ops: the projection matmul, the batched ``matmul`` of the
unfused attention, the elementwise family, sum (over SelectedRows
too), scale, mean, the clip and norm ops, ``cos_sim`` and the
reductions (sum, mean, max, min, prod) — the port of
``paddle_tpu/fluid/ops/math_ops.py``.  ``mul``, ``matmul``, ``sum``,
``scale`` and the elementwise ops see a SeqArray input's data and
return a SeqArray, as in the reference.  The matmuls are ``torch.matmul``
(cuBLAS on the card: fp32 with TF32 off, bf16 accumulating in fp32), as
the reference leaves them to XLA.

``match_master_dtype`` is the amp recipe's dtype rule, shared with the
conv ops: a bf16 activation meeting an f32 parameter casts the parameter
down, so the op computes in the activation's dtype."""

from __future__ import annotations

import math

import torch

from ..core.lod import SeqArray
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
# ties split the gradient evenly, as jnp.maximum / jnp.minimum do
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_pow", torch.pow)


@primitive("sum", inputs=["X*"], seq_transparent=True)
def sum_op(ctx, xs):
    """Variadic add — also the fan-in accumulator ``append_backward``
    inserts.  SelectedRows inputs (sparse embedding gradients, reference
    sum_op.cc's SelectedRows path): all sparse gives one SelectedRows of
    the concatenated rows and values (duplicates kept); sparse beside
    dense gives the dense sum with the sparse parts scattered onto it."""
    from ..core.selected_rows import SelectedRows

    sparse = [x for x in xs if isinstance(x, SelectedRows)]
    if sparse:
        dense = [x for x in xs if not isinstance(x, SelectedRows)]
        if not dense:
            if len(sparse) == 1:
                return sparse[0]
            return SelectedRows(torch.cat([s.rows for s in sparse]),
                                torch.cat([s.values for s in sparse]),
                                sparse[0].height)
        # a tensor of its own: the scatters below write it in place
        out = dense[0].clone() if len(dense) == 1 else dense[0] + dense[1]
        for x in dense[2:]:
            out = out + x
        for sr in sparse:
            sr.scatter_add_to(out)
        return out
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@primitive("mean")
def mean(ctx, x):
    """reference mean_op.cc — full reduction to a 0-d scalar."""
    return torch.mean(x)


@primitive("scale", seq_transparent=True)
def scale(ctx, x):
    """scale * x + bias (or (x + bias) * scale), the scalars rounded to
    a bf16 X's dtype first, as the reference's weak typing rounds them."""
    s = weak_scalar(ctx.attr("scale", 1.0), x)
    b = weak_scalar(ctx.attr("bias", 0.0), x)
    if ctx.attr("bias_after_scale", True):
        return x * s + b
    return (x + b) * s


def _fill(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``value`` in ``like``'s dtype, on its device (a
    fill, no host copy)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def clip_values(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip(x, lo, hi): min(max(x, lo), hi), a value at a bound
    taking half the gradient, as jnp.clip's max / min give it."""
    return torch.minimum(torch.maximum(x, _fill(lo, x)), _fill(hi, x))


@primitive("square", seq_transparent=True)
def square(ctx, x):
    return x * x


@primitive("clip", seq_transparent=True)
def clip(ctx, x):
    """reference clip_op.cc."""
    return clip_values(x, ctx.attr("min"), ctx.attr("max"))


@primitive("sign", seq_transparent=True)
def sign(ctx, x):
    return torch.sign(x)


@primitive("clip_by_norm")
def clip_by_norm(ctx, x):
    """reference clip_by_norm_op.cc: X scaled down to ``max_norm`` where
    its L2 norm exceeds it."""
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt((x * x).sum())
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@primitive("norm")
def norm_op(ctx, x):
    return torch.sqrt((x * x).sum())


@primitive("cos_sim", inputs=["X", "Y"], outputs=["Out", "XNorm", "YNorm"])
def cos_sim(ctx, x, y):
    """reference cos_sim_op.cc: row-wise cosine over the last axis, with
    the two norms."""
    xn = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    yn = torch.sqrt((y * y).sum(dim=-1, keepdim=True))
    out = (x * y).sum(dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return out, xn, yn


def _prod(x, dim, keepdim=False):
    """``jnp.prod`` over the dims ``dim``: ``torch.prod`` one dim at a
    time (the last first), whose gradient is right where X holds
    zeros."""
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(name, fn):
    @primitive(name)
    def _op(ctx, x, _fn=fn):
        """reference reduce_op.cc: dim (list or int), keep_dim,
        reduce_all.  A SeqArray input keeps its sequence when only
        feature dims (2 and up) are reduced; ``reduce_sum`` with
        reduce_all sums its valid steps; any other reduce over its time
        axis raises, as in the reference.  max and min share a tie's
        gradient equally, as JAX's do."""
        dim = ctx.attr("dim", [0])
        keep = ctx.attr("keep_dim", False)
        dim = None if ctx.attr("reduce_all", False) else \
            ((dim,) if isinstance(dim, int) else tuple(dim))
        if isinstance(x, SeqArray):
            ndim = x.data.dim()
            if dim is not None and all((d % ndim) >= 2 for d in dim):
                return x.with_data(_fn(x.data, dim=dim, keepdim=keep))
            if name != "reduce_sum" or dim is not None:
                raise NotImplementedError(
                    f"{name} over the time axis of a sequence input is "
                    f"ill-defined in the padded layout; pool the sequence "
                    f"axis first (sequence_pool)")
            m = x.mask(x.data.dtype).reshape(
                tuple(x.data.shape[:2]) + (1,) * (ndim - 2))
            x = x.data * m
        if dim is None:
            dim = tuple(range(x.dim()))
        return _fn(x, dim=dim, keepdim=keep)
    _op.__name__ = name
    return _op


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
_reduce("reduce_max", torch.amax)
_reduce("reduce_min", torch.amin)
_reduce("reduce_prod", _prod)
