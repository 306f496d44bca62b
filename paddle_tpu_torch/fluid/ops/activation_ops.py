"""Activation ops — the port of ``paddle_tpu/fluid/ops/activation_ops.py``,
every op of it.  Each is the reference's ``jax.nn`` / ``jnp`` formula in
PyTorch, written so that autograd gives the reference's gradient at the
points where two conventions differ: ``abs`` and ``leaky_relu`` take the
positive branch's slope at 0 (as ``jnp.abs`` and ``jax.nn.leaky_relu``
do), a value at a bound of a clip takes half the gradient (``relu6``,
``hard_sigmoid``, ``brelu``, as ``jnp.clip``'s max and min do), ``gelu``
is the tanh form (``jax.nn.gelu``'s default) and ``softplus`` /
``logsigmoid`` are ``logaddexp`` forms (no threshold).  A float attr
beside a bf16 X is rounded to bf16 first (``weak_scalar``), as JAX's
weak typing rounds it in the reference."""

from __future__ import annotations

import math

import torch

from ..core.registry import primitive
from .math_ops import clip_values, weak_scalar


def _act(name, fn):
    @primitive(name, seq_transparent=True)
    def _op(ctx, x, _fn=fn):
        return _fn(ctx, x)
    _op.__name__ = name
    return _op


def _abs(x):
    """|x| with slope 1 at 0, as jnp.abs differentiates."""
    return torch.where(x >= 0, x, -x)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _elu(x, alpha):
    pos = x > 0
    # the unused branch sees 0, so its gradient stays finite
    return torch.where(pos, x, alpha * torch.expm1(
        torch.where(pos, torch.zeros_like(x), x)))


def _gelu(x):
    """jax.nn.gelu(x) (approximate=True): the tanh form."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def _softshrink(x, lam):
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, torch.zeros_like(x)))


_act("sigmoid", lambda c, x: torch.sigmoid(x))
_act("logsigmoid", lambda c, x: -_softplus(-x))
_act("exp", lambda c, x: torch.exp(x))
_act("relu", lambda c, x: torch.relu(x))
_act("relu6", lambda c, x: clip_values(x, 0.0, c.attr("threshold", 6.0)))
_act("tanh", lambda c, x: torch.tanh(x))
_act("tanh_shrink", lambda c, x: x - torch.tanh(x))
_act("sqrt", lambda c, x: torch.sqrt(x))
_act("rsqrt", lambda c, x: torch.rsqrt(x))
_act("abs", lambda c, x: _abs(x))
_act("ceil", lambda c, x: torch.ceil(x))
_act("floor", lambda c, x: torch.floor(x))
_act("round", lambda c, x: torch.round(x))
_act("reciprocal", lambda c, x: 1.0 / x)
_act("log", lambda c, x: torch.log(x))
_act("softplus", lambda c, x: _softplus(x))
_act("softsign", lambda c, x: x / (_abs(x) + 1))
_act("softshrink", lambda c, x: _softshrink(x, c.attr("lambda", 0.5)))
_act("hard_shrink", lambda c, x: torch.where(
    _abs(x) > c.attr("threshold", 0.5), x, torch.zeros_like(x)))
_act("hard_sigmoid", lambda c, x: clip_values(
    weak_scalar(c.attr("slope", 0.2), x) * x
    + weak_scalar(c.attr("offset", 0.5), x), 0.0, 1.0))
_act("thresholded_relu", lambda c, x: torch.where(
    x > c.attr("threshold", 1.0), x, torch.zeros_like(x)))
_act("elu", lambda c, x: _elu(x, weak_scalar(c.attr("alpha", 1.0), x)))
_act("pow", lambda c, x: torch.pow(x, weak_scalar(c.attr("factor", 1.0),
                                                  x)))
_act("stanh", lambda c, x: weak_scalar(c.attr("scale_b", 1.7159), x)
     * torch.tanh(weak_scalar(c.attr("scale_a", 2.0 / 3.0), x) * x))
_act("square_act", lambda c, x: x * x)
_act("swish", lambda c, x: x * torch.sigmoid(
    weak_scalar(c.attr("beta", 1.0), x) * x))
_act("gelu", lambda c, x: _gelu(x))


@primitive("leaky_relu", seq_transparent=True)
def leaky_relu(ctx, x):
    """jax.nn.leaky_relu: x where x >= 0, else alpha * x."""
    return torch.where(x >= 0, x, weak_scalar(ctx.attr("alpha", 0.02), x)
                       * x)


@primitive("brelu", seq_transparent=True)
def brelu(ctx, x):
    return clip_values(x, ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0))


@primitive("prelu", inputs=["X", "Alpha"], seq_transparent=True)
def prelu(ctx, x, alpha):
    """reference prelu_op.cc: a learnable negative slope.  Mode
    'channel' aligns a [C] alpha with NCHW dim 1; 'all' and 'element'
    broadcast as they are."""
    if ctx.attr("mode", "all") == "channel" and x.dim() >= 2:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x > 0, x, alpha * x)


@primitive("maxout")
def maxout(ctx, x):
    """reference maxout_op.cc: NCHW channel groups reduced by max (tied
    maxima share the gradient, as jnp.max's does)."""
    groups = ctx.attr("groups")
    n, c, h, w = x.shape
    return x.reshape(n, c // groups, groups, h, w).amax(dim=2)
