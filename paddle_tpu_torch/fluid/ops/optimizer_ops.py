"""Optimizer update ops — the port of
``paddle_tpu/fluid/ops/optimizer_ops.py``, cut to dense ``sgd``,
``momentum`` and ``adam``.

The reference updates functionally and lets XLA donate the buffers; here
the op updates the parameter and its accumulators in place (the output
vars are the input vars) and returns the same tensors, so a step
allocates no second copy of the optimizer state.  The update math runs in
fp32, the master-weight dtype.  A gradient that is not a dense tensor (the
reference's SelectedRows, from ``embedding(is_sparse=True)``) raises: the
sparse updates are not ported.
"""

from __future__ import annotations

import torch

from ..core.registry import primitive


def _dense_f32(op: str, g):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(f"{op}: {type(g).__name__} gradients "
                                  f"(SelectedRows) are not ported")
    return g.float()


@primitive("sgd", inputs=["Param", "Grad", "LearningRate"],
           outputs=["ParamOut"], no_grad=True)
def sgd(ctx, p, g, lr):
    """p - lr * g (reference optimizer_ops.py sgd, dense)."""
    return p.copy_(p.float() - lr * _dense_f32("sgd", g))


@primitive("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
           outputs=["ParamOut", "VelocityOut"], no_grad=True)
def momentum(ctx, p, g, v, lr):
    """v = mu * v + g; p - lr * v, or p - lr * (g + mu * v) with Nesterov
    (reference optimizer_ops.py momentum, dense)."""
    mu = ctx.attr("mu", 0.9)
    g = _dense_f32("momentum", g)
    v.mul_(mu).add_(g)
    step = (g + mu * v) * lr if ctx.attr("use_nesterov", False) else lr * v
    return p.copy_(p.float() - step), v


@primitive("adam",
           inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                   "Beta1Pow", "Beta2Pow"],
           outputs=["ParamOut", "Moment1Out", "Moment2Out",
                    "Beta1PowOut", "Beta2PowOut"], no_grad=True)
def adam(ctx, p, g, lr, m1, m2, b1p, b2p):
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    g = _dense_f32("adam", g)
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p.sub_((lr_t * m1 / (torch.sqrt(m2) + eps)).to(p.dtype))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return p, m1, m2, b1p, b2p
