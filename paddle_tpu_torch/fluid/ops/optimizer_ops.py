"""Optimizer update ops — the port of
``paddle_tpu/fluid/ops/optimizer_ops.py``, cut to dense ``adam``.

The reference updates functionally and lets XLA donate the buffers; here
the op updates the parameter and its accumulators in place (the output
vars are the input vars) and returns the same tensors, so a step
allocates no second copy of the optimizer state.  The update math runs in
fp32, the master-weight dtype.
"""

from __future__ import annotations

import torch

from ..core.registry import primitive


@primitive("adam",
           inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                   "Beta1Pow", "Beta2Pow"],
           outputs=["ParamOut", "Moment1Out", "Moment2Out",
                    "Beta1PowOut", "Beta2PowOut"], no_grad=True)
def adam(ctx, p, g, lr, m1, m2, b1p, b2p):
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    g = g.float()
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p.sub_((lr_t * m1 / (torch.sqrt(m2) + eps)).to(p.dtype))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return p, m1, m2, b1p, b2p
