"""Optimizer update ops — the port of
``paddle_tpu/fluid/ops/optimizer_ops.py``, with ModelAverage's
``average_accumulates``.

The reference updates functionally and lets XLA donate the buffers; here
each op updates the parameter and its accumulators in place (the output
vars are the input vars) and returns the same tensors, so a step
allocates no second copy of the optimizer state.  The update math runs in
fp32, the master-weight dtype.

A SelectedRows gradient (``embedding(is_sparse=True)``) updates only its
rows.  ``sgd`` adds the rows' scaled gradient; ``adagrad`` adds the
squared merged rows to the moment first and then reads the moment's
updated rows, as the reference's SelectedRows kernel does; ``momentum``
and ``adam`` are lazy, as the reference's: only the touched rows and
their moments change, and Adam's beta powers advance every step.  Each
merges duplicate rows first (``merge_rows``, a sorted segment sum), so
every row is written once and the update is the same at every run.  The
other optimizers densify a sparse gradient (``to_dense``), as the
reference does.
"""

from __future__ import annotations

import torch

from ..core.registry import primitive
from ..core.selected_rows import (SelectedRows, drop_sentinels,
                                  merge_rows, row_targets)


def _f32(g):
    """A gradient as a dense fp32 tensor; a SelectedRows is densified
    (its duplicate rows summed), as the reference's ``_f32`` does for the
    optimizers without a sparse kernel."""
    if isinstance(g, SelectedRows):
        g = g.to_dense()
    return g.float()


class _Rows:
    """The row scatter of a sparse update: a SelectedRows gradient merged,
    its slots' rows to read (sentinels clamped to the last row, as the
    reference's gather clamps) and to write (``row_targets``), and its
    values in fp32."""

    def __init__(self, g: SelectedRows):
        m = merge_rows(g)
        self.sentinel, self.target = row_targets(m.rows, g.height)
        self.read = m.rows.long().clamp(max=g.height - 1)
        self.values = m.values.float()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.read]

    def add(self, t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """t[rows] += v in place; the sentinel slots add -0.0."""
        return t.index_add_(0, self.target,
                            drop_sentinels(self.sentinel, v.to(t.dtype)))

    def set(self, t: torch.Tensor, old: torch.Tensor, new: torch.Tensor
            ) -> torch.Tensor:
        """t[rows] = new in place, ``old`` the rows read before: a
        sentinel slot writes what the first slot writes to its row (the
        row's old value, if that slot is vacant too)."""
        s = self.sentinel.reshape((-1,) + (1,) * (new.dim() - 1))
        first = torch.where(s[:1], old[:1], new[:1])
        return t.index_copy_(0, self.target,
                             torch.where(s, first, new).to(t.dtype))


@primitive("sgd", inputs=["Param", "Grad", "LearningRate"],
           outputs=["ParamOut"], no_grad=True)
def sgd(ctx, p, g, lr):
    """p - lr * g (reference optimizer_ops.py sgd); a SelectedRows
    gradient adds -lr times its merged rows to those rows only (reference
    sgd_op.h's SelectedRows kernel)."""
    if isinstance(g, SelectedRows):
        return g.scatter_add_to(p, scale=-lr.float())
    return p.copy_(p.float() - lr * _f32(g))


@primitive("momentum", inputs=["Param", "Grad", "Velocity", "LearningRate"],
           outputs=["ParamOut", "VelocityOut"], no_grad=True)
def momentum(ctx, p, g, v, lr):
    """v = mu * v + g; p - lr * v, or p - lr * (g + mu * v) with Nesterov
    (reference optimizer_ops.py momentum).  Sparse: only the touched
    rows' velocity and parameter change."""
    mu = ctx.attr("mu", 0.9)
    nesterov = ctx.attr("use_nesterov", False)
    if isinstance(g, SelectedRows):
        r = _Rows(g)
        lr = lr.float().reshape(())
        gv = r.values
        v_rows = r.gather(v)
        v_new = mu * v_rows + gv
        step = (gv + mu * v_new) * lr if nesterov else lr * v_new
        r.set(v, v_rows, v_new)
        r.add(p, -step)
        return p, v
    g = _f32(g)
    v.mul_(mu).add_(g)
    step = (g + mu * v) * lr if nesterov else lr * v
    return p.copy_(p.float() - step), v


@primitive("adam",
           inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
                   "Beta1Pow", "Beta2Pow"],
           outputs=["ParamOut", "Moment1Out", "Moment2Out",
                    "Beta1PowOut", "Beta2PowOut"], no_grad=True)
def adam(ctx, p, g, lr, m1, m2, b1p, b2p):
    """reference optimizer_ops.py adam.  Sparse: lazy, the touched rows'
    moments and parameter only; the beta powers advance every step."""
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    if isinstance(g, SelectedRows):
        r = _Rows(g)
        gv = r.values
        lr_t = (lr.float() * torch.sqrt(1 - b2p) / (1 - b1p)).reshape(())
        m1_rows, m2_rows = r.gather(m1), r.gather(m2)
        m1n = b1 * m1_rows + (1 - b1) * gv
        m2n = b2 * m2_rows + (1 - b2) * gv * gv
        step = lr_t * m1n / (torch.sqrt(m2n) + eps)
        r.add(p, -step)
        r.set(m1, m1_rows, m1n)
        r.set(m2, m2_rows, m2n)
    else:
        g = _f32(g)
        m1.mul_(b1).add_((1 - b1) * g)
        m2.mul_(b2).add_((1 - b2) * g * g)
        lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
        p.sub_((lr_t * m1 / (torch.sqrt(m2) + eps)).to(p.dtype))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return p, m1, m2, b1p, b2p


@primitive("adamax",
           inputs=["Param", "Grad", "LearningRate", "Moment", "InfNorm",
                   "Beta1Pow"],
           outputs=["ParamOut", "MomentOut", "InfNormOut"], no_grad=True)
def adamax(ctx, p, g, lr, m, u, b1p):
    """reference optimizer_ops.py adamax; Beta1Pow advances in the
    optimizer's ``_finish_update``."""
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    g = _f32(g)
    m.mul_(b1).add_((1 - b1) * g)
    torch.maximum(b2 * u, torch.abs(g), out=u)
    return p.copy_(p.float() - (lr / (1 - b1p)) * m / (u + eps)), m, u


@primitive("adagrad", inputs=["Param", "Grad", "Moment", "LearningRate"],
           outputs=["ParamOut", "MomentOut"], no_grad=True)
def adagrad(ctx, p, g, m, lr):
    """m += g * g; p - lr * g / (sqrt(m) + eps) (reference optimizer_ops.py
    adagrad).  Sparse (reference adagrad_op.cc's SelectedRows kernel):
    the merged rows' squares go into the moment first, then the update
    reads the moment's updated rows; other rows keep both."""
    eps = ctx.attr("epsilon", 1e-6)
    if isinstance(g, SelectedRows):
        r = _Rows(g)
        gv = r.values
        r.add(m, gv * gv)
        upd = -lr.float() * gv / (torch.sqrt(r.gather(m)) + eps)
        r.add(p, upd)
        return p, m
    g = _f32(g)
    m.add_(g * g)
    return p.copy_(p.float() - lr * g / (torch.sqrt(m) + eps)), m


@primitive("decayed_adagrad", inputs=["Param", "Grad", "Moment",
                                      "LearningRate"],
           outputs=["ParamOut", "MomentOut"], no_grad=True)
def decayed_adagrad(ctx, p, g, m, lr):
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    g = _f32(g)
    m.mul_(decay).add_((1 - decay) * g * g)
    return p.copy_(p.float() - lr * g / (torch.sqrt(m) + eps)), m


@primitive("adadelta", inputs=["Param", "Grad", "AvgSquaredGrad",
                               "AvgSquaredUpdate"],
           outputs=["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
           no_grad=True)
def adadelta(ctx, p, g, ag, au):
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    g = _f32(g)
    ag.mul_(rho).add_((1 - rho) * g * g)
    upd = torch.sqrt(au + eps) / torch.sqrt(ag + eps) * g
    au.mul_(rho).add_((1 - rho) * upd * upd)
    return p.copy_(p.float() - upd), ag, au


@primitive("rmsprop", inputs=["Param", "Grad", "Moment", "MeanSquare",
                              "LearningRate"],
           outputs=["ParamOut", "MomentOut", "MeanSquareOut"], no_grad=True)
def rmsprop(ctx, p, g, m, ms, lr):
    rho = ctx.attr("decay", 0.9)
    eps = ctx.attr("epsilon", 1e-10)
    mom = ctx.attr("momentum", 0.0)
    g = _f32(g)
    ms.mul_(rho).add_((1 - rho) * g * g)
    m.copy_(mom * m + lr * g / torch.sqrt(ms + eps))
    return p.copy_(p.float() - m), m, ms


@primitive("ftrl", inputs=["Param", "Grad", "SquaredAccumulator",
                           "LinearAccumulator", "LearningRate"],
           outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
           no_grad=True)
def ftrl(ctx, p, g, sq, lin, lr):
    """reference optimizer_ops.py ftrl (``lr_power`` -0.5 by default)."""
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    power = ctx.attr("lr_power", -0.5)
    g = _f32(g)
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    lin.copy_(lin + g - sigma * p.float())
    pre = torch.where(torch.abs(lin) > l1, torch.sign(lin) * l1 - lin,
                      torch.zeros_like(lin))
    denom = new_sq ** -power / lr + 2 * l2
    sq.copy_(new_sq)
    return p.copy_(pre / denom), sq, lin


def _prox_shrink(prox_param, lr, l1, l2):
    """The soft-threshold step of the proximal pair
    (proximal_adagrad_op.h:55-63, proximal_gd_op.h:50-58):
    sign(z) * max(|z| - lr*l1, 0) / (1 + lr*l2), or z / (1 + lr*l2)
    when l1 == 0."""
    if l1 > 0:
        return (torch.sign(prox_param)
                * torch.clamp(torch.abs(prox_param) - lr * l1, min=0.0)
                / (1.0 + lr * l2))
    return prox_param / (1.0 + lr * l2)


@primitive("proximal_gd", inputs=["Param", "Grad", "LearningRate"],
           outputs=["ParamOut"], no_grad=True)
def proximal_gd(ctx, p, g, lr):
    """reference proximal_gd_op.cc: p - lr * g, then the l1 / l2
    proximal shrink."""
    prox = p.float() - lr * _f32(g)
    return p.copy_(_prox_shrink(prox, lr, ctx.attr("l1", 0.0),
                                ctx.attr("l2", 0.0)))


@primitive("proximal_adagrad",
           inputs=["Param", "Moment", "Grad", "LearningRate"],
           outputs=["ParamOut", "MomentOut"], no_grad=True)
def proximal_adagrad(ctx, p, m, g, lr):
    """reference proximal_adagrad_op.cc: m += g * g, p - lr * g /
    sqrt(m), then the l1 / l2 proximal shrink."""
    g = _f32(g)
    m.add_(g * g)
    prox = p.float() - lr * g / torch.sqrt(m)
    return p.copy_(_prox_shrink(prox, lr, ctx.attr("l1", 0.0),
                                ctx.attr("l2", 0.0))), m


@primitive("average_accumulates",
           inputs=["Param", "InSum1", "InSum2", "InSum3",
                   "InNumAccumulates", "InOldNumAccumulates",
                   "InNumUpdates"],
           outputs=["OutSum1", "OutSum2", "OutSum3", "OutNumAccumulates",
                    "OutOldNumAccumulates", "OutNumUpdates"],
           no_grad=True)
def average_accumulates(ctx, p, sum1, sum2, sum3, num_acc, old_num_acc,
                        num_upd):
    """ModelAverage's windowed parameter sums (reference
    parameter/AverageOptimizer.h:23 update() and
    isAverageWindowTooLong()).  sum1 holds the running partial window,
    flushed into sum2 every 16384 updates so the float32 sum keeps its
    precision; when the window is full (num_acc >= min_window and >=
    min(max_window, num_upd * rate)) the partial sums move to sum3 and
    the count restarts.  The counters are the runtime's int32 (the
    declared int64 narrowed, as in the reference).  Every branch is a
    device ``where``: no host control flow, so the op stays inside a
    captured step."""
    rate = float(ctx.attr("average_window", 0.15))
    min_win = int(ctx.attr("min_average_window", 10000))
    max_win = int(ctx.attr("max_average_window", 10000))
    kmax = 16384

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    sum1 = sum1 + p.float()
    flush = torch.remainder(num_upd, kmax) == 0
    sum2 = torch.where(flush, sum2 + sum1, sum2)
    sum1 = torch.where(flush, torch.zeros_like(sum1), sum1)
    window = (num_upd.float() * rate).to(num_upd.dtype).clamp_max(max_win)
    shift = (num_acc >= min_win) & (num_acc >= window)
    sum3 = torch.where(shift, sum1 + sum2, sum3)
    sum1 = torch.where(shift, torch.zeros_like(sum1), sum1)
    sum2 = torch.where(shift, torch.zeros_like(sum2), sum2)
    old_num_acc = torch.where(shift, num_acc, old_num_acc)
    num_acc = torch.where(shift, torch.zeros_like(num_acc), num_acc)
    return sum1, sum2, sum3, num_acc, old_num_acc, num_upd
