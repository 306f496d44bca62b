"""Symmetric max-abs int8 quantization — the port of
``abs_max_scale`` and ``quantize_array`` from
``paddle_tpu/fluid/ops/quant_ops.py``.

These two functions are the KV pool's quantize-on-write rule
(``cache_ops.quantized_paged_cache_write``) and must give the JAX
package's bytes bit for bit: the scale is ``max|x| / 127`` divided in
float32 (a zero channel gets scale 1.0), and the quantized value is
``clip(round(x / scale), -127, 127)``.  ``jnp.round`` and
``torch.round`` both round half to even, and both sides divide rather
than multiply by a reciprocal, so the results agree exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["QMAX", "abs_max_scale", "quantize_array"]

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
    scale = amax.to(torch.float32) / QMAX
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def quantize_array(x: torch.Tensor, scale: torch.Tensor,
                   axis: Axis = None) -> torch.Tensor:
    """clip(round(x / scale)) -> int8, scale broadcast at ``axis``."""
    xf = x.to(torch.float32)
    if axis is not None:
        scale = _broadcast_scale(scale, xf.dim(), axis)
    q = torch.round(xf / scale)
    return q.clamp(-QMAX, QMAX).to(torch.int8)
