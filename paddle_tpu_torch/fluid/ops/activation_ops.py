"""Activation ops — the port of ``paddle_tpu/fluid/ops/activation_ops.py``,
cut to the Transformer's ``relu``."""

from __future__ import annotations

import torch

from ..core.registry import primitive


@primitive("relu")
def relu(ctx, x):
    return torch.relu(x)
