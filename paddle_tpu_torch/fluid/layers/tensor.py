"""Tensor layers — the port of ``paddle_tpu/fluid/layers/tensor.py``,
cut to ``cast``; the creation layers (``fill_constant``, ``zeros``,
``concat``, ...) and the cache writes are not ported."""

from __future__ import annotations

__all__ = ["cast"]


def cast(x, dtype):
    from .ops import cast as _cast

    return _cast(x, dtype)
