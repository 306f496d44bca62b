"""Paged KV-cache writes — the port of ``paged_cache_write`` and
``quantized_paged_cache_write`` from ``paddle_tpu/fluid/ops/cache_ops.py``.

The pool is ONE tensor ``[H, R, page_size, D]``; a *logical* page spans
every layer and K+V of a page_size-token span, and
``kernels.flash_attention.paged_kv_rows`` is the single source of truth
for the physical-row arithmetic.  Logical page 0 is the trash page that
dead lanes and dead chunk positions write into.

Both writes are plain scatters (the JAX package leaves them to XLA), so
here they are ``index_put_`` on the pool.  Where JAX donated the pool
and got a fresh array back, the port writes the pool IN PLACE and
returns the same tensor.  Two tokens of one write can only share a
(row, slot) on the trash page, whose contents no live lane reads, so
the order in which duplicate writes land does not matter.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...kernels.flash_attention import paged_kv_rows
from .quant_ops import abs_max_scale, quantize_array

__all__ = ["paged_cache_write", "quantized_paged_cache_write"]


def _per_token(k, v, pages, offsets):
    """Accept the one-token-per-lane decode form ([B] pages, [B, H, D]
    values) as well as the [B, C] chunk form."""
    pages = pages.to(torch.long)
    offsets = offsets.to(torch.long)
    if pages.dim() == 1:
        pages = pages[:, None]
        offsets = offsets[:, None]
        k = k if k.dim() == 4 else k[:, None]
        v = v if v.dim() == 4 else v[:, None]
    return k, v, pages, offsets


def paged_cache_write(pool: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pages: torch.Tensor, offsets: torch.Tensor, *,
                      layer: int, n_layer: int) -> torch.Tensor:
    """Scatter one layer's K/V for up to C tokens per lane into the pool.

    ``k``/``v`` [B, C, H, D] head-interleaved values, ``pages`` [B, C]
    logical page per token, ``offsets`` [B, C] slot within the page.
    Writes ``pool`` in place (cast to the pool's dtype, rounding to
    nearest even for bf16) and returns it."""
    k, v, pages, offsets = _per_token(k, v, pages, offsets)
    k_rows, v_rows = paged_kv_rows(pages, layer, n_layer)
    # pool[h, rows[b, c], offs[b, c]] <- value[b, c, h, :]
    pool[:, k_rows, offsets] = k.to(pool.dtype).permute(2, 0, 1, 3)
    pool[:, v_rows, offsets] = v.to(pool.dtype).permute(2, 0, 1, 3)
    return pool


def quantized_paged_cache_write(pool: torch.Tensor, scales: torch.Tensor,
                                k: torch.Tensor, v: torch.Tensor,
                                pages: torch.Tensor, offsets: torch.Tensor,
                                *, layer: int, n_layer: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``paged_cache_write`` for an int8 pool: each token's K (and V)
    [H, D] slab quantizes with one fp32 max-abs scale, stored in the
    ``scales`` sidecar [1, R, page_size] at the same (row, slot) the int8
    bytes land in.  Writes both in place and returns them."""
    k, v, pages, offsets = _per_token(k, v, pages, offsets)
    k_rows, v_rows = paged_kv_rows(pages, layer, n_layer)
    for val, rows in ((k, k_rows), (v, v_rows)):
        vf = val.to(torch.float32)
        sc = abs_max_scale(vf, axis=(0, 1))                 # [B, C]
        q = quantize_array(vf, sc, axis=(0, 1))
        pool[:, rows, offsets] = q.permute(2, 0, 1, 3)
        scales[0, rows, offsets] = sc
    return pool, scales
