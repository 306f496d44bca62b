"""KV-cache ops — the port of ``paddle_tpu/fluid/ops/cache_ops.py``, with
the reference's slots and attrs: the dense generator's ``cache_write``
and ``decode_attention``, and the paged engine's ``paged_cache_write``,
``quantized_paged_cache_write``, ``ragged_decode_attention``, the
copy-on-write page copies ``paged_page_copy`` /
``quantized_paged_page_copy`` and the KV-tier transfers
``paged_page_gather`` / ``paged_page_scatter`` (and their int8 forms).

``cache_write`` writes a preallocated [B, L, H, D] cache in place at
each lane's position (``Out`` aliases ``Cache``), and
``decode_attention`` attends over the cache's first ``lengths`` rows:
the reference leaves both to XLA, so here they are plain PyTorch on
every device (``kernels.flash_attention.decode_attention``).

The pool is ONE persistable tensor ``[H, R, page_size, D]``; a *logical*
page spans every layer and K+V of a page_size-token span, and
``kernels.flash_attention.paged_kv_rows`` is the single source of truth
for the physical-row arithmetic.  Logical page 0 is the trash page that
dead lanes and dead chunk positions write into, so one program serves
any mix of prefilling, decoding and idle lanes.

The writes are plain scatters (the JAX package leaves them to XLA), so
here they are ``index_put_`` on the pool.  Where JAX donated the pool
and got a fresh array back, the port writes the pool IN PLACE and
returns the same tensor: ``Out`` aliases ``Pool`` (and ``ScalesOut``
aliases ``Scales``), so the executor sees its state var written in
place and copies nothing back.  Two tokens of one write can only share
a (row, slot) on the trash page, whose contents no live lane reads, so
the order in which duplicate writes land does not matter.  No emitter
reads a value on the host: the serving step is captured in a CUDA graph.
Every op here is inference-only (``no_grad``).
"""

from __future__ import annotations

import torch

from ..core.registry import primitive
from ...kernels.flash_attention import paged_kv_rows
from .quant_ops import abs_max_scale, quantize_array

__all__ = ["cache_write", "decode_attention", "paged_cache_write",
           "quantized_paged_cache_write", "ragged_decode_attention",
           "paged_page_copy", "quantized_paged_page_copy",
           "paged_page_gather", "paged_page_scatter",
           "quantized_paged_page_gather", "quantized_paged_page_scatter"]


@primitive("cache_write", inputs=["Cache", "Value", "Index"],
           outputs=["Out"], no_grad=True)
def cache_write(ctx, cache, value, index):
    """Write ``value`` into ``cache`` at ``index`` along ``axis``, in
    place, and return ``cache``.  ``index`` [1] (or a scalar): one offset
    for every row, clamped so the value fits, as
    ``lax.dynamic_update_slice`` clamps it; ``index`` [B] with axis 1:
    row b's value [k, ...] lands at positions index[b] .. index[b]+k-1
    (continuous batching: each lane at its own depth)."""
    axis = int(ctx.attr("axis", 1))
    idx = index.reshape(-1).to(torch.long)
    value = value.to(cache.dtype)
    k = value.shape[axis]
    span = torch.arange(k, device=cache.device)
    if idx.shape[0] == 1:
        start = idx.clamp(0, cache.shape[axis] - k)
        cache.index_copy_(axis, start + span, value)
        return cache
    if axis != 1:
        raise ValueError(f"cache_write: per-row index vectors require "
                         f"axis=1, got axis={axis}")
    b = cache.shape[0]
    if idx.shape[0] != b:
        raise ValueError(f"cache_write: index vector length {idx.shape[0]} "
                         f"!= cache batch {b}")
    rows = idx[:, None] + span[None, :]                      # [B, k]
    batch = torch.arange(b, device=cache.device)[:, None]
    cache[batch, rows] = value
    return cache


@primitive("decode_attention", inputs=["Q", "KCache", "VCache", "Lengths"],
           outputs=["Out"], no_grad=True)
def decode_attention(ctx, q, k_cache, v_cache, lengths):
    """Length-masked attention of a decode step's queries over the KV
    cache (``kernels.flash_attention.decode_attention``: q [B, Lq, H, D],
    caches [B, Lmax, H, D], lengths [B] live rows)."""
    from ...kernels.flash_attention import decode_attention as _da

    return _da(q, k_cache, v_cache, lengths,
               sm_scale=ctx.attr("sm_scale", None))


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


@primitive("paged_cache_write",
           inputs=["Pool", "K", "V", "Pages", "Offsets"], outputs=["Out"],
           no_grad=True)
def paged_cache_write(ctx, pool, k, v, pages, offsets):
    """Scatter one layer's K/V for up to C tokens per lane into the pool.

    ``k``/``v`` [B, C, H, D] head-interleaved values, ``pages`` [B, C]
    logical page per token, ``offsets`` [B, C] slot within the page;
    attrs ``layer`` / ``n_layer`` resolve pages to physical rows.  Writes
    ``pool`` in place (cast to the pool's dtype, rounding to nearest even
    for bf16) and returns it."""
    layer = int(ctx.attr("layer", 0))
    n_layer = int(ctx.attr("n_layer", 1))
    k, v, pages, offsets = _per_token(k, v, pages, offsets)
    k_rows, v_rows = paged_kv_rows(pages, layer, n_layer)
    # pool[h, rows[b, c], offs[b, c]] <- value[b, c, h, :]
    pool[:, k_rows, offsets] = k.to(pool.dtype).permute(2, 0, 1, 3)
    pool[:, v_rows, offsets] = v.to(pool.dtype).permute(2, 0, 1, 3)
    return pool


@primitive("quantized_paged_cache_write",
           inputs=["Pool", "Scales", "K", "V", "Pages", "Offsets"],
           outputs=["Out", "ScalesOut"], no_grad=True)
def quantized_paged_cache_write(ctx, pool, scales, k, v, pages, offsets):
    """``paged_cache_write`` for an int8 pool: each token's K (and V)
    [H, D] slab quantizes with one fp32 max-abs scale, stored in the
    ``scales`` sidecar [1, R, page_size] at the same (row, slot) the int8
    bytes land in.  Writes both in place and returns them."""
    layer = int(ctx.attr("layer", 0))
    n_layer = int(ctx.attr("n_layer", 1))
    k, v, pages, offsets = _per_token(k, v, pages, offsets)
    k_rows, v_rows = paged_kv_rows(pages, layer, n_layer)
    for val, rows in ((k, k_rows), (v, v_rows)):
        vf = val.to(torch.float32)
        sc = abs_max_scale(vf, axis=(0, 1))                 # [B, C]
        q = quantize_array(vf, sc, axis=(0, 1))
        pool[:, rows, offsets] = q.permute(2, 0, 1, 3)
        scales[0, rows, offsets] = sc
    return pool, scales


@primitive("ragged_decode_attention",
           inputs=["Q", "Pool", "PageTable", "Lengths", "QBase?", "Scales?"],
           outputs=["Out"], no_grad=True)
def ragged_decode_attention(ctx, q, pool, page_table, lengths, q_base,
                            scales):
    """Per-lane attention over the lane's page list: the CUDA kernel on
    the card, ``ragged_attention_plain`` on the CPU (see
    ``kernels.flash_attention.ragged_decode_attention``: q [B, C, H, D],
    pool [H, R, page_size, D], page_table [B, P] int32 logical pages,
    lengths [B], optional q_base [B] for causal chunk queries, optional
    Scales [1, R, page_size] fp32 block scales for an int8 pool)."""
    from ...kernels.flash_attention import ragged_decode_attention as _ra

    return _ra(q, pool, page_table, lengths, q_base,
               layer=int(ctx.attr("layer", 0)),
               n_layer=int(ctx.attr("n_layer", 1)),
               causal=bool(ctx.attr("causal", True)),
               sm_scale=ctx.attr("sm_scale", None),
               impl=ctx.attr("impl", None),
               scales=scales)


def _page_copy_rows(src, dst, n_layer: int):
    """Logical pages [B] -> their physical rows [B, 2L] (every layer, K
    and V)."""
    span = torch.arange(2 * n_layer, device=src.device)[None, :]
    src = src.reshape(-1).to(torch.long)
    dst = dst.reshape(-1).to(torch.long)
    return (src[:, None] * (2 * n_layer) + span,
            dst[:, None] * (2 * n_layer) + span)


@primitive("paged_page_copy", inputs=["Pool", "Src", "Dst"],
           outputs=["Out"], no_grad=True)
def paged_page_copy(ctx, pool, src, dst):
    """Copy whole logical pages (all layers, K and V) ``src[b] ->
    dst[b]`` in place: the device half of copy-on-write, run in the beam
    step before its writes.  The source rows are gathered before the
    scatter, so a lane with no copy (``TRASH_PAGE -> TRASH_PAGE``, the
    no-op encoding) writes the trash rows' own values back."""
    src_rows, dst_rows = _page_copy_rows(src, dst,
                                         int(ctx.attr("n_layer", 1)))
    pool[:, dst_rows] = pool[:, src_rows]
    return pool


@primitive("quantized_paged_page_copy",
           inputs=["Pool", "Scales", "Src", "Dst"],
           outputs=["Out", "ScalesOut"], no_grad=True)
def quantized_paged_page_copy(ctx, pool, scales, src, dst):
    """``paged_page_copy`` for an int8 pool: the fp32 block scales move
    with the same physical rows as the int8 bytes, so a copied page is
    bitwise its parent, scales included."""
    src_rows, dst_rows = _page_copy_rows(src, dst,
                                         int(ctx.attr("n_layer", 1)))
    pool[:, dst_rows] = pool[:, src_rows]
    scales[:, dst_rows] = scales[:, src_rows]
    return pool, scales


# -- the KV tier's transfers ------------------------------------------------
# gather pulls whole logical pages out of the pool as a dense [H, W*2L,
# page_size, D] slab the host fetches (device to host); scatter writes
# such a slab back into pages (host to device).  W is fixed per program
# (short transfers pad with the trash page) and the page lists are int32
# data, so the tier adds two captured steps and no recompiles.

def _page_rows(pages, n_layer: int):
    """Logical pages [W] -> their physical rows [W*2L], page by page."""
    span = torch.arange(2 * n_layer, device=pages.device)[None, :]
    pages = pages.reshape(-1).to(torch.long)
    return (pages[:, None] * (2 * n_layer) + span).reshape(-1)


@primitive("paged_page_gather", inputs=["Pool", "Pages"],
           outputs=["Out"], no_grad=True)
def paged_page_gather(ctx, pool, pages):
    """Gather W whole logical pages (all layers, K and V) into a dense
    slab [H, W*2L, page_size, D] for the host; ``pages`` [W] int32, a
    trash-page entry gathers rows the host ignores."""
    return pool[:, _page_rows(pages, int(ctx.attr("n_layer", 1)))]


@primitive("paged_page_scatter", inputs=["Pool", "Data", "Pages"],
           outputs=["Out"], no_grad=True)
def paged_page_scatter(ctx, pool, data, pages):
    """Scatter a gathered slab [H, W*2L, page_size, D] into the pool at
    W logical pages, in place (``Out`` aliases ``Pool``); the padding
    entries all land on the trash page, in any order."""
    rows = _page_rows(pages, int(ctx.attr("n_layer", 1)))
    pool[:, rows] = data.to(pool.dtype)
    return pool


@primitive("quantized_paged_page_gather", inputs=["Pool", "Scales", "Pages"],
           outputs=["Out", "ScalesOut"], no_grad=True)
def quantized_paged_page_gather(ctx, pool, scales, pages):
    """``paged_page_gather`` for an int8 pool: the fp32 block-scale rows
    travel with the int8 bytes (the same physical rows)."""
    rows = _page_rows(pages, int(ctx.attr("n_layer", 1)))
    return pool[:, rows], scales[:, rows]


@primitive("quantized_paged_page_scatter",
           inputs=["Pool", "Scales", "Data", "ScaleData", "Pages"],
           outputs=["Out", "ScalesOut"], no_grad=True)
def quantized_paged_page_scatter(ctx, pool, scales, data, scale_data, pages):
    """``paged_page_scatter`` for an int8 pool: the int8 bytes and their
    fp32 block scales land at the same physical rows, both in place."""
    rows = _page_rows(pages, int(ctx.attr("n_layer", 1)))
    pool[:, rows] = data.to(pool.dtype)
    scales[:, rows] = scale_data.to(scales.dtype)
    return pool, scales
