"""Tensor layers — the port of ``paddle_tpu/fluid/layers/tensor.py``,
cut to ``cast``, ``argmax`` and the paged KV-cache writes; the creation
layers (``fill_constant``, ``zeros``, ``concat``, ...), the dense
``cache_write`` and the page copy / transfer layers are not ported."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cast", "argmax", "paged_cache_write",
           "quantized_paged_cache_write"]


def cast(x, dtype):
    from .ops import cast as _cast

    return _cast(x, dtype)


def argmax(x, axis=-1):
    helper = LayerHelper("argmax")
    out = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("argmax", {"X": x}, {"Out": out}, {"axis": axis})
    return out


def paged_cache_write(pool, k, v, pages, offsets, layer, n_layer, out=None):
    """Scatter one layer's K/V token values into the paged KV pool
    (``ops/cache_ops.paged_cache_write``).  ``k``/``v`` [B, C, H, D] ride
    head-interleaved; ``pages``/``offsets`` [B, C] int32 map each token
    to (logical page, slot).  Out defaults to the pool variable itself,
    so the step writes the persistable pool in place."""
    helper = LayerHelper("paged_cache_write")
    out = out or pool
    out.stop_gradient = True
    helper.append_op("paged_cache_write",
                     {"Pool": pool, "K": k, "V": v, "Pages": pages,
                      "Offsets": offsets},
                     {"Out": out},
                     {"layer": int(layer), "n_layer": int(n_layer)})
    return out


def quantized_paged_cache_write(pool, scales, k, v, pages, offsets, layer,
                                n_layer, out=None, scales_out=None):
    """``paged_cache_write`` for an int8 pool: K/V quantize on write (one
    fp32 max-abs scale per token block, landing in the ``scales`` sidecar
    [1, R, page_size] at the same (row, slot) as the int8 bytes).
    Out/ScalesOut default to the pool/scales vars themselves; returns
    (pool, scales)."""
    helper = LayerHelper("quantized_paged_cache_write")
    out = out or pool
    scales_out = scales_out or scales
    out.stop_gradient = True
    scales_out.stop_gradient = True
    helper.append_op("quantized_paged_cache_write",
                     {"Pool": pool, "Scales": scales, "K": k, "V": v,
                      "Pages": pages, "Offsets": offsets},
                     {"Out": out, "ScalesOut": scales_out},
                     {"layer": int(layer), "n_layer": int(n_layer)})
    return out, scales_out
