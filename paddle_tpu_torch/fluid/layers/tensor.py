"""Tensor layers — the port of ``paddle_tpu/fluid/layers/tensor.py``,
cut to ``create_global_var``, ``fill_constant`` (the learning-rate
schedules' constants), ``concat``, ``assign``, ``cast``, ``argmax``,
the dense and paged KV-cache writes and the copy-on-write page copy;
the other creation layers and the KV-tier transfer layers are not
ported."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "fill_constant", "concat", "assign",
           "cast", "argmax", "cache_write",
           "paged_cache_write", "quantized_paged_cache_write",
           "paged_page_copy"]


def create_global_var(shape, value, dtype, persistable=False, name=None):
    from ..initializer import ConstantInitializer

    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(shape=shape, dtype=dtype,
                                        persistable=persistable, name=name)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    out = out or helper.create_tmp_variable(dtype)
    helper.append_op("fill_constant", {}, {"Out": out},
                     {"shape": list(shape), "dtype": dtype,
                      "value": float(value)})
    return out


def concat(input, axis=0, name=None):
    """The inputs joined along ``axis`` (``ops/tensor_ops.concat``)."""
    helper = LayerHelper("concat", name=name, input=input)
    out = helper.create_tmp_variable(helper.input_dtype())
    helper.append_op("concat", {"X": input}, {"Out": out}, {"axis": axis})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    output = output or helper.create_tmp_variable(input.dtype,
                                                  lod_level=input.lod_level)
    helper.append_op("assign", {"X": input}, {"Out": output})
    return output


def cast(x, dtype):
    from .ops import cast as _cast

    return _cast(x, dtype)


def argmax(x, axis=-1):
    helper = LayerHelper("argmax")
    out = helper.create_tmp_variable("int32", stop_gradient=True)
    helper.append_op("argmax", {"X": x}, {"Out": out}, {"axis": axis})
    return out


def cache_write(cache, value, index, axis=1, out=None):
    """Write ``value`` into the preallocated ``cache`` var at ``index``
    along ``axis`` (``ops/cache_ops.cache_write``).  Out defaults to the
    cache variable itself, so the step writes the persistable cache in
    place.  ``index`` is one offset, or with axis=1 a [B] vector of each
    row's position (continuous batching)."""
    helper = LayerHelper("cache_write")
    out = out or cache
    out.stop_gradient = True
    helper.append_op("cache_write",
                     {"Cache": cache, "Value": value, "Index": index},
                     {"Out": out}, {"axis": int(axis)})
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


def paged_page_copy(pool, src, dst, n_layer, out=None, scales=None,
                    scales_out=None):
    """Copy whole logical pages ``src[b] -> dst[b]`` (all layers, K and
    V) in the step, before its writes: the device half of copy-on-write
    page sharing; ``src == dst`` is a lane's no-op
    (``ops/cache_ops.paged_page_copy``).  With the int8 pool's
    ``scales`` the fp32 block scales move with the bytes
    (``quantized_paged_page_copy``) and (pool, scales) is returned."""
    if scales is not None:
        helper = LayerHelper("quantized_paged_page_copy")
        out = out or pool
        scales_out = scales_out or scales
        out.stop_gradient = True
        scales_out.stop_gradient = True
        helper.append_op("quantized_paged_page_copy",
                         {"Pool": pool, "Scales": scales, "Src": src,
                          "Dst": dst},
                         {"Out": out, "ScalesOut": scales_out},
                         {"n_layer": int(n_layer)})
        return out, scales_out
    helper = LayerHelper("paged_page_copy")
    out = out or pool
    out.stop_gradient = True
    helper.append_op("paged_page_copy",
                     {"Pool": pool, "Src": src, "Dst": dst},
                     {"Out": out}, {"n_layer": int(n_layer)})
    return out
