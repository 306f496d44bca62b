"""Ragged paged attention — the port of the serving half of
``paddle_tpu/kernels/flash_attention.py``.

The paged KV pool is ONE tensor ``[H, R, page_size, D]`` (head-major: one
head's page is a contiguous ``page_size x D`` slab).  A *logical* page
spans every layer and both K and V of a page_size-token span: physical
row = ``(page * n_layer + layer) * 2`` (+1 for V).  Per-request block
tables hold logical page ids; page 0 is the trash page dead lanes write
into.

``ragged_decode_attention`` is the entry the model calls.  For a CUDA
tensor it launches the hand-written kernel
``csrc/ragged_paged_attention.cu`` (the port of the TPU kernel
``_ragged_kernel``); for a CPU tensor it runs ``ragged_attention_plain``,
the counterpart of the reference's ``_ragged_xla``.  Nothing falls back:
a build or launch failure raises.  The flash forward and backward
kernels of the training path are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = ["paged_kv_rows", "ragged_attention_plain",
           "ragged_decode_attention", "KERNEL_NAME"]

KERNEL_NAME = "ragged_paged_attention"
MASK_VALUE = -1e9          # the reference's masked-score value, exactly
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232448       # dynamic shared memory one sm_90 block may use


def paged_kv_rows(page_table: torch.Tensor, layer: int, n_layer: int):
    """Logical page table [B, P] -> (k_rows, v_rows) physical row tables
    for one layer (int64, ready to index with).  Shared by the plain
    version and the paged writes, so the two cannot disagree on the pool
    layout; the CUDA kernel repeats the same arithmetic."""
    base = (page_table.to(torch.long) * n_layer + layer) * 2
    return base, base + 1


def ragged_attention_plain(q, pool, page_table, lengths, q_base, layer,
                           n_layer, causal, sm_scale, scales=None):
    """Gather-based plain version (the reference's ``_ragged_xla``):
    resolve each lane's pages to pool rows and run length/causally-masked
    attention over the gathered prefix.  Masked scores become -1e9, and
    a row with no kept key returns 0 (dead lanes, length 0).  int8 pools
    dequantize with the per-(row, slot) ``scales``; bf16 pools upcast to
    the query dtype before the dot."""
    h, _r, ps, d = pool.shape
    b, c = q.shape[0], q.shape[1]
    n_pages = page_table.shape[1]
    k_rows, v_rows = paged_kv_rows(page_table, layer, n_layer)
    k = pool[:, k_rows]                       # [h, B, P, ps, d]
    v = pool[:, v_rows]
    if scales is not None:
        sc = scales.reshape(scales.shape[-2], scales.shape[-1])  # [R, ps]
        k = k.to(torch.float32) * sc[k_rows][None, :, :, :, None]
        v = v.to(torch.float32) * sc[v_rows][None, :, :, :, None]
    elif k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    scores = torch.einsum("bqhd,hbpsd->bhqps", q, k)
    scores = scores.reshape(b, h, c, n_pages * ps).to(torch.float32)
    scores = scores * sm_scale
    cols = torch.arange(n_pages * ps, dtype=torch.int32, device=q.device)
    lengths = lengths.to(device=q.device, dtype=torch.int32)
    keep = cols[None, :] < lengths[:, None]                       # [B, L]
    if causal:
        rows = (q_base.to(device=q.device, dtype=torch.int32)[:, None]
                + torch.arange(c, dtype=torch.int32,
                               device=q.device)[None, :])          # [B, C]
        keep = keep[:, None, :] & (cols[None, None, :] <= rows[:, :, None])
        keep = keep[:, None]                                      # [B,1,C,L]
    else:
        keep = keep[:, None, None, :]
    scores = torch.where(keep, scores, torch.full_like(scores, MASK_VALUE))
    probs = torch.softmax(scores, dim=-1)
    dead = ~keep.any(dim=-1)                                      # [B,?,C]
    probs = torch.where(dead[..., None], torch.zeros_like(probs), probs)
    probs = probs.reshape(b, h, c, n_pages, ps)
    ctx = torch.einsum("bhqps,hbpsd->bqhd", probs.to(v.dtype), v)
    return ctx.to(q.dtype)


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    """The C entry point, built and bound at first use."""
    from ._build import load_library

    lib = load_library(KERNEL_NAME)
    fn = lib.ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.ragged_paged_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_size_t
    return fn, smem


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"ragged_decode_attention (CUDA kernel): {what}")


def _ragged_cuda(q, pool, page_table, lengths, q_base, layer, n_layer,
                 causal, sm_scale, scales):
    """Validate and launch the CUDA kernel on the current stream."""
    dev = q.device
    _check(q.dim() == 4 and pool.dim() == 4 and page_table.dim() == 2,
           "q [B, C, H, D], pool [H, R, ps, D] and page_table [B, P] "
           "expected")
    b, c, h, d = q.shape
    ph, r, ps, pd = pool.shape
    _check((ph, pd) == (h, d), f"pool heads/width {(ph, pd)} != q's "
           f"{(h, d)}")
    _check(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    _check(pool.dtype in _POOL_DTYPES, f"pool dtype {pool.dtype} not in "
           f"{sorted(map(str, _POOL_DTYPES))}")
    _check(r % 2 == 0 and 0 <= layer < n_layer,
           "pool rows must pair K and V, and 0 <= layer < n_layer")
    _check(tuple(page_table.shape[:1]) == (b,) and lengths.shape == (b,)
           and q_base.shape == (b,), "page_table, lengths and q_base "
           "must have one row per lane")
    tensors = [q, pool, page_table, lengths, q_base]
    if pool.dtype == torch.int8:
        _check(scales is not None, "an int8 pool needs its scales")
        _check(scales.dtype == torch.float32
               and scales.numel() == r * ps, "scales must be float32 "
               f"[1, {r}, {ps}]")
        tensors.append(scales)
    else:
        _check(scales is None, "scales are only for int8 pools")
    for t in tensors:
        _check(t.device == dev, f"tensor on {t.device}, expected {dev}")
        _check(t.is_contiguous(), "inputs must be contiguous")
    for t in (page_table, lengths, q_base):
        _check(t.dtype == torch.int32, f"index tensors must be int32, "
               f"got {t.dtype}")
    fn, smem_fn = _kernel_fn()
    smem = smem_fn(c, ps, d)
    _check(smem <= _SMEM_LIMIT, f"needs {smem} bytes of shared memory per "
           f"block, sm_90 allows {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), pool.data_ptr(),
             scales.data_ptr() if scales is not None else None,
             page_table.data_ptr(), lengths.data_ptr(), q_base.data_ptr(),
             out.data_ptr(), b, c, h, r, ps, d, page_table.shape[1],
             int(layer), int(n_layer), int(bool(causal)), float(sm_scale),
             _POOL_DTYPES[pool.dtype], stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    ragged_decode_attention.launches += 1
    return out


def ragged_decode_attention(q, pool, page_table, lengths, q_base=None, *,
                            layer: int, n_layer: int, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            scales=None) -> torch.Tensor:
    """Attention of per-lane query blocks against a paged KV pool.

    Shapes:
        q           [B, C, H, D] float32 (C = 1 decode; C = chunk size
                                  during chunked prefill)
        pool        [H, R, page_size, D] float32 | bfloat16 | int8
        page_table  [B, P] int32 logical page ids (trash page 0 pads)
        lengths     [B]    int32 live KV positions per lane
        q_base      [B]    int32 global position of q[:, 0] (required
                                  when causal — masks key > base + j)
        scales      [1, R, page_size] float32 (int8 pools only)

    Returns ctx [B, C, H, D].  CUDA tensors go through the CUDA kernel
    (counted in ``ragged_decode_attention.launches``); CPU tensors
    through ``ragged_attention_plain``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if causal and q_base is None:
        raise ValueError("ragged_decode_attention: causal masking needs "
                         "q_base (global position of the first query)")
    if q_base is None:
        q_base = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return ragged_attention_plain(q, pool, page_table, lengths, q_base,
                                      layer, n_layer, causal,
                                      float(sm_scale), scales=scales)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: unsupported device "
                         f"{q.device}")
    return _ragged_cuda(q, pool, page_table, lengths, q_base, layer,
                        n_layer, causal, float(sm_scale), scales)


ragged_decode_attention.launches = 0     # kernel launches, CUDA path only
