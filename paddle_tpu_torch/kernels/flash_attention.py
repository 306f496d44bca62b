"""Flash attention and ragged paged attention — the port of
``paddle_tpu/kernels/flash_attention.py``.

Training half.  ``flash_attention`` is the fused attention the
``fused_attention`` op calls: q/k/v in ``'blhd'`` ([B, L, H, D], the
Transformer's layout) or ``'bhld'``, an optional additive bias
[B|1, H|1, Lq, Lk], causal masking on global positions
(``block_offsets``), and attention-probability dropout from a
counter-based hash (``keep_scale``), so no [Lq, Lk] mask exists in either
direction.  Its gradient is a ``torch.autograd.Function``.  For CUDA
tensors the forward launches ``csrc/flash_attention_fwd.cu`` (the port of
the TPU kernel ``_fwd_kernel``) and the bias-free backward launches the
dq and dk/dv kernels of ``csrc/flash_attention_bwd.cu`` (the ports of
``_dq_kernel`` and ``_dkv_kernel``), dq first: in bf16 at D = 64 its
kernel forms delta = rowsum(out * dout) into a float32 buffer that the
dk/dv kernel reads.  A backward with a bias runs the plain backward on
every device, as the reference routes it.  For CPU
tensors ``flash_forward_plain`` / ``flash_backward_plain`` run, the
counterparts of the reference's ``_xla_forward`` / ``_xla_backward``.
The kernels are built for head widths 8, 16, 32 and 64, and for any
multiple of 64 above them (the wide kernels, in 64-column chunks); the
wrappers zero-pad every other width to the next of those and slice the
results back (exact: zero columns change no product).

Serving half.  ``decode_attention`` is the dense generator's attention
over its [B, L, H, D] caches, plain PyTorch (the reference's is XLA, not
a Pallas kernel).  The paged KV pool is ONE tensor ``[H, R, page_size, D]``
(head-major: one head's page is a contiguous ``page_size x D`` slab).  A
*logical* page spans every layer and both K and V of a page_size-token
span: physical row = ``(page * n_layer + layer) * 2`` (+1 for V).
Per-request block tables hold logical page ids; page 0 is the trash page
dead lanes write into.  ``ragged_decode_attention`` is the entry the
model calls: for a CUDA tensor it launches
``csrc/ragged_paged_attention.cu`` (the port of the TPU kernel
``_ragged_kernel``), whose page walk ``ragged_plan`` splits across
blocks (a second kernel merges the splits); for a CPU tensor it runs
``ragged_attention_plain``, the counterpart of the reference's
``_ragged_xla``.

Nothing falls back: on a CUDA tensor a wrapper launches its kernel or
raises.  Each wrapper counts its launches (``flash_attention.launches``,
and by input dtype ``flash_attention.launches_by_dtype``;
``ragged_decode_attention.launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

__all__ = ["decode_attention", "paged_kv_rows", "ragged_attention_plain",
           "ragged_decode_attention", "ragged_plan", "KERNEL_NAME",
           "FLASH_KERNELS",
           "DEFAULT_MASK_VALUE", "counter_hash", "keep_scale",
           "flash_attention",
           "flash_forward_plain", "flash_backward_plain"]

KERNEL_NAME = "ragged_paged_attention"
MASK_VALUE = -1e9          # the reference's masked-score value, exactly
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 232448       # dynamic shared memory one sm_90 block may use


def decode_attention(q, k_cache, v_cache, lengths,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """A decode step's attention over a preallocated KV cache: q [B, Lq,
    H, D] (Lq is 1 in steady decode) against k_cache / v_cache [B, Lmax,
    H, D], of which the first ``lengths[b]`` rows are live (the rest
    masked to -1e9).  Returns ctx [B, Lq, H, D].  The reference computes
    it with XLA, outside any Pallas kernel, so it is plain PyTorch on
    every device; scores and sums are fp32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    lmax = k_cache.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).to(torch.float32)
    scores = scores * sm_scale
    live = (torch.arange(lmax, dtype=torch.int32, device=q.device)[None, :]
            < lengths.to(torch.int32)[:, None])                # [B, Lmax]
    scores = torch.where(live[:, None, None, :], scores,
                         torch.full_like(scores, MASK_VALUE))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(v_cache.dtype), v_cache)
    return ctx.to(q.dtype)


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
    """The C entries, built and bound at first use: the kernel, its
    shared-memory size, and one empty launch (the timing floor)."""
    from ._build import load_library

    lib = load_library(KERNEL_NAME)
    fn = lib.ragged_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    smem = lib.ragged_paged_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_size_t
    empty = lib.ragged_paged_attention_empty_launch
    empty.argtypes = [ctypes.c_void_p]
    empty.restype = ctypes.c_int
    return fn, smem, empty


# blocks the ragged kernel's grid aims for, per SM: enough in flight
# that one block's page loads overlap others' arithmetic (at the serving
# shapes, one page a split)
RAGGED_BLOCKS_PER_SM = 8


def ragged_plan(B: int, H: int, P: int, sms: int):
    """The ragged kernel's page split -> ``(pages_per_split, splits)``;
    its grid is (split, head, lane).

    Split s of a (lane, head) walks pages [s * pps, (s + 1) * pps) of
    the lane's table (those below its length); ``splits = ceil(P /
    pps)`` covers every page below P exactly once.  Sized from what the
    host knows, never from the lengths (on the card in the serving step;
    reading them is a sync): as many splits as give RAGGED_BLOCKS_PER_SM
    blocks per SM over the B * H (lane, head) pairs, at most one a page.
    The chunk's rows, the page size and the pool's type do not enter."""
    if min(B, H, P, sms) < 1:
        raise ValueError(f"ragged_plan: sizes must be positive, got "
                         f"{(B, H, P, sms)}")
    want = -(-RAGGED_BLOCKS_PER_SM * sms // (B * H))
    pps = -(-P // min(P, want))
    return pps, -(-P // pps)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"ragged_decode_attention (CUDA kernel): {what}")


def _ragged_cuda(q, pool, page_table, lengths, q_base, layer, n_layer,
                 causal, sm_scale, scales):
    """Validate and launch the CUDA kernels on the current stream: the
    split kernel and, with more than one split, the merge kernel.  The
    ``(pages_per_split, splits)`` launched is kept in
    ``ragged_decode_attention.last_plan``."""
    dev = q.device
    _check(q.dim() == 4 and pool.dim() == 4 and page_table.dim() == 2,
           "q [B, C, H, D], pool [H, R, ps, D] and page_table [B, P] "
           "expected")
    b, c, h, d = q.shape
    ph, r, ps, pd = pool.shape
    n_pages = page_table.shape[1]
    _check((ph, pd) == (h, d), f"pool heads/width {(ph, pd)} != q's "
           f"{(h, d)}")
    _check(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    _check(pool.dtype in _POOL_DTYPES, f"pool dtype {pool.dtype} not in "
           f"{sorted(map(str, _POOL_DTYPES))}")
    _check(r % 2 == 0 and 0 <= layer < n_layer,
           "pool rows must pair K and V, and 0 <= layer < n_layer")
    _check(tuple(page_table.shape[:1]) == (b,) and lengths.shape == (b,)
           and q_base.shape == (b,) and n_pages > 0 and c > 0,
           "page_table, lengths and q_base must have one row per lane, "
           "the table a page and q a row")
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
    pps, splits = ragged_plan(b, h, n_pages, _sm_count(dev.index or 0))
    fn, smem_fn, _ = _kernel_fn()
    dtype = _POOL_DTYPES[pool.dtype]
    smem = smem_fn(c, ps, d, dtype)
    _check(smem <= _SMEM_LIMIT, f"needs {smem} bytes of shared memory per "
           f"block, sm_90 allows {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    # the splits' partials: acc [B, H, S, C, D], then m, l, kept
    ws = (torch.empty(b * h * splits * c * (d + 3), dtype=torch.float32,
                      device=dev) if splits > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), pool.data_ptr(),
             scales.data_ptr() if scales is not None else None,
             page_table.data_ptr(), lengths.data_ptr(), q_base.data_ptr(),
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             b, c, h, r, ps, d, n_pages, int(layer), int(n_layer),
             int(bool(causal)), float(sm_scale), pps, dtype, stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    ragged_decode_attention.launches += 1
    ragged_decode_attention.last_plan = (pps, splits)
    return out


def ragged_decode_attention(q, pool, page_table, lengths, q_base=None, *,
                            layer: int, n_layer: int, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            impl: Optional[str] = None,
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
    through ``ragged_attention_plain``; ``meta`` tensors (a program's
    shape inference) give an empty result of q's shape.  ``impl`` (the
    reference's pallas / xla switch) must be None: the device picks the
    route."""
    _check_impl("ragged_decode_attention", impl)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if causal and q_base is None:
        raise ValueError("ragged_decode_attention: causal masking needs "
                         "q_base (global position of the first query)")
    if q.device.type == "meta":         # build-time shape inference
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
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
ragged_decode_attention.last_plan = None  # (pages_per_split, splits)


def _check_impl(fn: str, impl) -> None:
    """The reference's ``impl`` picks its TPU kernel or XLA; here the
    tensors' device picks the route, so only None is honoured."""
    if impl is not None:
        raise NotImplementedError(
            f"{fn}: impl={impl!r} (the reference's pallas / xla switch) is "
            f"not ported; CUDA tensors run the CUDA kernel and CPU tensors "
            f"the plain version")


# ---------------------------------------------------------------------------
# Flash attention: the training path
# ---------------------------------------------------------------------------

# launch-count key -> kernel source under csrc/ (dq and dk/dv share one)
FLASH_KERNELS = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd",
                 "dkv": "flash_attention_bwd"}
# the reference's masked-score value: finite, so a row that sees only
# masked keys is recognised by its running max (m <= MASK / 2)
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths the kernels are built for: every width a configuration
# of the repo (d_key 8, 16, 32, 64) and the reference's kernel tests use;
# a wider head runs the wide kernels, which take any multiple of
# _WIDE_CHUNK as that many 64-column chunks
_FLASH_WIDTHS = (8, 16, 32, 64)
_WIDE_CHUNK = 64
_U32 = 0xFFFFFFFF


def _mul_u32(x, c: int):
    """``x * c`` modulo 2^32 for int64 (or Python int) ``x`` in [0, 2^32)
    and a constant ``c`` < 2^32.  The high and low 16 bits of ``x`` are
    multiplied apart (each product < 2^48), so int64 never overflows."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & _U32


def counter_hash(seed_u32, bh, rows, cols) -> torch.Tensor:
    """The 32 bits ``keep_scale`` draws at each (batch*head, row, col)
    position under a uint32 seed, as an int64 tensor in [0, 2^32): the
    murmur3-style finalizer, its uint32 arithmetic run in int64 masked
    to 32 bits after every multiply and xor."""

    def u32(t):
        return (t.to(torch.int64) if isinstance(t, torch.Tensor)
                else int(t)) & _U32

    rows, cols, bh, seed = u32(rows), u32(cols), u32(bh), u32(seed_u32)
    x = (_mul_u32(rows, 0x9E3779B1) + _mul_u32(cols, 0x85EBCA77)) & _U32
    x = x ^ _mul_u32(bh, 0xC2B2AE3D) ^ seed
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_scale(seed_u32, bh, rows, cols, rate: float) -> torch.Tensor:
    """Counter-based dropout mask of the reference (``keep_scale`` of
    paddle_tpu/kernels/flash_attention.py), bit for bit: a murmur3-style
    finalizer over the global (batch*head, row, col) position and a
    uint32 seed.  The reference's uint32 arithmetic wraps modulo 2^32;
    here it runs in int64 masked to 32 bits after every multiply and
    xor.  Inputs broadcast (at least one is a tensor); returns float32
    values in {0, 1/(1-rate)}.  ``seed_u32`` is an int or a 0-d integer
    tensor holding the seed's 32 bits (an int32 seed buffer's entry
    reads back as its uint32 value).  Python ints stay Python ints: a
    scalar made into a device tensor would cost a host-device copy, and
    with it a stream synchronisation, per call."""

    x = counter_hash(seed_u32, bh, rows, cols)
    # top 24 bits -> uniform [0, 1), compared with the rate rounded to
    # float32, as the reference compares
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    rate32 = torch.tensor(rate, dtype=torch.float32).item()
    return torch.where(u >= rate32, 1.0 / (1.0 - rate), 0.0).to(
        torch.float32)


def _bh_grid(b: int, h: int, device) -> torch.Tensor:
    """[b, h, 1, 1] flattened batch*head index, ``b_idx * h + h_idx`` —
    the kernels' blockIdx.y, so plain and kernel masks agree."""
    return (torch.arange(b, device=device)[:, None] * h
            + torch.arange(h, device=device)[None, :])[:, :, None, None]


def _bhld(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A [B, H, L, D] view ('blhd' <-> 'bhld' is its own inverse)."""
    return x.permute(0, 2, 1, 3) if layout == "blhd" else x


def _plain_scores(qh, kh, bias, causal, sm_scale, offsets):
    """fp32 scores [b, h, lq, lk] with bias and causal mask, and the
    global (rows, cols) positions."""
    lq, lk = qh.shape[2], kh.shape[2]
    rows = offsets[0] + torch.arange(lq, device=qh.device)
    cols = offsets[1] + torch.arange(lk, device=qh.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = s.masked_fill(rows[:, None] < cols[None, :], DEFAULT_MASK_VALUE)
    return s, rows, cols


def _plain_keep(qh, rows, cols, rate, seed):
    b, h = qh.shape[0], qh.shape[1]
    return keep_scale(seed, _bh_grid(b, h, qh.device), rows[:, None],
                      cols[None, :], rate)


def _flash_args(q, sm_scale, dropout_rate, dropout_seed, layout,
                block_offsets):
    if layout not in ("bhld", "blhd"):
        raise ValueError(f"unknown layout {layout!r}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    rate = float(dropout_rate)
    seed = None
    if rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        # an int, or a 0-d integer tensor read where it lies (no sync)
        seed = (dropout_seed if isinstance(dropout_seed, torch.Tensor)
                else int(dropout_seed) & _U32)
    offsets = (0, 0) if block_offsets is None else (
        int(block_offsets[0]), int(block_offsets[1]))
    return float(sm_scale), rate, seed, offsets


def flash_forward_plain(q, k, v, bias=None, causal=False, sm_scale=None,
                        dropout_rate=0.0, dropout_seed=None, layout="bhld",
                        block_offsets=None):
    """The forward in plain PyTorch, fp32 throughout: the counterpart of
    the reference's ``_xla_forward`` (one softmax over all keys instead of
    its blockwise scan; the two differ in summation order only).  Returns
    ``(out, lse)``: out in q's layout and dtype, lse [B, H, Lq] fp32.  A
    row with no live key outputs 0 with lse +inf."""
    sm_scale, rate, seed, offsets = _flash_args(
        q, sm_scale, dropout_rate, dropout_seed, layout, block_offsets)
    qh, kh, vh = (_bhld(x, layout) for x in (q, k, v))
    s, rows, cols = _plain_scores(qh, kh, bias, causal, sm_scale, offsets)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if rate > 0.0:
        # dropout on the unnormalised p; l keeps the full softmax sum
        p = p * _plain_keep(qh, rows, cols, rate, seed)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    dead = (l == 0.0) | (m <= DEFAULT_MASK_VALUE * 0.5)
    denom = torch.where(dead, 1.0, l)
    lse = torch.where(dead, float("inf"), m + torch.log(denom))
    out = torch.where(dead[..., None], 0.0, acc / denom[..., None])
    return _bhld(out.to(q.dtype), layout).contiguous(), lse


def flash_backward_plain(q, k, v, out, dout, lse, bias=None, causal=False,
                         sm_scale=None, dropout_rate=0.0, dropout_seed=None,
                         layout="bhld", block_offsets=None):
    """The backward in plain PyTorch: the counterpart of the reference's
    ``_xla_backward``.  p is recomputed from the saved lse, delta =
    rowsum(out * dout) uses the dropped output.  Returns
    ``(dq, dk, dv, dbias)``; dbias is None without a bias and is summed
    over the dimensions the bias broadcasts."""
    sm_scale, rate, seed, offsets = _flash_args(
        q, sm_scale, dropout_rate, dropout_seed, layout, block_offsets)
    qh, kh, vh, oh, doh = (_bhld(x, layout).float()
                           for x in (q, k, v, out, dout))
    s, rows, cols = _plain_scores(qh, kh, bias, causal, sm_scale, offsets)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    delta = (oh * doh).sum(dim=-1)
    if rate > 0.0:
        keep = _plain_keep(qh, rows, cols, rate, seed)
        dv = torch.einsum("bhqk,bhqd->bhkd", p * keep, doh)
        ds_raw = p * (keep * dp - delta[..., None])
    else:
        dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
        ds_raw = p * (dp - delta[..., None])
    ds = ds_raw * sm_scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh)
    dbias = None
    if bias is not None:
        if bias.shape[0] == 1:
            ds_raw = ds_raw.sum(dim=0, keepdim=True)
        if bias.shape[1] == 1:
            ds_raw = ds_raw.sum(dim=1, keepdim=True)
        dbias = ds_raw.to(bias.dtype)
    grads = [_bhld(g.to(x.dtype), layout).contiguous()
             for g, x in ((dq, q), (dk, k), (dv, v))]
    return (*grads, dbias)


@functools.lru_cache(maxsize=None)
def _flash_entry(name: str):
    """C entry ``name`` ("fwd", "dq" or "dkv") and its shared-memory size
    function, built and bound at first use."""
    from ._build import load_library

    lib = load_library(FLASH_KERNELS[name])
    fn = getattr(lib, f"flash_attention_{name}")
    n_ptrs = {"fwd": 6, "dq": 8, "dkv": 9}[name]
    head = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 \
        + [ctypes.c_longlong] * 6
    if name == "fwd":
        head += [ctypes.c_int] * 2             # bias extents
    fn.argtypes = head + [ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = getattr(lib, f"flash_attention_{name}_smem_bytes")
    smem.argtypes = [ctypes.c_int]
    smem.restype = ctypes.c_size_t
    return fn, smem


def _fcheck(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention (CUDA kernel): {what}")


def _kernel_width(d: int) -> int:
    """The head width the kernels launch with for a head of width ``d``:
    the narrowest built width (8, 16, 32, 64) that holds it, and above
    64 the next multiple of 64, which the wide kernels take as 64-column
    chunks."""
    for w in _FLASH_WIDTHS:
        if d <= w:
            return w
    return -(-d // _WIDE_CHUNK) * _WIDE_CHUNK


def _pad_width(xs, w: int):
    """Each tensor of ``xs`` zero-padded along its last (head) axis from
    the width they share to ``w``.  Exact for attention: a zero column
    adds nothing to q.k or to rowsum(out * dout), and the products over
    the kept columns are unchanged; the caller keeps the true width's
    sm_scale and slices the results back."""
    d = xs[0].shape[-1]
    _fcheck(all(x.shape[-1] == d for x in xs), "q, k, v (and out, dout) "
            "must share one head width")
    return tuple(torch.nn.functional.pad(x, (0, w - d)) for x in xs)


def _flash_geometry(q, k, v, layout, extra=()):
    """Validate the kernels' inputs; returns (B, H, Lq, Lk, D) and the
    element strides of q-shaped and k-shaped tensors.  q, k and v must
    start on a 16-byte boundary: the kernels copy their tiles in 16-byte
    pieces (cp.async), and a row of any built width (8 elements or more)
    is a whole number of them, so an aligned base aligns every row."""
    _fcheck(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
            "q, k, v must be 4-d and k, v of one shape")
    b, h, lq, d = _bhld(q, layout).shape
    kb, kh, lk, kd = _bhld(k, layout).shape
    _fcheck((kb, kh, kd) == (b, h, d), f"k/v batch, heads, width "
            f"{(kb, kh, kd)} != q's {(b, h, d)}")
    _fcheck(q.dtype in _FLASH_DTYPES, f"dtype {q.dtype} not float32 or "
            "bfloat16")
    if _kernel_width(d) != d:
        raise ValueError(f"flash_attention (CUDA kernel): head width {d} "
                         f"is not built (widths {_FLASH_WIDTHS} and "
                         f"multiples of {_WIDE_CHUNK}); pad it to "
                         f"{_kernel_width(d)}")
    for t in (q, k, v, *extra):
        _fcheck(t.device == q.device, f"tensor on {t.device}, expected "
                f"{q.device}")
        _fcheck(t.is_contiguous(), "inputs must be contiguous")
    for t in (k, v):
        _fcheck(t.dtype == q.dtype, "q, k, v must share one dtype")
    _check_aligned((("q", q), ("k", k), ("v", v)))

    def strides(l):
        return ((l * h * d, d, h * d) if layout == "blhd"
                else (h * l * d, l * d, d))

    return (b, h, lq, lk, d), strides(lq) + strides(lk)


_SEEDS: dict = {}          # (device, uint32 seed) -> its int32 tensor


def _device_seed(seed, device) -> Optional[torch.Tensor]:
    """The seed as the 0-d int32 tensor on ``device`` whose address the
    kernels read it from (None without dropout).  A tensor seed (the
    executor's seed buffer) is used where it lies; an int becomes a
    tensor filled by a kernel (no host copy, so no sync) and kept for the
    next call with that int; inside a CUDA graph capture a new one's
    fill is recorded with the call and not kept."""
    if seed is None:
        return None
    if isinstance(seed, torch.Tensor):
        _fcheck(seed.numel() == 1 and seed.device == device
                and not seed.is_floating_point(), f"dropout seed must be "
                f"one integer on {device}, got {seed.dtype} "
                f"{tuple(seed.shape)} on {seed.device}")
        return seed.reshape(()) if seed.dtype == torch.int32 \
            else seed.reshape(()).to(torch.int32)
    bits = seed - (1 << 32) if seed >= 1 << 31 else seed
    key = (device, seed)
    t = _SEEDS.get(key)
    if t is None and torch.cuda.is_current_stream_capturing():
        return torch.full((), bits, dtype=torch.int32, device=device)
    if t is None:
        if len(_SEEDS) >= 64:
            _SEEDS.clear()
        t = _SEEDS[key] = torch.full((), bits, dtype=torch.int32,
                                     device=device)
    return t


def _check_aligned(named) -> None:
    for name, t in named:
        _fcheck(t.data_ptr() % 16 == 0, f"{name} must start on a 16-byte "
                f"boundary, its address is {t.data_ptr():#x}")


def _flash_launch(name: str, d: int, dtype: torch.dtype, *args) -> None:
    fn, smem_fn = _flash_entry(name)
    smem = smem_fn(d)
    _fcheck(smem <= _SMEM_LIMIT, f"{name} needs {smem} bytes of shared "
            f"memory per block, sm_90 allows {_SMEM_LIMIT}")
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention {name} launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches[name] += 1
    flash_attention.launches_by_dtype[str(dtype).removeprefix("torch.")][
        name] += 1


def _flash_fwd_cuda(q, k, v, bias, causal, sm_scale, rate, seed, layout,
                    offsets):
    """Launch the forward kernel on the current stream -> (out, lse)."""
    d = q.shape[-1]
    w = _kernel_width(d)
    if w != d:
        out, lse = _flash_fwd_cuda(*_pad_width((q, k, v), w), bias, causal,
                                   sm_scale, rate, seed, layout, offsets)
        return out[..., :d].contiguous(), lse
    extra = () if bias is None else (bias,)
    (b, h, lq, lk, d), strides = _flash_geometry(q, k, v, layout, extra)
    bias_b = bias_h = 1
    if bias is not None:
        _fcheck(bias.dtype == torch.float32 and bias.dim() == 4,
                "bias must be float32 [B|1, H|1, Lq, Lk]")
        bias_b, bias_h = bias.shape[0], bias.shape[1]
        _fcheck(bias_b in (1, b) and bias_h in (1, h)
                and tuple(bias.shape[2:]) == (lq, lk),
                f"bias shape {tuple(bias.shape)} does not broadcast to "
                f"{(b, h, lq, lk)}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if b * h * lq == 0:
        return out, lse
    if lk == 0:
        # no keys: every row is dead (out 0, lse +inf), as the kernels
        # write a dead row; the bf16 D = 64 kernel's tensor maps take no
        # empty k or v
        return out.zero_(), lse.fill_(float("inf"))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    seed_t = _device_seed(seed, q.device) if rate > 0.0 else None
    _flash_launch("fwd", d, q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), b, h, lq, lk, d, *strides, bias_b, bias_h,
                  sm_scale, int(causal), offsets[0], offsets[1], rate,
                  1.0 / (1.0 - rate),
                  None if seed_t is None else seed_t.data_ptr(),
                  _FLASH_DTYPES[q.dtype], stream)
    return out, lse


def _flash_bwd_setup(q, k, v, out, dout, lse, causal, sm_scale, rate,
                     seed, layout, offsets):
    """Validate the backward's inputs -> (D, the C arguments the dq and
    dk/dv entries share after their pointers, the input pointers).  The
    seed goes as the address of an int32 on the card (``_device_seed``;
    an int seed's tensor stays in ``_SEEDS`` past the launch)."""
    (b, h, lq, lk, d), strides = _flash_geometry(q, k, v, layout,
                                                 (out, dout, lse))
    _fcheck(out.shape == q.shape and dout.shape == q.shape
            and out.dtype == q.dtype and dout.dtype == q.dtype,
            "out and dout must match q's shape and dtype")
    _fcheck(lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, lq),
            f"lse must be float32 {(b, h, lq)}")
    _fcheck(b * h * lq * lk > 0, "empty attention")
    _check_aligned((("out", out), ("dout", dout)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    seed_t = _device_seed(seed, q.device) if rate > 0.0 else None
    common = (b, h, lq, lk, d, *strides, sm_scale, int(causal), offsets[0],
              offsets[1], rate, 1.0 / (1.0 - rate),
              None if seed_t is None else seed_t.data_ptr(),
              _FLASH_DTYPES[q.dtype], stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr())
    return d, common, ins


def _flash_dq_cuda(q, k, v, out, dout, lse, delta, *cfg):
    """Launch the dq kernel on the current stream -> dq.  ``delta`` is
    float32 scratch shaped like ``lse``: the bf16 D = 64 kernel writes
    rowsum(out * dout) there for the dk/dv launch after it."""
    d = q.shape[-1]
    w = _kernel_width(d)
    if w != d:
        padded = _pad_width((q, k, v, out, dout), w)
        dq = _flash_dq_cuda(*padded, lse, delta, *cfg)
        return dq[..., :d].contiguous()
    d, common, ins = _flash_bwd_setup(q, k, v, out, dout, lse, *cfg)
    _check_delta(delta, lse)
    dq = torch.empty_like(q)
    _flash_launch("dq", d, q.dtype, *ins, delta.data_ptr(), dq.data_ptr(),
                  *common)
    return dq


def _flash_dkv_cuda(q, k, v, out, dout, lse, delta, *cfg):
    """Launch the dk/dv kernel on the current stream -> (dk, dv).  At bf16
    D = 64 it reads ``delta`` as a dq launch on the same inputs wrote
    it."""
    d = q.shape[-1]
    w = _kernel_width(d)
    if w != d:
        padded = _pad_width((q, k, v, out, dout), w)
        return tuple(g[..., :d].contiguous()
                     for g in _flash_dkv_cuda(*padded, lse, delta, *cfg))
    d, common, ins = _flash_bwd_setup(q, k, v, out, dout, lse, *cfg)
    _check_delta(delta, lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_launch("dkv", d, q.dtype, *ins, delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *common)
    return dk, dv


def _check_delta(delta, lse) -> None:
    _fcheck(delta.dtype == torch.float32 and delta.shape == lse.shape
            and delta.device == lse.device and delta.is_contiguous(),
            f"delta must be contiguous float32 {tuple(lse.shape)} on "
            f"{lse.device}")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel (or plain forward on the CPU) saving (out, lse);
    backward kernels (or the plain backward)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cfg):
        causal, sm_scale, rate, seed, layout, offsets = cfg
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, bias, *cfg)
        else:
            out, lse = flash_forward_plain(
                q, k, v, bias, causal, sm_scale, rate, seed, layout,
                offsets)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, sm_scale, rate, seed, layout, offsets = ctx.cfg
        if q.is_cuda and bias is None:
            # dq first: at bf16 D = 64 its kernel forms delta for dk/dv's
            args = (q, k, v, out, dout.contiguous(), lse,
                    torch.empty_like(lse), *ctx.cfg)
            dq = _flash_dq_cuda(*args)
            return (dq, *_flash_dkv_cuda(*args), None, None)
        # with a bias the reference has no backward kernel either
        # (_use_pallas_bwd routes it to _xla_backward, which also yields
        # dbias): the plain backward is its routing, on every device
        dq, dk, dv, dbias = flash_backward_plain(
            q, k, v, out, dout, lse, bias, causal, sm_scale, rate, seed,
            layout, offsets)
        return dq, dk, dv, dbias, None


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    impl: Optional[str] = None,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    layout: str = "bhld",
                    block_offsets=None) -> torch.Tensor:
    """Fused attention, differentiable.  layout='bhld': q [B, H, Lq, D],
    k/v [B, H, Lk, D]; layout='blhd': q [B, Lq, H, D] etc.  Optional
    additive bias [B|1, H|1, Lq, Lk].  ``dropout_rate`` > 0 drops
    attention probabilities with the hash mask keyed on
    ``dropout_seed`` (a uint32 int, or a 0-d integer tensor holding its
    bits on q's device, which the kernels read on the card: a CUDA graph
    replays such a call with the tensor's value at replay); same seed,
    same mask.  ``block_q`` / ``block_k`` (the reference's Pallas tile
    sizes) are accepted and ignored: the CUDA kernels' tiles are their
    own constants.  ``impl`` must be None (the device picks the route).
    ``block_offsets=(row_off, col_off)`` place q and k/v at global
    positions for the causal mask and the hash.  Rows with no live key
    return 0.

    CUDA tensors launch the forward kernel, and the dq and dk/dv kernels
    in the bias-free backward (counted in ``flash_attention.launches``);
    CPU tensors run the plain versions.  On ``meta`` tensors (build-time
    shape inference) it returns an empty output and launches nothing."""
    _check_impl("flash_attention", impl)
    if bias is not None and bias.dim() != 4:
        raise ValueError(f"bias must be 4-d, got {tuple(bias.shape)}")
    sm_scale, rate, seed, offsets = _flash_args(
        q, sm_scale, dropout_rate, dropout_seed, layout, block_offsets)
    if q.device.type == "meta":
        return torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                           device="meta")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bias, (bool(causal), sm_scale,
                                                 rate, seed, layout,
                                                 offsets))


# kernel launches per kernel, and per input dtype, CUDA path only
flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
flash_attention.launches_by_dtype = {
    dt: {"fwd": 0, "dq": 0, "dkv": 0} for dt in ("float32", "bfloat16")}
