"""The port's serving tensor functions against the JAX package, on the CPU.

* ``ragged_decode_attention``: the port's wrapper takes its plain PyTorch
  version for CPU tensors; it must agree with the JAX entry run through
  its XLA gather path and through the Pallas kernel in interpret mode
  (causal and not, C in {1, 4}, float32 / bfloat16 / int8 pools, a dead
  lane).  Everything computes in float32; the two sides differ only in
  summation order, so the tolerance is rtol = atol = 1e-5.
* the CUDA kernel's work split: ``ragged_plan`` covers every page once,
  and an emulation of the kernel's split-and-merge (per-split online
  softmax partials, then their log-sum-exp merge) agrees with the same
  JAX entry within the same 1e-5.
* the ``paged_cache_write`` and ``quantized_paged_cache_write`` op
  emitters (called with an attribute context, as the JAX emitters
  are), ``abs_max_scale`` and ``quantize_array``: bit for bit.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops import cache_ops as jax_cache_ops
from paddle_tpu.fluid.ops import quant_ops as jax_quant_ops
import paddle_tpu.kernels.flash_attention  # noqa: F401  (module, not the fn)
from paddle_tpu_torch.fluid.ops import cache_ops, quant_ops
from paddle_tpu_torch.kernels import flash_attention as fa

jax_fa = sys.modules["paddle_tpu.kernels.flash_attention"]

H, D, L, NPAGES, P, PS, B = 2, 4, 3, 6, 3, 4, 3
R = NPAGES * L * 2


class _Ctx:
    """The attribute surface a JAX op emitter reads."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _pool(kv_dtype, rng):
    """(numpy pool, numpy scales or None) with values every dtype holds
    exactly: bf16 values are rounded once, here, for both sides."""
    f = rng.randn(H, R, PS, D).astype(np.float32)
    if kv_dtype == "float32":
        return f, None
    if kv_dtype == "bfloat16":
        return np.asarray(jnp.asarray(f, jnp.bfloat16)), None
    q = rng.randint(-127, 128, (H, R, PS, D)).astype(np.int8)
    scales = (rng.rand(1, R, PS).astype(np.float32) + 0.5) / 127.0
    return q, scales


def _torch_pool(pool_np, kv_dtype):
    if kv_dtype == "bfloat16":
        return torch.from_numpy(pool_np.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(pool_np))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_ragged_attention_matches_jax(kv_dtype, c, causal, impl):
    rng = np.random.RandomState(3)
    pool_np, scales_np = _pool(kv_dtype, rng)
    q = rng.randn(B, c, H, D).astype(np.float32)
    tbl = rng.randint(0, NPAGES, (B, P)).astype(np.int32)
    lengths = np.array([7, 0, 11], np.int32)        # lane 1 is dead
    base = np.array([5, 0, 9], np.int32) if c == 1 else \
        np.array([3, 0, 7], np.int32)
    want = jax_fa.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool_np), jnp.asarray(tbl),
        jnp.asarray(lengths), jnp.asarray(base), layer=2, n_layer=L,
        causal=causal, impl=impl,
        scales=None if scales_np is None else jnp.asarray(scales_np))
    got = fa.ragged_decode_attention(
        torch.from_numpy(q), _torch_pool(pool_np, kv_dtype),
        torch.from_numpy(tbl), torch.from_numpy(lengths),
        torch.from_numpy(base), layer=2, n_layer=L, causal=causal,
        scales=None if scales_np is None else torch.from_numpy(scales_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert (got[1] == 0).all()                       # dead lane contract


def test_ragged_attention_cpu_path_never_launches_the_kernel():
    """CPU tensors take the plain version; the launch counter belongs to
    the CUDA path alone."""
    rng = np.random.RandomState(0)
    pool = torch.from_numpy(rng.randn(H, R, PS, D).astype(np.float32))
    before = fa.ragged_decode_attention.launches
    fa.ragged_decode_attention(
        torch.zeros(B, 1, H, D), pool, torch.ones(B, P, dtype=torch.int32),
        torch.full((B,), 5, dtype=torch.int32), causal=False, layer=0,
        n_layer=L)
    assert fa.ragged_decode_attention.launches == before
    with pytest.raises(ValueError, match="q_base"):
        fa.ragged_decode_attention(torch.zeros(B, 1, H, D), pool,
                                   torch.ones(B, P, dtype=torch.int32),
                                   torch.ones(B, dtype=torch.int32),
                                   layer=0, n_layer=L)


@pytest.mark.parametrize("shape", [
    # (B, H, P, sms)
    (8, 8, 16, 132),                     # serving prefill, decode cross
    (8, 8, 4, 132),                      # decode over self pages
    (4, 4, 6, 132),
    (4, 4, 198, 132),                    # three pages a split
    (33, 32, 6, 132),                    # one split
    (1, 1, 1, 1),
    (64, 16, 33, 132),                   # more (lane, head) pairs than SMs
    (2, 2, 1000, 132),
    (3, 5, 9, 7),
])
def test_ragged_plan_covers_every_page_once(shape):
    """The kernel's split s walks pages [s * pps, (s + 1) * pps): over
    ``splits`` splits that covers every page below P exactly once, with
    no split empty of table pages."""
    P = shape[2]
    pps, splits = fa.ragged_plan(*shape)
    assert 1 <= pps <= P and splits == -(-P // pps)
    pages = [pg for s in range(splits)
             for pg in range(s * pps, min((s + 1) * pps, P))]
    assert pages == list(range(P))
    assert (splits - 1) * pps < P


def _split_merge(q, pool, tbl, lengths, base, layer, n_layer, causal,
                 sm_scale, scales, pps):
    """The CUDA kernel's arithmetic in plain PyTorch (float32): split s of
    lane b walks its pages [s * pps, (s + 1) * pps) below the lane's
    length with an online softmax per page (raw K dotted with q, times
    the int8 scale and sm_scale; masked scores -1e9), leaving (m, l,
    kept, acc), or (-inf, 0, 0, -) past the length; the merge skips
    those, weights each split by exp(m_s - max m) and outputs 0 where no
    split kept a key."""
    h, _r, ps, d = pool.shape
    b, c = q.shape[0], q.shape[1]
    n_pages = tbl.shape[1]
    splits = -(-n_pages // pps)
    k_rows, v_rows = fa.paged_kv_rows(tbl, layer, n_layer)
    sc = None if scales is None else scales.reshape(-1, ps)
    out = torch.zeros(b, c, h, d)
    rows = torch.arange(c)
    for lane in range(b):
        length = int(lengths[lane])
        n_live = min(n_pages, -(-length // ps)) if length > 0 else 0
        for head in range(h):
            parts = []
            for s in range(splits):
                pg0, pg1 = s * pps, min((s + 1) * pps, n_live)
                if pg0 >= pg1:
                    parts.append((torch.full((c,), -float("inf")),
                                  torch.zeros(c), torch.zeros(c, dtype=bool),
                                  None))
                    continue
                m = torch.full((c,), -float("inf"))
                l = torch.zeros(c)
                kept = torch.zeros(c, dtype=bool)
                acc = torch.zeros(c, d)
                for pg in range(pg0, pg1):
                    kr, vr = int(k_rows[lane, pg]), int(v_rows[lane, pg])
                    kk = pool[head, kr].to(torch.float32)
                    vv = pool[head, vr].to(torch.float32)
                    x = q[lane, :, head] @ kk.T
                    if sc is not None:
                        x = x * sc[kr]
                    x = x * sm_scale
                    cols = pg * ps + torch.arange(ps)
                    keep = (cols[None, :] < length).expand(c, ps)
                    if causal:
                        keep = keep & (cols[None, :]
                                       <= int(base[lane]) + rows[:, None])
                    x = torch.where(keep, x, torch.tensor(-1e9))
                    m_new = torch.maximum(m, x.amax(dim=1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(x - m_new[:, None])
                    l = alpha * l + p.sum(dim=1)
                    if sc is not None:
                        p = p * sc[vr][None, :]
                    acc = acc * alpha[:, None] + p @ vv
                    kept |= keep.any(dim=1)
                    m = m_new
                parts.append((m, l, kept, acc))
            mx = torch.stack([p[0] for p in parts]).amax(dim=0)
            kept = torch.stack([p[2] for p in parts]).any(dim=0)
            l_all, a_all = torch.zeros(c), torch.zeros(c, d)
            for m_s, l_s, _k, a_s in parts:
                if a_s is None:
                    continue
                w = torch.exp(m_s - mx)
                l_all += w * l_s
                a_all += w[:, None] * a_s
            out[lane, :, head] = torch.where(
                kept[:, None], a_all / torch.where(kept, l_all, 1.0)[:, None],
                0.0)
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("pps", [1, 2, P])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_split_merge_emulation_matches_jax(kv_dtype, c, pps, impl):
    """The kernel's split-and-merge against the JAX entry, causal: lane 0
    ends mid-page, so at one page a split its last split starts past its
    length; lane 1 is dead; lane 2 uses all P pages to the last slot."""
    rng = np.random.RandomState(7)
    pool_np, scales_np = _pool(kv_dtype, rng)
    q = rng.randn(B, c, H, D).astype(np.float32)
    tbl = rng.randint(0, NPAGES, (B, P)).astype(np.int32)
    lengths = np.array([7, 0, P * PS], np.int32)
    base = np.maximum(lengths - c, 0).astype(np.int32)
    want = jax_fa.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(pool_np), jnp.asarray(tbl),
        jnp.asarray(lengths), jnp.asarray(base), layer=1, n_layer=L,
        causal=True, impl=impl,
        scales=None if scales_np is None else jnp.asarray(scales_np))
    got = _split_merge(
        torch.from_numpy(q), _torch_pool(pool_np, kv_dtype),
        torch.from_numpy(tbl), lengths, base, 1, L, True, D ** -0.5,
        None if scales_np is None else torch.from_numpy(scales_np), pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert (got[1] == 0).all()


def test_paged_kv_rows_matches_jax():
    tbl = np.random.RandomState(1).randint(0, 50, (4, 7)).astype(np.int32)
    for layer in range(L):
        jk, jv = jax_fa.paged_kv_rows(tbl, layer, L)
        tk, tv = fa.paged_kv_rows(torch.from_numpy(tbl), layer, L)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _write_inputs(rng, chunk):
    """A [B, C] write with lanes on distinct pages and dead positions on
    the trash page — but only one token per (row, slot) off page 0, so
    the result does not depend on the order duplicate writes land in."""
    k = (rng.randn(B, chunk, H, D) * 3).astype(np.float32)
    v = (rng.randn(B, chunk, H, D) * 3).astype(np.float32)
    pos = np.arange(chunk)
    pages = np.stack([1 + b * 2 + pos // PS for b in range(B)]) \
        .astype(np.int32)
    offsets = np.tile(pos % PS, (B, 1)).astype(np.int32)
    pages[1, chunk // 2:] = 0                          # dead tail
    offsets[1, chunk // 2:] = 0
    k[1, chunk // 2:] = 0.0                            # trash gets zeros
    v[1, chunk // 2:] = 0.0
    return k, v, pages, offsets


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_cache_write_bitwise(kv_dtype, chunk):
    rng = np.random.RandomState(chunk)
    k, v, pages, offsets = _write_inputs(rng, chunk)
    jdt = jnp.float32 if kv_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if kv_dtype == "float32" else torch.bfloat16
    want = jax_cache_ops.paged_cache_write(
        _Ctx(layer=1, n_layer=L), jnp.zeros((H, R, PS, D), jdt),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pages),
        jnp.asarray(offsets))
    pool = torch.zeros(H, R, PS, D, dtype=tdt)
    got = cache_ops.paged_cache_write(
        _Ctx(layer=1, n_layer=L), pool, torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(pages),
        torch.from_numpy(offsets))
    assert got is pool                                 # written in place
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("chunk", [1, 4])
def test_quantized_paged_cache_write_bitwise(chunk):
    rng = np.random.RandomState(10 + chunk)
    k, v, pages, offsets = _write_inputs(rng, chunk)
    k[0, 0] = 0.0                                      # zero block: scale 1
    want_pool, want_scales = jax_cache_ops.quantized_paged_cache_write(
        _Ctx(layer=2, n_layer=L), jnp.zeros((H, R, PS, D), jnp.int8),
        jnp.zeros((1, R, PS), jnp.float32), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pages), jnp.asarray(offsets))
    pool = torch.zeros(H, R, PS, D, dtype=torch.int8)
    scales = torch.zeros(1, R, PS)
    got_pool, got_scales = cache_ops.quantized_paged_cache_write(
        _Ctx(layer=2, n_layer=L), pool, scales, torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(pages),
        torch.from_numpy(offsets))
    assert got_pool is pool and got_scales is scales   # written in place
    np.testing.assert_array_equal(pool.numpy(), np.asarray(want_pool))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))


@pytest.mark.parametrize("axis", [None, 0, (0, 1), (1, 2)])
def test_quantize_bitwise(axis):
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 4, 5, 6) * 2).astype(np.float32)
    x[1] = 0.0                                         # zero channel
    x[0, 0, 0, :3] = [0.25, -0.75, 1.25]               # half-way at 0.5
    js = jax_quant_ops.abs_max_scale(jnp.asarray(x), axis)
    ts = quant_ops.abs_max_scale(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # exact halves on the grid: round half to even on both sides
    s = np.full_like(np.asarray(js), 0.5)
    jq = jax_quant_ops.quantize_array(jnp.asarray(x), jnp.asarray(s), axis)
    tq = quant_ops.quantize_array(torch.from_numpy(x), torch.from_numpy(s),
                                  axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    jq = jax_quant_ops.quantize_array(jnp.asarray(x), js, axis)
    tq = quant_ops.quantize_array(torch.from_numpy(x), ts, axis)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
