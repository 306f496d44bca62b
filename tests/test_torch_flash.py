"""The port's flash attention (training half) against the JAX package.

The port's plain forward and backward are what the CUDA kernels are held
against on the card, so here they are held against the reference: its
``xla`` path and its Pallas kernels in interpret mode, on the same numpy
inputs.  Tolerances: both sides compute in float32 and differ in
summation order only (one softmax over all keys against the reference's
blockwise online softmax, 8-wide dot products), so 2e-5 absolute on
outputs of magnitude ~1 and 1e-4 on gradients; dropout masks are
compared exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.kernels.flash_attention as tfa
import tune_flash_bwd

# the module itself: paddle_tpu.kernels re-exports a function of its name
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def qkv(b=2, h=2, lq=16, lk=16, d=8, layout="bhld", seed=0):
    rng = np.random.RandomState(seed)

    def shape(l):
        return (b, l, h, d) if layout == "blhd" else (b, h, l, d)

    return (rng.randn(*shape(lq)).astype(np.float32),
            rng.randn(*shape(lk)).astype(np.float32),
            rng.randn(*shape(lk)).astype(np.float32))


def bias_of(kind, b, h, lq, lk, seed=1):
    if kind is None:
        return None
    rng = np.random.RandomState(seed)
    shape = {"b1": (b, 1, lq, lk), "1h": (1, h, lq, lk)}[kind]
    return rng.randn(*shape).astype(np.float32)


def T(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def test_keep_scale_bitwise():
    rng = np.random.RandomState(3)
    for rate in (0.1, 0.5):
        seed = int(rng.randint(0, 2**32, dtype=np.uint64))
        rows = rng.randint(0, 2**20, (64, 1)).astype(np.int32)
        cols = rng.randint(0, 2**20, (1, 48)).astype(np.int32)
        bh = rng.randint(0, 4096, (64, 48)).astype(np.int32)
        want = np.asarray(jfa.keep_scale(jnp.uint32(seed), jnp.asarray(bh),
                                         jnp.asarray(rows),
                                         jnp.asarray(cols), rate))
        got = tfa.keep_scale(seed, T(bh), T(rows), T(cols), rate).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < (got == 0).mean() < 1


CASES = [
    # (layout, causal, bias, dropout, lq, lk, block, offsets)
    ("bhld", False, None, 0.0, 16, 16, None, None),
    ("bhld", True, None, 0.0, 16, 16, None, None),
    ("blhd", True, None, 0.0, 16, 16, None, None),
    ("blhd", False, "b1", 0.0, 16, 16, None, None),
    ("bhld", False, "1h", 0.0, 16, 24, None, None),
    ("blhd", True, None, 0.2, 16, 16, None, None),
    ("bhld", False, "b1", 0.2, 16, 16, None, None),
    ("blhd", False, None, 0.0, 20, 13, 8, None),       # ragged lengths
    ("bhld", True, None, 0.0, 16, 16, 8, (0, 16)),     # every row dead
    ("bhld", True, None, 0.0, 16, 16, 8, (0, 8)),      # half the rows dead
]


def _jax_forward(q, k, v, bias, causal, rate, layout, block, offsets,
                 impl):
    kw = dict(bias=None if bias is None else jnp.asarray(bias),
              causal=causal, dropout_rate=rate,
              dropout_seed=11 if rate else None, layout=layout,
              block_offsets=offsets, impl=impl)
    if block:
        kw.update(block_q=block, block_k=block)
    return np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), **kw))


def _port_forward(q, k, v, bias, causal, rate, layout, offsets):
    return tfa.flash_forward_plain(
        T(q), T(k), T(v), T(bias), causal, dropout_rate=rate,
        dropout_seed=11 if rate else None, layout=layout,
        block_offsets=offsets)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_forward_and_lse_match_reference(case):
    layout, causal, bias_kind, rate, lq, lk, block, offsets = case
    q, k, v = qkv(lq=lq, lk=lk, layout=layout)
    bias = bias_of(bias_kind, 2, 2, lq, lk)
    out, lse = _port_forward(q, k, v, bias, causal, rate, layout, offsets)
    for impl in ("xla", "pallas_interpret"):
        want = _jax_forward(q, k, v, bias, causal, rate, layout, block,
                            offsets, impl)
        np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)
    # the reference's own (out, lse) pair
    sw = (lambda x: np.swapaxes(x, 1, 2)) if layout == "blhd" else (
        lambda x: x)
    off = None if offsets is None else jfa.offsets_carrier(*offsets)
    seed = jfa.seed_to_carrier(11) if rate else 0.0
    _, want_lse = jfa._xla_forward(
        jnp.asarray(sw(q)), jnp.asarray(sw(k)), jnp.asarray(sw(v)),
        None if bias is None else jnp.asarray(bias), seed, off,
        q.shape[-1] ** -0.5, causal, None, lk, rate)
    want_lse = np.asarray(want_lse)
    dead = np.isinf(want_lse)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), dead)
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead],
                               **OUT_TOL)
    if offsets == (0, 16):
        assert dead.all() and not out.numpy().any()


@pytest.fixture
def pallas_bwd(monkeypatch):
    """Route the reference's bias-free backward through its dq/dkv Pallas
    kernels at these tiny shapes (it keeps its XLA backward below
    PALLAS_BWD_MIN_L)."""
    monkeypatch.setattr(jfa, "PALLAS_BWD_MIN_L", 0)


GRAD_CASES = [
    # (layout, causal, bias, dropout, lq, lk)
    ("blhd", False, None, 0.0, 16, 16),
    ("blhd", True, None, 0.0, 16, 16),
    ("bhld", True, None, 0.2, 16, 16),
    ("blhd", False, None, 0.2, 16, 24),
    ("bhld", False, "b1", 0.0, 16, 16),
    ("blhd", True, "1h", 0.2, 16, 16),
]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_grads_match_reference(case, pallas_bwd):
    layout, causal, bias_kind, rate, lq, lk = case
    q, k, v = qkv(lq=lq, lk=lk, layout=layout, seed=5)
    bias = bias_of(bias_kind, 2, 2, lq, lk)
    rng = np.random.RandomState(9)
    w = rng.randn(*q.shape).astype(np.float32)   # a weighted cotangent
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=11 if rate else None, layout=layout)

    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    tb = None if bias is None else T(bias).requires_grad_(True)
    out = tfa.flash_attention(tq, tk, tv, bias=tb, **kw)
    (out * T(w)).sum().backward()
    got = [tq.grad, tk.grad, tv.grad] + ([] if tb is None else [tb.grad])

    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is not None:
        args.append(jnp.asarray(bias))
    argnums = tuple(range(len(args)))
    for impl in ("xla", "pallas_interpret"):
        def loss(*a):
            b_ = a[3] if len(a) > 3 else None
            return (jfa.flash_attention(*a[:3], bias=b_, impl=impl, **kw)
                    * w).sum()

        want = jax.grad(loss, argnums=argnums)(*args)
        for g, wg in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wg),
                                       **GRAD_TOL)


def test_meta_tensors_launch_nothing():
    """Build-time shape inference runs the op on meta tensors: the wrapper
    returns the output shape and counts no launch."""
    before = dict(tfa.flash_attention.launches)
    q = torch.empty(3, 10, 2, 64, device="meta")
    out = tfa.flash_attention(q, q, q, causal=True, layout="blhd",
                              dropout_rate=0.1, dropout_seed=1)
    assert out.shape == q.shape and out.device.type == "meta"
    assert tfa.flash_attention.launches == before


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before any build or launch, so they are testable
    without a card.  A width below 64 that is not built reaches the
    kernels only padded (test_padded_width_is_exact)."""
    q = torch.zeros(1, 4, 2, 48)
    with pytest.raises(ValueError, match="head width 48 .* pad it to 64"):
        tfa._flash_geometry(q, q, q, "blhd")
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="dtype"):
        tfa._flash_geometry(q.double(), q.double(), q.double(), "blhd")
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(1, 2)
        tfa._flash_geometry(qt, qt, qt, "bhld")


@pytest.mark.parametrize("d", [8, 16, 32, 64, 80, 128])
def test_kernel_head_widths(d):
    """The kernels are built for D = 8, 16, 32 and 64, every width the
    repo's configurations and the reference's kernel tests use, and take
    any multiple of 64 above them as 64-column chunks (the wide kernels).
    A wider head launches at the next multiple of 64 (80 and 128 both at
    128, two chunks) with the strides of that width; the unpadded 80 is
    refused by the geometry check, which the wrappers only reach padded."""
    b, h, lq, lk = 1, 2, 4, 4
    w = tfa._kernel_width(d)
    assert w == (d if d <= 64 else 128)
    q = torch.zeros(b, lq, h, d)
    k = torch.zeros(b, lk, h, d)
    if w != d:
        with pytest.raises(ValueError, match=f"head width {d} .* pad it "
                           f"to {w}"):
            tfa._flash_geometry(q, k, k, "blhd")
        q, k = tfa._pad_width((q, k), w)
    dims, strides = tfa._flash_geometry(q, k, k, "blhd")
    assert dims == (b, h, lq, lk, w)
    assert strides == (lq * h * w, w, h * w, lk * h * w, w, h * w)
    assert (w // tfa._WIDE_CHUNK if w > 64 else 1) == (2 if d > 64 else 1)


@pytest.mark.parametrize("d", [24, 40])
def test_padded_width_is_exact(d):
    """A width the kernels are not built for is zero-padded to the next
    built one (24 -> 32, 40 -> 64) with the true width's sm_scale, and
    the results sliced back.  Through the plain versions on the padded
    tensors, out, lse, dq, dk and dv equal the unpadded results within
    1e-6: zero columns add nothing to q.k or rowsum(out * dout)."""
    w = tfa._kernel_width(d)
    assert w == {24: 32, 40: 64}[d]
    r = np.random.RandomState(d)
    q, k, v, dout = (torch.tensor(r.randn(2, 40, 2, d).astype(np.float32))
                     for _ in range(4))
    cfg = (True, d ** -0.5, 0.1, 11, "blhd")
    out, lse = tfa.flash_forward_plain(q, k, v, None, *cfg)
    want = tfa.flash_backward_plain(q, k, v, out, dout, lse, None, *cfg)[:3]
    pq, pk, pv = tfa._pad_width((q, k, v), w)
    assert pq.shape[-1] == w and not pq[..., d:].any()
    p_out, p_lse = tfa.flash_forward_plain(pq, pk, pv, None, *cfg)
    assert not p_out[..., d:].any()
    # the backward's wrapper pads what autograd hands it: the sliced out
    pads = tfa._pad_width((q, k, v, p_out[..., :d], dout), w)
    got = tfa.flash_backward_plain(*pads, p_lse, None, *cfg)[:3]
    tol = dict(atol=1e-6, rtol=0)
    torch.testing.assert_close(p_out[..., :d], out, **tol)
    torch.testing.assert_close(p_lse, lse, **tol)
    for g, wg in zip(got, want):
        assert not g[..., d:].any()
        torch.testing.assert_close(g[..., :d], wg, **tol)


def test_backward_wrapper_refuses_unaligned_tensors():
    """The backward kernels copy tiles in 16-byte pieces: a tensor that
    is contiguous but starts off a 16-byte boundary is refused before any
    launch."""
    good = torch.zeros(1, 4, 2, 64)
    lse = torch.zeros(1, 2, 4)
    q = torch.zeros(good.numel() + 1)[1:].view(good.shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == 4
    cfg = (False, 0.125, 0.0, 0, "blhd", (0, 0))
    for i in range(5):
        args = [good] * 5
        args[i] = q
        with pytest.raises(ValueError, match="16-byte"):
            tfa._flash_bwd_setup(*args, lse, *cfg)


# -- the kernels' arithmetic: products on TF32 tensor cores

# chip_smoke.py's FLASH_TOL["float32"]: kernel vs plain on the card
FLASH_TOL_F32 = 1e-4


def _tf32(a):
    """Round float32 to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, keeping 10 mantissa bits (the low 13 bits zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a):
    """a ~ hi + lo as the kernel splits it: hi rounded, the exact rest
    a - hi truncated to TF32 (its low 13 bits cleared)."""
    hi = _tf32(a)
    return hi, ((a - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(h, w):
    (hh, hl), (wh, wl) = _split(h), _split(w)
    return (torch.matmul(hh, wh)
            + (torch.matmul(hh, wl) + torch.matmul(hl, wh)))


def _mm_tf32(h, w):
    return torch.matmul(_tf32(h), _tf32(w))


def _backward_with(mm, q, k, v, out, dout, lse, causal, rate, seed):
    """The dq and dk/dv kernels' arithmetic on [B, H, L, D] float32
    tensors, every product through ``mm``: s = q.k^T and dp = do.v^T,
    p = exp(s * scale - lse) under the mask, ds = p * (dp * keep -
    delta) * scale, then dq = ds.k, dk = ds^T.q, dv = (p * keep)^T.do."""
    sm_scale = q.shape[-1] ** -0.5
    lq, lk = q.shape[2], k.shape[2]
    rows, cols = torch.arange(lq), torch.arange(lk)
    s = mm(q, k.transpose(-1, -2)) * sm_scale
    if causal:
        s = s.masked_fill(rows[:, None] < cols[None, :],
                          tfa.DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    dp = mm(dout, v.transpose(-1, -2))
    keep = tfa._plain_keep(q, rows, cols, rate, seed)
    delta = (out * dout).sum(dim=-1)
    ds = p * (dp * keep - delta[..., None]) * sm_scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm((p * keep).transpose(-1, -2), dout))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_3xtf32_backward_holds_the_fp32_tolerance_and_tf32_does_not(
        causal):
    """The backward kernels split each product's operands into two TF32
    parts and sum three tensor-core products.  At B=2, H=2, L=256, D=64
    with dropout 0.1 that keeps dq, dk and dv within chip_smoke's float32
    tolerance (1e-4 of max(1, magnitude)) of the plain backward; a single
    TF32 product does not, which is why the kernels split."""
    r = np.random.RandomState(7)
    q, k, v, dout = (torch.tensor(r.randn(2, 2, 256, 64).astype(np.float32))
                     for _ in range(4))
    rate, seed = 0.1, 11
    cfg = (causal, None, rate, seed, "bhld")
    out, lse = tfa.flash_forward_plain(q, k, v, None, *cfg)
    want = tfa.flash_backward_plain(q, k, v, out, dout, lse, None, *cfg)[:3]
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32)):
        got = _backward_with(mm, q, k, v, out, dout, lse, causal, rate, seed)
        errs[name] = [float((g - w).abs().max()) / max(1.0, float(
            w.abs().max())) for g, w in zip(got, want)]
    print(f"max |error| / max(1, magnitude) of dq, dk, dv: {errs}")
    assert max(errs["3xtf32"]) <= FLASH_TOL_F32, errs
    assert max(errs["tf32"]) > FLASH_TOL_F32, errs


def _forward_with(mm, q, k, v, causal, rate, seed, tile=64):
    """The forward kernel's arithmetic on [B, H, L, D] float32 tensors:
    an online softmax over ``tile``-key tiles, s = q.k^T through ``mm``,
    scaled and masked; m, l and the accumulator rescaled by alpha; p
    dropped by keep_scale after it enters l; o += p.v through ``mm``.
    Returns (out, lse)."""
    sm_scale = q.shape[-1] ** -0.5
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq)
    m = torch.full(q.shape[:3], -float("inf"))
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, lk, tile):
        cols = torch.arange(k0, min(k0 + tile, lk))
        kt, vt = k[:, :, cols], v[:, :, cols]
        s = mm(q, kt.transpose(-1, -2)) * sm_scale
        if causal:
            s = s.masked_fill(rows[:, None] < cols[None, :],
                              tfa.DEFAULT_MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        p = p * tfa._plain_keep(q, rows, cols, rate, seed)
        acc = acc * alpha[..., None] + mm(p, vt)
        m = m_new
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_3xtf32_forward_holds_the_fp32_tolerance(causal):
    """The forward kernel computes s = q.k^T and o += p.v as three TF32
    products each.  Emulated at B=2, H=2, L=256, D=64 with dropout 0.1,
    it stays within chip_smoke's float32 tolerance (1e-4 of max(1,
    magnitude)) of the reference's Pallas forward in interpret mode (out)
    and its XLA forward (lse), on the same numpy inputs.  The error of a
    single TF32 product is printed beside it."""
    r = np.random.RandomState(8)
    q, k, v = (r.randn(2, 2, 256, 64).astype(np.float32) for _ in range(3))
    rate, seed = 0.1, 11
    want_out = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        dropout_rate=rate, dropout_seed=seed, layout="bhld",
        impl="pallas_interpret"))
    _, want_lse = jfa._xla_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        jfa.seed_to_carrier(seed), None, 64 ** -0.5, causal, None, 256,
        rate)
    want = (want_out, np.asarray(want_lse))
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32)):
        got = _forward_with(mm, T(q), T(k), T(v), causal, rate, seed)
        errs[name] = [float(np.abs(g.numpy() - w).max()) / max(
            1.0, float(np.abs(w).max())) for g, w in zip(got, want)]
    print(f"max |error| / max(1, magnitude) of out, lse: {errs}")
    assert max(errs["3xtf32"]) <= FLASH_TOL_F32, errs


# chip_smoke.py's FLASH_TOL["bfloat16"]: kernel vs plain on the card
FLASH_TOL_BF16 = 2e-2


def _bf16_forward(q, k, v, causal, rate, seed, tile=64, part=32):
    """The bf16 forward kernels' arithmetic (fwd_wg_kernel at D = 64) on
    [B, H, L, D] bf16 tensors: s = q.k^T as fp32 sums of products of bf16
    values (exact in fp32), the online softmax over ``tile``-key tiles in
    base 2 (the max over the unscaled scores, p = 2^(s * scale * log2 e -
    m)), l the fp32 sum of the unrounded p, p * keep_scale rounded to
    bf16 before p.v, p.v summed ``part`` keys a fresh partial and added
    to the accumulator in fp32; out rounded to bf16.  Returns (out,
    lse)."""
    log2e = 1.4426950408889634
    scale = q.shape[-1] ** -0.5 * log2e
    qf, kf, vf = (x.float() for x in (q, k, v))
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq)
    m = torch.full(q.shape[:3], -float("inf"))
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, lk, tile):
        cols = torch.arange(k0, min(k0 + tile, lk))
        s = torch.matmul(qf, kf[:, :, cols].transpose(-1, -2))
        if causal:
            s = s.masked_fill(rows[:, None] < cols[None, :], -float("inf"))
        m_new = torch.maximum(m, s.amax(dim=-1) * scale)
        m_sub = torch.where(torch.isinf(m_new), 0.0, m_new)
        alpha = torch.exp2(m - m_sub)
        p = torch.exp2(s * scale - m_sub[..., None])
        l = alpha * l + p.sum(dim=-1)
        p = (p * tfa._plain_keep(q, rows, cols, rate, seed)).to(
            torch.bfloat16).float()
        vt = vf[:, :, cols]
        pv = sum(torch.matmul(p[..., c:c + part], vt[:, :, c:c + part])
                 for c in range(0, len(cols), part))
        acc = acc * alpha[..., None] + pv
        m = m_new
    return ((acc / l[..., None]).to(torch.bfloat16),
            m / log2e + torch.log(l))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_forward_rounds_p_as_the_reference(causal):
    """The bf16 forward kernels take bf16 products with fp32 sums and
    round the dropped probabilities to bf16 before p.v, as the
    reference's Pallas kernel does (``pd.astype(v.dtype)``).  Emulated at
    B=2, H=2, L=256, D=64 with dropout 0.1 on bf16 inputs, the output is
    held:
      * against the reference's Pallas forward in interpret mode on the
        same bf16 inputs, which rounds p the same way: within one bf16
        ulp of the output's largest magnitude, since the two differ only
        in summation order and tile boundaries (a term or an output near
        a rounding boundary lands on the other side);
      * against the port's plain forward (fp32 p, the card's reference):
        within chip_smoke's FLASH_TOL["bfloat16"] of max(1, magnitude),
        the tolerance the kernel is held to there.
    The lse, which sums the unrounded p in fp32 on both sides, is held
    to the plain forward's within 1e-5 of its magnitude (fp32 summation
    order)."""
    r = np.random.RandomState(9)
    q, k, v = (torch.tensor(r.randn(2, 2, 256, 64).astype(np.float32)).to(
        torch.bfloat16) for _ in range(3))
    rate, seed = 0.1, 11
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                  for x in (q, k, v))
    want = np.asarray(jfa.flash_attention(
        jq, jk, jv, causal=causal, dropout_rate=rate, dropout_seed=seed,
        layout="bhld", impl="pallas_interpret")).astype(np.float32)
    out, lse = _bf16_forward(q, k, v, causal, rate, seed)
    got = out.float().numpy()
    mag = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    err_ref = float(np.abs(got - want).max())
    plain_out, plain_lse = tfa.flash_forward_plain(q, k, v, None, causal,
                                                   None, rate, seed, "bhld")
    plain = plain_out.float().numpy()
    err_plain = float(np.abs(got - plain).max())
    err_lse = float((lse - plain_lse).abs().max())
    print(f"max |out - reference| {err_ref} (one ulp {ulp}), "
          f"max |out - plain| {err_plain}, max |lse - plain| {err_lse}")
    assert err_ref <= ulp, (err_ref, ulp)
    assert err_plain <= FLASH_TOL_BF16 * max(1.0, float(np.abs(plain).max()))
    assert err_lse <= 1e-5 * float(plain_lse.abs().max())


def _bf16_backward(q, k, v, out, dout, lse, causal, rate, seed, tile=64,
                   rounded=True):
    """The bf16 backward kernels' arithmetic at D = 64 (dq_wg_kernel,
    dkv_wg_kernel) on [B, H, L, D] bf16 tensors: s = q.k^T and dp =
    do.v^T as fp32 sums of bf16 products, p = 2^(s * scale * log2 e - lse
    * log2 e) under the mask, delta = rowsum(out * dout) in fp32, ds = p
    * (dp * keep - delta) * scale; ds and p * keep rounded to bf16 before
    the products they feed (``rounded``, as the reference's _dq_kernel
    and _dkv_kernel round them); dq = ds.k over ``tile``-key tiles and
    dk = ds^T.q, dv = (p * keep)^T.do over ``tile``-query tiles, each
    tile's product a fresh fp32 partial added to the sum; the gradients
    rounded to bf16.  Returns (dq, dk, dv)."""
    log2e = 1.4426950408889634
    sm_scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, out, dout))
    lq, lk = q.shape[2], k.shape[2]
    rows, cols = torch.arange(lq), torch.arange(lk)
    x = (torch.matmul(qf, kf.transpose(-1, -2)) * (sm_scale * log2e)
         - (lse * log2e)[..., None])
    if causal:
        x = x.masked_fill(rows[:, None] < cols[None, :], -float("inf"))
    p = torch.exp2(x)
    keep = tfa._plain_keep(q, rows, cols, rate, seed)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (of * dof).sum(dim=-1)
    ds = p * (dp * keep - delta[..., None]) * sm_scale
    pk = p * keep
    if rounded:
        ds, pk = (t.to(torch.bfloat16).float() for t in (ds, pk))

    def tiled(a, b):
        # a [.., M, N] . b [.., N, D], a fresh partial every ``tile`` of N
        return sum(torch.matmul(a[..., c:c + tile], b[..., c:c + tile, :])
                   for c in range(0, a.shape[-1], tile))

    dq = tiled(ds, kf)
    dk = tiled(ds.transpose(-1, -2), qf)
    dv = tiled(pk.transpose(-1, -2), dof)
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


# the gradients of the bf16 backward emulation against the reference's
# Pallas dq/dkv kernels, in bf16 ulps of each gradient's largest
# magnitude.  Both round ds and p * keep to bf16 and the gradients once;
# they differ in summation order, exp against exp2, and where a term
# lands on the other side of a rounding boundary (measured: at most 0.5
# ulp; without the rounding 0.5-1 ulp)
BF16_BWD_ULPS = 1


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_backward_rounds_ds_and_p_as_the_reference(causal, pallas_bwd):
    """The bf16 backward kernels at D = 64 take bf16 products with fp32
    sums, 64-key (dq) and 64-query (dk, dv) fresh partials, and round ds
    and the dropped p to bf16 before the products they feed, as the
    reference's Pallas backward kernels do.  Emulated at B=2, H=2,
    L=256, D=64 with dropout 0.1 on bf16 inputs, on the reference's own
    bf16 output, dq, dk and dv are held:
      * against the reference's dq/dkv Pallas kernels in interpret mode
        (the pallas_bwd fixture routes this shape to them), within
        BF16_BWD_ULPS bf16 ulps of each gradient's largest magnitude;
      * against the port's plain backward (fp32 ds and p, the card's
        reference) within chip_smoke's FLASH_TOL["bfloat16"] of max(1,
        magnitude);
    and the same emulation without the rounding is farther from the
    reference in every gradient: the rounding is what the reference
    computes."""
    r = np.random.RandomState(10)
    q, k, v, dout = (torch.tensor(r.randn(2, 2, 256, 64).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    rate, seed = 0.1, 11
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                       for x in (q, k, v, dout))
    out_ref, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, dropout_rate=rate, dropout_seed=seed,
        layout="bhld", impl="pallas_interpret"), jq, jk, jv)
    want = [np.asarray(g).astype(np.float32) for g in vjp(jdo)]
    out = torch.tensor(np.asarray(out_ref).astype(np.float32)).to(
        torch.bfloat16)
    _, lse = tfa.flash_forward_plain(q, k, v, None, causal, None, rate,
                                     seed, "bhld")
    got = _bf16_backward(q, k, v, out, dout, lse, causal, rate, seed)
    raw = _bf16_backward(q, k, v, out, dout, lse, causal, rate, seed,
                         rounded=False)
    plain = tfa.flash_backward_plain(q, k, v, out, dout, lse, None, causal,
                                     None, rate, seed, "bhld")[:3]
    for name, g, u, w, pl in zip(("dq", "dk", "dv"), got, raw, want, plain):
        mag = float(np.abs(w).max())
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        err = float(np.abs(g.float().numpy() - w).max())
        err_raw = float(np.abs(u.float().numpy() - w).max())
        pl = pl.float().numpy()
        err_plain = float(np.abs(g.float().numpy() - pl).max())
        print(f"{name}: max |emulation - reference| {err / ulp:.3g} ulp "
              f"(one ulp {ulp}), unrounded {err_raw / ulp:.3g} ulp; max "
              f"|emulation - plain| {err_plain}")
        assert err <= BF16_BWD_ULPS * ulp, (name, err, ulp)
        assert err < err_raw, (name, err, err_raw)
        assert err_plain <= FLASH_TOL_BF16 * max(1.0, float(
            np.abs(pl).max())), (name, err_plain)


@pytest.mark.parametrize("name", sorted(tune_flash_bwd.VARIANTS))
def test_tune_variant_rewrites_its_constants_only(name):
    """tune_flash_bwd.py builds each variant of the bf16 backward by
    rewriting named constants of flash_attention_bwd.cu: each must be
    defined there once, and the rewrite must touch those lines only."""
    from paddle_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    changes = tune_flash_bwd.VARIANTS[name]
    out = tune_flash_bwd.variant_source(src, changes)
    diff = [(a, b) for a, b in zip(src.splitlines(), out.splitlines())
            if a != b]
    assert len(diff) == len(changes)
    for (_, line), (const, value) in zip(diff, changes.items()):
        assert f"{const} = {value};" in line


# -- heads wider than 64: the wide kernels' work split over 64-column chunks

def _chunk_order(oc, nc):
    """The input chunks in the order a wide block takes them: oc + 1,
    ..., oc (mod nc), so the last stage holds the block's own chunk."""
    return [(oc + 1 + i) % nc for i in range(nc)]


def _wide_forward(q, k, v, causal, rate, seed, sm_scale, chunk=64, tile=64):
    """fwd_wide_kernel's arithmetic on [B, H, L, Dp] float32 tensors, Dp a
    multiple of ``chunk``: per output chunk oc, an online softmax over
    ``tile``-key tiles with s = q.k^T summed over the input chunks in
    order, scaled and masked, and o_oc += p.v_oc.  Returns (out, lse)."""
    nc = q.shape[-1] // chunk
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq)
    out = torch.zeros(q.shape)
    for oc in range(nc):
        ocs = slice(oc * chunk, (oc + 1) * chunk)
        m = torch.full(q.shape[:3], -float("inf"))
        l = torch.zeros(q.shape[:3])
        acc = torch.zeros(q.shape[:3] + (chunk,))
        for k0 in range(0, lk, tile):
            cols = torch.arange(k0, min(k0 + tile, lk))
            s = torch.zeros(q.shape[:3] + (len(cols),))
            for c in range(nc):
                cs = slice(c * chunk, (c + 1) * chunk)
                s = s + torch.matmul(q[..., cs],
                                     k[:, :, cols][..., cs].transpose(-1, -2))
            s = s * sm_scale
            if causal:
                s = s.masked_fill(rows[:, None] < cols[None, :],
                                  tfa.DEFAULT_MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(dim=-1)
            p = p * tfa._plain_keep(q, rows, cols, rate, seed)
            acc = acc * alpha[..., None] + torch.matmul(p, v[:, :, cols][
                ..., ocs])
            m = m_new
        out[..., ocs] = acc / l[..., None]
        if oc == 0:
            lse = m + torch.log(l)
    return out, lse


def _wide_backward(q, k, v, out, dout, lse, causal, rate, seed, sm_scale,
                   chunk=64, tile=64):
    """dq_wide_kernel's and dkv_wide_kernel's arithmetic on [B, H, L, Dp]
    float32 tensors: per output chunk oc and (query tile, key tile), s
    and dp summed over the input chunks in the wide kernels' order, delta
    = rowsum(out * do) over the chunks, ds = p * (dp * keep - delta) *
    scale; dq_oc += ds.k_oc, dk_oc += ds^T.q_oc, dv_oc += (p * keep)^T.
    do_oc.  Returns (dq, dk, dv)."""
    nc = q.shape[-1] // chunk
    lq, lk = q.shape[2], k.shape[2]
    grads = [torch.zeros(x.shape) for x in (q, k, v)]
    for oc in range(nc):
        ocs = slice(oc * chunk, (oc + 1) * chunk)
        order = [slice(c * chunk, (c + 1) * chunk)
                 for c in _chunk_order(oc, nc)]
        for q0 in range(0, lq, tile):
            rows = torch.arange(q0, min(q0 + tile, lq))
            delta = sum((out[:, :, rows][..., cs] * dout[:, :, rows][..., cs])
                        .sum(dim=-1) for cs in order)
            for k0 in range(0, lk, tile):
                cols = torch.arange(k0, min(k0 + tile, lk))
                s = sum(torch.matmul(q[:, :, rows][..., cs], k[:, :, cols][
                    ..., cs].transpose(-1, -2)) for cs in order) * sm_scale
                dp = sum(torch.matmul(dout[:, :, rows][..., cs], v[:, :, cols][
                    ..., cs].transpose(-1, -2)) for cs in order)
                if causal:
                    s = s.masked_fill(rows[:, None] < cols[None, :],
                                      tfa.DEFAULT_MASK_VALUE)
                p = torch.exp(s - lse[:, :, rows][..., None])
                keep = tfa._plain_keep(q, rows, cols, rate, seed)
                ds = p * (dp * keep - delta[..., None]) * sm_scale
                grads[0][:, :, rows, ocs] += torch.matmul(
                    ds, k[:, :, cols][..., ocs])
                grads[1][:, :, cols, ocs] += torch.matmul(
                    ds.transpose(-1, -2), q[:, :, rows][..., ocs])
                grads[2][:, :, cols, ocs] += torch.matmul(
                    (p * keep).transpose(-1, -2), dout[:, :, rows][..., ocs])
    return grads


@pytest.mark.parametrize("d", [80, 128, 256])
def test_wide_chunked_split_matches_reference(d, pallas_bwd):
    """The wide kernels' work split, emulated in plain PyTorch on the
    inputs zero-padded to the next multiple of 64 (s and dp summed over
    64-column chunks, one output chunk at a time, with the true width's
    sm_scale), matches the reference's Pallas forward and its Pallas dq
    and dk/dv kernels in interpret mode on the unpadded inputs: out, lse,
    dq, dk and dv within 1e-5 of max(1, magnitude), causal, dropout 0.1,
    Lq = Lk = 80 (a full and a ragged 64-row tile)."""
    r = np.random.RandomState(d)
    q, k, v, w = (r.randn(1, 2, 80, d).astype(np.float32) for _ in range(4))
    rate, seed, scale = 0.1, 11, d ** -0.5
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=seed,
              layout="bhld", impl="pallas_interpret")
    want_out = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    _, want_lse = jfa._xla_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        jfa.seed_to_carrier(seed), None, scale, True, None, 80, rate)
    want_grads = jax.grad(
        lambda *a: (jfa.flash_attention(*a, **kw) * w).sum(),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    wide = tfa._kernel_width(d)
    pq, pk, pv = tfa._pad_width((T(q), T(k), T(v)), wide)
    out, lse = _wide_forward(pq, pk, pv, True, rate, seed, scale)
    assert not out[..., d:].any()
    pout, pdo = tfa._pad_width((out[..., :d], T(w)), wide)
    grads = _wide_backward(pq, pk, pv, pout, pdo, lse, True, rate, seed,
                           scale)
    got = [out[..., :d], lse] + [g[..., :d] for g in grads]
    want = [want_out, np.asarray(want_lse)] + [np.asarray(g)
                                               for g in want_grads]
    for name, g, wt in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        err = float(np.abs(g.numpy() - wt).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(wt).max())), (name, err)
