"""The serving step's ops through the port's op registry, against the
JAX package's emitters, on the CPU.

* ``paged_cache_write`` and ``quantized_paged_cache_write`` (float32,
  bfloat16 and int8 pools; one token a lane and a chunk of 4; dead lanes
  and dead chunk positions writing the trash page): bit for bit off
  page 0.  The trash page's rows (0 .. 2L-1) take every dead write in
  one scatter whose order is undefined on either side, and no lane reads
  them, so they are left out.  The port's emitters return the pool (and
  the scales) they were given, written in place.
* ``ragged_decode_attention`` (causal and not, C in {1, 4}, a dead
  lane): within 1e-5 for a float32 pool; within 1e-2 for bfloat16 and
  int8 pools (both sides upcast the same stored values, so the measured
  gap is at the float32 level too).
* ``argmax``: equal int32 indices, ties to the first maximum.
* A program of the two paged ops built through ``fluid.layers`` in both
  packages serializes to the same bytes, and the port's Executor runs
  it with the pool written in place: the entry's output is its state
  buffer, so nothing is copied back, and the scope keeps one tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.ops import cache_ops as jax_cache_ops
from paddle_tpu.fluid.ops import tensor_ops as jax_tensor_ops
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core.desc import OpDesc
from paddle_tpu_torch.fluid.core.registry import EmitCtx, get_op_info

H, D, L, NPAGES, P, PS, B = 2, 4, 3, 6, 3, 4, 3
R = NPAGES * L * 2
TRASH_ROWS = 2 * L               # logical page 0, every layer, K and V
KV_DTYPES = ["float32", "bfloat16", "int8"]
ATTN_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-2}


class _Ctx:
    """The attribute surface a JAX op emitter reads."""

    def __init__(self, **attrs):
        self.attrs = attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


def _emit(op_type, ins, **attrs):
    """The port's registered emitter of ``op_type`` on ``ins`` (slot ->
    tensor or None), as the executor calls it."""
    ctx = EmitCtx(OpDesc(op_type, attrs=attrs))
    return get_op_info(op_type).emit(
        ctx, {k: [v] for k, v in ins.items() if v is not None})


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


def _pool(kv_dtype, rng):
    """(numpy pool, numpy scales or None), values every dtype holds
    exactly: bf16 values are rounded once, here, for both sides."""
    f = rng.randn(H, R, PS, D).astype(np.float32)
    if kv_dtype == "float32":
        return f, None
    if kv_dtype == "bfloat16":
        return np.asarray(jnp.asarray(f, jnp.bfloat16)), None
    q = rng.randint(-127, 128, (H, R, PS, D)).astype(np.int8)
    return q, (rng.rand(1, R, PS).astype(np.float32) + 0.5) / 127.0


def _writes(rng, chunk):
    """K/V for ``chunk`` tokens a lane: lane 0 live at positions 2.., lane
    1 live for half the chunk then dead, lane 2 dead; dead tokens write
    (page 0, slot 0) with values of their own."""
    k = rng.randn(B, chunk, H, D).astype(np.float32)
    v = rng.randn(B, chunk, H, D).astype(np.float32)
    pos = 2 + np.arange(chunk)
    pages = np.stack([1 + pos // PS, 3 + pos // PS, np.zeros(chunk)])
    offsets = np.tile(pos % PS, (B, 1))
    pages[1, chunk // 2:] = 0
    offsets[1, chunk // 2:] = 0
    offsets[2] = 0
    return k, v, pages.astype(np.int32), offsets.astype(np.int32)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_writes_match_jax_off_the_trash_page(kv_dtype, chunk):
    rng = np.random.RandomState(chunk + 7)
    pool_np, scales_np = _pool(kv_dtype, rng)
    k, v, pages, offsets = _writes(rng, chunk)
    if chunk == 1:               # the decode form: [B] pages, [B, H, D]
        k, v, pages, offsets = k[:, 0], v[:, 0], pages[:, 0], offsets[:, 0]
    args = [jnp.asarray(x) for x in (k, v, pages, offsets)]
    pool = _to_torch(pool_np)
    tk, tv, tp, to = (torch.from_numpy(x) for x in (k, v, pages, offsets))
    attrs = dict(layer=1, n_layer=L)
    if scales_np is None:
        want = jax_cache_ops.paged_cache_write(
            _Ctx(**attrs), jnp.asarray(pool_np), *args)
        out = _emit("paged_cache_write", {"Pool": pool, "K": tk, "V": tv,
                                          "Pages": tp, "Offsets": to},
                    **attrs)
        assert out["Out"][0] is pool                 # written in place
    else:
        want, want_sc = jax_cache_ops.quantized_paged_cache_write(
            _Ctx(**attrs), jnp.asarray(pool_np), jnp.asarray(scales_np),
            *args)
        scales = torch.from_numpy(scales_np.copy())
        out = _emit("quantized_paged_cache_write",
                    {"Pool": pool, "Scales": scales, "K": tk, "V": tv,
                     "Pages": tp, "Offsets": to}, **attrs)
        assert out["Out"][0] is pool and out["ScalesOut"][0] is scales
        np.testing.assert_array_equal(scales.numpy()[:, TRASH_ROWS:],
                                      np.asarray(want_sc)[:, TRASH_ROWS:])
    got, want = _to_f32(pool), _to_f32(want)
    np.testing.assert_array_equal(got[:, TRASH_ROWS:], want[:, TRASH_ROWS:])
    assert not np.array_equal(got, _to_f32(_to_torch(pool_np)))


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ragged_attention_op_matches_jax(kv_dtype, c, causal):
    rng = np.random.RandomState(11)
    pool_np, scales_np = _pool(kv_dtype, rng)
    q = rng.randn(B, c, H, D).astype(np.float32)
    tbl = rng.randint(0, NPAGES, (B, P)).astype(np.int32)
    lengths = np.array([7, 0, 11], np.int32)        # lane 1 is dead
    base = np.array([7 - c, 0, 11 - c], np.int32)
    attrs = dict(layer=2, n_layer=L, causal=causal, sm_scale=D ** -0.5)
    want = jax_cache_ops.ragged_decode_attention(
        _Ctx(**attrs), jnp.asarray(q), jnp.asarray(pool_np),
        jnp.asarray(tbl), jnp.asarray(lengths),
        jnp.asarray(base) if causal else None,
        None if scales_np is None else jnp.asarray(scales_np))
    got, = _emit("ragged_decode_attention",
                 {"Q": torch.from_numpy(q), "Pool": _to_torch(pool_np),
                  "PageTable": torch.from_numpy(tbl),
                  "Lengths": torch.from_numpy(lengths),
                  "QBase": torch.from_numpy(base) if causal else None,
                  "Scales": None if scales_np is None
                  else torch.from_numpy(scales_np)}, **attrs)["Out"]
    tol = ATTN_TOL[kv_dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    assert (got[1] == 0).all()                       # dead lane


@pytest.mark.parametrize("axis", [-1, 1])
def test_argmax_matches_jax(axis):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 7).astype(np.float32)
    x[0, 1, 2:4] = 9.0                               # a tie on the last axis
    x[1, 2:4, 3] = 9.0                               # and on axis 1
    want = jax_tensor_ops.argmax(_Ctx(axis=axis), jnp.asarray(x))
    got, = _emit("argmax", {"X": torch.from_numpy(x)}, axis=axis)["Out"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _paged_program(fluid):
    """pool <- paged_cache_write(k, v); out = ragged attention over it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        pool = main.global_block().create_var(
            name="m@kv_pool", shape=[H, R, PS, D], dtype="float32",
            persistable=True)
        q = fluid.layers.data("q", [1, H, D], "float32")
        k = fluid.layers.data("k", [1, H, D], "float32")
        v = fluid.layers.data("v", [1, H, D], "float32")
        pages = fluid.layers.data("pages", [1], "int32")
        offsets = fluid.layers.data("offsets", [1], "int32")
        table = fluid.layers.data("table", [P], "int32")
        lengths = fluid.layers.data("lengths", [], "int32")
        base = fluid.layers.data("base", [], "int32")
        pool = fluid.layers.paged_cache_write(pool, k, v, pages, offsets,
                                              layer=1, n_layer=L)
        out = fluid.layers.ragged_decode_attention(
            q, pool, table, lengths, base, layer=1, n_layer=L,
            sm_scale=D ** -0.5)
    return main, out


def test_paged_program_serializes_alike_and_writes_the_pool_in_place():
    jmain, _ = _paged_program(jfluid)
    tmain, out = _paged_program(tfluid)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    scope.set_var("m@kv_pool", torch.zeros(H, R, PS, D))
    ptr = scope.find_var("m@kv_pool").data_ptr()
    rng = np.random.RandomState(4)
    for step in range(3):
        feed = {"q": rng.randn(B, 1, H, D).astype(np.float32),
                "k": rng.randn(B, 1, H, D).astype(np.float32),
                "v": rng.randn(B, 1, H, D).astype(np.float32),
                "pages": np.array([[1], [2], [0]], np.int32),
                "offsets": np.full((B, 1), step, np.int32),
                "table": np.array([[1, 0, 0], [2, 0, 0], [0, 0, 0]],
                                  np.int32),
                "lengths": np.array([step + 1, step + 1, 1], np.int32),
                "base": np.full(B, step, np.int32)}
        got, = exe.run(tmain, feed=feed, fetch_list=[out], scope=scope)
        assert np.isfinite(got).all()
        assert scope.find_var("m@kv_pool").data_ptr() == ptr
    entry, = exe._cache.values()
    assert entry.out["m@kv_pool"] is entry.state["m@kv_pool"] \
        is scope.find_var("m@kv_pool")
    assert exe.cache_stats()["executable"]["hits"] == 2
    # lane 0's three tokens landed in page 1 at slots 0..2
    rows = (1 * L + 1) * 2
    written = scope.find_var("m@kv_pool")[:, rows, :3]
    assert (written != 0).all()
