"""Int8 post-training quantization and the inference engine in the port
(``fluid/ops/quant_ops.py``, ``fluid/transforms/quantize.py``,
``serving/engine.py``) against the JAX package on the CPU.

* The quant ops through both emitters: ``quantize`` / ``dequantize`` bit
  for bit; ``quantized_mul``, ``quantized_matmul`` (2-D, transposed,
  batched, alpha) and ``quantized_conv2d`` (also a bf16 input) within
  OUT_RTOL of their largest output (float32 sums in another order).
* ``quantize_program`` on the small attention seq2seq's beam decoder
  (its weights inside a ``While`` body, reached through the ``P`` slot)
  and on the book's ``conv_net``: the rewritten program's bytes, the
  ``QuantStats`` and the int8 weights and scales are the reference's,
  bit for bit.
* ``InferenceEngine`` over the same ``save_inference_model`` artifact,
  float and int8: the decoded ids token for token, the scores within
  SCORE_TOL, and the bucket keys, hit / miss and padding counters equal;
  warm-up registers buckets without counting; the unported surfaces
  raise naming their queue item.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.lod import make_seq as jmake_seq
from paddle_tpu.fluid.transforms import quantize_program as jquantize
from paddle_tpu.models import recognize_digits as jdigits
from paddle_tpu.serving import InferenceEngine as JEngine
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.transforms import quantize_program as tquantize
from paddle_tpu_torch.models import recognize_digits as tdigits
from paddle_tpu_torch.serving import InferenceEngine as TEngine
from tests.test_torch_amp import _emit
from tests.test_torch_conv_ops import rel_err
from tests.test_torch_nmt import build_decode

OUT_RTOL = 1e-5
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = tfluid.CPUPlace()


def _both(op_type, arrays, attrs, out="Out"):
    """Both emitters on numpy ``arrays`` ({slot: array}) -> (reference's
    outputs, the port's) as numpy."""
    jo = _emit(jreg, JOpDesc, op_type,
               {s: [np.asarray(a)] for s, a in arrays.items()}, attrs)

    def port(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    to = _emit(treg, TOpDesc, op_type,
               {s: [port(a)] for s, a in arrays.items()}, attrs)

    def np_(v):
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                return v.float().numpy().astype(ml_dtypes.bfloat16)
            return v.numpy()
        return np.asarray(v)

    return ({k: [np_(v) for v in vs] for k, vs in jo.items()},
            {k: [np_(v) for v in vs] for k, vs in to.items()})


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _int8(*shape, seed=1):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


@pytest.mark.parametrize("axis", [None, 0, 1, [0, 2]])
def test_quantize_and_dequantize_are_the_references_bitwise(axis):
    x = _rand(6, 5, 4)
    x[1] = 0.0                                   # a zero channel: scale 1
    attrs = {} if axis is None else {"axis": axis}
    jo, to = _both("quantize", {"X": x}, attrs)
    for slot in ("Out", "Scale"):
        assert to[slot][0].dtype == jo[slot][0].dtype
        np.testing.assert_array_equal(to[slot][0], jo[slot][0])
    jd, td = _both("dequantize", {"X": jo["Out"][0], "Scale": jo["Scale"][0]},
                   dict(attrs, out_dtype="float64"))
    assert td["Out"][0].dtype == jd["Out"][0].dtype == np.float32
    np.testing.assert_array_equal(td["Out"][0], jd["Out"][0])


QUANT_CASES = {
    "mul": ("quantized_mul", {"X": _rand(4, 3, 6), "Y": _int8(6, 5),
                              "Scale": np.abs(_rand(5)) / 127},
            {"x_num_col_dims": 2}),
    "mul_scalar_scale": ("quantized_mul", {"X": _rand(7, 6),
                                           "Y": _int8(6, 3),
                                           "Scale": np.float32(0.01)},
                         {}),
    "matmul": ("quantized_matmul", {"X": _rand(5, 8), "Y": _int8(8, 6),
                                    "Scale": np.abs(_rand(6)) / 127},
               {"alpha": 0.5}),
    "matmul_transposed": ("quantized_matmul",
                          {"X": _rand(8, 5), "Y": _int8(6, 8),
                           "Scale": np.abs(_rand(6)) / 127},
                          {"transpose_X": True, "transpose_Y": True}),
    "matmul_batched": ("quantized_matmul",
                       {"X": _rand(3, 5, 8), "Y": _int8(3, 8, 4),
                        "Scale": np.abs(_rand(4)) / 127}, {}),
    "conv2d": ("quantized_conv2d",
               {"Input": _rand(2, 4, 9, 9), "Filter": _int8(6, 2, 3, 3),
                "Scale": np.abs(_rand(6)) / 127},
               {"strides": [2, 1], "paddings": [1, 0],
                "dilations": [1, 2], "groups": 2}),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantized_products_match_the_references(case):
    op, arrays, attrs = QUANT_CASES[case]
    out = "Output" if op == "quantized_conv2d" else "Out"
    jo, to = _both(op, arrays, attrs)
    got, want = to[out][0], jo[out][0]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) <= OUT_RTOL, rel_err(got, want)


def test_quantized_conv2d_keeps_a_bf16_input_dtype():
    """The reference's emitter refuses a bf16 input against its float32
    filter (``conv_general_dilated`` wants one dtype); the port casts the
    input to float32 and the result back: within one bf16 rounding of
    the reference's float32 result on the same (rounded) input."""
    _, arrays, attrs = QUANT_CASES["conv2d"]
    x = arrays["Input"].astype(ml_dtypes.bfloat16)
    with pytest.raises(TypeError, match="same dtypes"):
        _both("quantized_conv2d", dict(arrays, Input=x), attrs)
    xt = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    to = _emit(treg, TOpDesc, "quantized_conv2d",
               {"Input": [xt], "Filter": [torch.from_numpy(arrays["Filter"])],
                "Scale": [torch.from_numpy(arrays["Scale"])]}, attrs)
    got = to["Output"][0]
    assert got.dtype == torch.bfloat16
    jo, _ = _both("quantized_conv2d",
                  dict(arrays, Input=x.astype(np.float32)), attrs)
    assert rel_err(got.float().numpy(), jo["Output"][0]) <= 2 ** -8


def _seeded_state(program, seed):
    """Seeded float32 values for ``program``'s persistables (N(0, 0.3),
    no startup run needed)."""
    rng = np.random.RandomState(seed)
    return {v.name: (0.3 * rng.randn(*v.shape)).astype(np.float32)
            for v in sorted(program.list_vars(), key=lambda v: v.name)
            if v.persistable and v.shape}


@pytest.fixture(scope="module")
def decoder_artifact(tmp_path_factory):
    """The small attention seq2seq (test_torch_nmt's widths, beam 2,
    max_length 6) on seeded weights: its decoder saved by the reference
    and by the port (the same bytes)."""
    from paddle_tpu.fluid import io as jio
    from paddle_tpu_torch.fluid import io as tio

    tmp_path = tmp_path_factory.mktemp("decoder")
    jp, _, jids, jsc = build_decode("jax", "attention_decode_model")
    tp, _, tids, tsc = build_decode("port", "attention_decode_model")
    state = _seeded_state(jp, 12)
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    for n, v in state.items():
        scope.set_var(n, v)
    jio.save_inference_model(str(tmp_path / "j"), ["src"], [jids, jsc], exe,
                             main_program=jp, scope=scope)
    tio.save_inference_model(str(tmp_path / "t"), ["src"], [tids, tsc],
                             tfluid.Executor(CPU), main_program=tp,
                             scope=tfluid.scope_from_numpy(state, CPU))
    model = (tmp_path / "j" / "__model__").read_bytes()
    assert (tmp_path / "t" / "__model__").read_bytes() == model
    return str(tmp_path / "j"), state


def _srcs(make_seq, n, seed):
    rng = np.random.RandomState(seed)
    return {"src": make_seq([rng.randint(2, 14, rng.randint(3, 7))
                             for _ in range(n)], dtype=np.int64)}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _same_decode(got, want):
    gids, gsc = got
    wids, wsc = want
    for f in ("data", "outer_lengths", "inner_lengths"):
        np.testing.assert_array_equal(_host(getattr(gids, f)),
                                      _host(getattr(wids, f)), err_msg=f)
    np.testing.assert_allclose(_host(gsc), _host(wsc), **SCORE_TOL)


def _engines(dirname, quantize):
    kw = dict(dirname=dirname, batch_buckets=(2, 4, 8), time_bucket=8,
              quantize=quantize)
    return (JEngine(place=jfluid.CPUPlace(), **kw),
            TEngine(place=CPU, **kw))


def _stats(engine):
    s = engine.cache_stats()
    return {k: s[k] for k in ("bucket_hits", "bucket_misses", "buckets",
                              "padding", "quant")}


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_engine_decodes_as_the_reference(quantize, decoder_artifact):
    dirname, _ = decoder_artifact
    jeng, teng = _engines(dirname, quantize)
    if quantize == "int8":
        assert teng.program.serialize_to_string() == \
            jeng.program.serialize_to_string()
        q = teng.cache_stats()["quant"]
        assert q["weights_quantized"] >= 5 and q["weight_bytes_saved"] > 0
        for n in [v.name for v in teng.program.list_vars() if v.persistable]:
            want = np.asarray(jeng.scope.find_var(n))
            got = tfluid.scope_to_numpy(teng.scope, [n])[n]
            assert got.dtype == want.dtype, n
            np.testing.assert_array_equal(got, want, err_msg=n)
    warm = _srcs(jmake_seq, 4, 3)
    assert teng.bucket_key(_srcs(tfluid.make_seq, 4, 3)) == \
        jeng.bucket_key(warm)
    jeng.warmup([warm])
    teng.warmup([_srcs(tfluid.make_seq, 4, 3)])
    for n, seed in ((4, 4), (3, 5)):            # a full bucket, a tail
        want = jeng.infer(_srcs(jmake_seq, n, seed))
        got = teng.infer(_srcs(tfluid.make_seq, n, seed))
        _same_decode(got, want)
        assert np.asarray(got[0].data).shape[0] == n
    assert _stats(teng) == _stats(jeng)
    assert _stats(teng)["bucket_misses"] == 0
    out = teng.infer(_srcs(tfluid.make_seq, 3, 5), return_numpy=False)
    assert isinstance(out[1], torch.Tensor) and out[1].shape[0] == 3


def test_quantize_program_on_conv_net_is_the_references():
    progs = {}
    for pkg, fluid, digits in (("jax", jfluid, jdigits),
                               ("port", tfluid, tdigits)):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            img = fluid.layers.data("img", [1, 28, 28], "float32")
            label = fluid.layers.data("label", [1], "int64")
            pred = digits.conv_net(img, label)[0]
        progs[pkg] = fluid.io.prune_program(main, [pred])
    state = _seeded_state(progs["jax"], 4)
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    jprog = progs["jax"].clone(for_test=True)
    tprog = progs["port"].clone(for_test=True)
    tscope = tfluid.scope_from_numpy(state, CPU)
    jst = jquantize(jprog, scope)
    tst = tquantize(tprog, tscope)
    assert tst.to_dict() == jst.to_dict()
    assert tst.quantized == jst.quantized and len(tst.quantized) == 3
    assert tprog.serialize_to_string() == jprog.serialize_to_string()
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("quantized_conv2d") == 2 \
        and "quantized_mul" in types
    for n in state:
        np.testing.assert_array_equal(np.asarray(tscope.find_var(n)),
                                      np.asarray(scope.find_var(n)),
                                      err_msg=n)


def test_engine_surfaces_and_refusals(decoder_artifact):
    dirname, state = decoder_artifact
    _, teng = _engines(dirname, "off")
    with pytest.raises(NotImplementedError, match="A14"):
        teng.static_hbm_estimate()
    with pytest.raises(NotImplementedError, match=r"A10\(b\)"):
        teng.preresolve(max_time=8, stop_on_compile=True)
    with pytest.raises(ValueError, match="'off' or 'int8'"):
        TEngine(dirname=dirname, place=CPU, quantize="fp8")
    with pytest.raises(ValueError, match="mixed feed batch"):
        teng.infer({"a": np.zeros((2, 3)), "b": np.zeros((3, 3))})
    sets = teng.bucket_set(max_time=8)
    assert [(e["batch"], e["time"]) for e in sets] == [
        (2, 8), (4, 8), (8, 8)]
    assert teng.preresolve(max_time=8) == 3
    st = teng.cache_stats()
    assert st["bucket_hits"] == st["bucket_misses"] == 0
    assert sorted(v for v in st["buckets"].values()) == [0, 0, 0]
    assert st["executable"]["misses"] == 3
    # weights are tensors after the load (to_device on the CPU)
    assert all(isinstance(teng.scope.find_var(n), torch.Tensor)
               for n in state if teng.scope.find_var(n) is not None)
    assert teng.place_weights() == 0
