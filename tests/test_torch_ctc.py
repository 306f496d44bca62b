"""CTC speech recognition in the port (``fluid/ops/ctc_ops.py``, the GRU
ops of ``fluid/ops/rnn_ops.py``, their layers, and ``chip_smoke``'s
speech program) against the JAX package on the CPU.

* ``warpctc`` through both emitters on seeded logits with ragged frame
  and label lengths, an empty label, repeated characters, a blank that
  is not class 0: the loss within OUT_RTOL of its largest, the
  gradients within GRAD_RTOL of theirs (``compare_op``); with
  ``norm_by_times`` the value is the plain loss and the gradient the
  plain one over T; and the reference's brute-force golden case
  (``tests/test_ctc.py``: every path of T = 4 enumerated) through the
  port's program.
* ``edit_distance`` (plain and normalized) and ``ctc_align`` bit for
  bit, over empty and full-length sequences; the port's anti-diagonal
  Levenshtein against a plain dynamic program on random pairs.
* ``dynamic_gru`` forward and reversed, with and without H0 and bias,
  over ragged lengths: the hidden sequence and the gradients of Input,
  Weight, Bias and H0 at the same tolerances.
* The speech program (fc, bidirectional ``dynamic_gru`` layers, fc,
  ``warpctc(norm_by_times=True)``, Adam; the test program's greedy
  decode and normalized edit distance) serializes to the reference's
  bytes at the small width and at DeepSpeech2's; three Adam steps from
  the reference's initial scope give its losses within LOSS_RTOL; the
  decode's paths and distances are the reference's bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.ops import ctc_ops
from tests.test_ctc import brute_force_ctc_nll, levenshtein
from tests.test_torch_conv_ops import as_np, compare_op, rel_err, run_op

LOSS_RTOL = 1e-5
SMALL = dict(bins=8, hidden=16, depth=2, classes=6, lr=1e-2)
PACKAGES = {"jax": jfluid, "port": tfluid}


def _ctc_specs(seed, t_lens, labels, classes, blank, t_max=None):
    rng = np.random.RandomState(seed)
    t_max = t_max or max(t_lens)
    logits = rng.randn(len(t_lens), t_max, classes).astype(np.float32)
    l_max = max(max((len(x) for x in labels), default=0), 1)
    lab = np.zeros((len(labels), l_max, 1), np.int32)
    for i, x in enumerate(labels):
        lab[i, :len(x), 0] = x
    return ({"Logits": ("seq", logits, np.asarray(t_lens, np.int32)),
             "Label": ("seq", lab, np.asarray([len(x) for x in labels],
                                              np.int32))},
            {"blank": blank})


CTC_CASES = {
    "ragged": (0, [9, 5, 3, 7], [[1, 2, 3], [4], [2], [1, 3, 2, 4]], 5, 0),
    "empty_label": (1, [6, 4, 5], [[], [2, 1], []], 4, 0),
    "repeats": (2, [8, 8], [[1, 1, 2], [3, 3, 3]], 4, 0),
    "blank_last": (3, [7, 6, 4], [[0, 2, 1], [3], [1, 1]], 5, 4),
    "padded_frames": (4, [3, 5], [[1], [2, 2]], 3, 0, 9),
}


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_warpctc_matches_reference(case):
    specs, attrs = _ctc_specs(*CTC_CASES[case])
    compare_op("warpctc", specs, attrs, ("Logits",))


def test_warpctc_norm_by_times_scales_only_the_gradient():
    specs, attrs = _ctc_specs(*CTC_CASES["ragged"])
    compare_op("warpctc", specs, dict(attrs, norm_by_times=True),
               ("Logits",))
    outs, grads = [], []
    for norm in (False, True):
        leaf = torch.tensor(specs["Logits"][1], requires_grad=True)
        loss = run_op("port", "warpctc", specs,
                      dict(attrs, norm_by_times=norm),
                      {"Logits": [leaf]})["Loss"][0]
        loss.sum().backward()
        outs.append(loss.detach().numpy())
        grads.append(leaf.grad.numpy())
    assert rel_err(outs[1], outs[0]) <= 1e-6
    t = specs["Logits"][2].astype(np.float32)[:, None, None]
    np.testing.assert_allclose(grads[1], grads[0] / t, atol=1e-6)


def test_warpctc_matches_the_brute_force_golden():
    """tests/test_ctc.py's golden case through the port's program: every
    path of 4 frames over 3 classes enumerated."""
    rng = np.random.RandomState(0)
    seqs = [rng.randn(4, 3).astype(np.float32) for _ in range(3)]
    labels = [[1], [2, 1], [1, 2]]
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [3], "float32", lod_level=1)
        y = tfluid.layers.data("y", [1], "int64", lod_level=1)
        loss = tfluid.layers.warpctc(x, y)
    out, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": tfluid.make_seq(seqs), "y": tfluid.make_seq(
            labels, dtype=np.int32, bucket=2)},
        fetch_list=[loss], scope=tfluid.Scope())
    want = [brute_force_ctc_nll(s, lbl) for s, lbl in zip(seqs, labels)]
    np.testing.assert_allclose(np.asarray(out).ravel(), want, rtol=1e-4)


def _token_seqs(seed, b, max_len, vocab, lo=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, max_len + 1, b).astype(np.int32)
    lens[0], lens[-1] = 0, max_len
    data = rng.randint(0, vocab, (b, max_len, 1)).astype(np.int32)
    return data, lens


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("shape", [(7, 9, 6, 3), (5, 4, 11, 2)])
def test_edit_distance_matches_reference_bitwise(normalized, shape):
    b, h, r, vocab = shape
    hyp, hl = _token_seqs(10 + h, b, h, vocab)
    ref, rl = _token_seqs(20 + r, b, r, vocab)
    compare_op("edit_distance", {"Hyps": ("seq", hyp, hl),
                                 "Refs": ("seq", ref, rl)},
               {"normalized": normalized}, exact=True)


def test_levenshtein_wavefront_is_the_dynamic_program():
    hyp, hl = _token_seqs(6, 40, 12, 3)
    ref, rl = _token_seqs(7, 40, 15, 3)
    got = ctc_ops.levenshtein(torch.tensor(hyp[..., 0]), torch.tensor(hl),
                              torch.tensor(ref[..., 0]), torch.tensor(rl))
    want = [levenshtein(hyp[i, :hl[i], 0], ref[i, :rl[i], 0])
            for i in range(40)]
    np.testing.assert_array_equal(got.numpy(), np.float32(want))


@pytest.mark.parametrize("blank", [0, 3])
def test_ctc_align_matches_reference_bitwise(blank):
    paths, lens = _token_seqs(30 + blank, 6, 10, 5)
    paths[1, :4, 0] = [blank, blank, 2, 2]
    compare_op("ctc_align", {"Input": ("seq", paths, lens)},
               {"blank": blank}, exact=True)


def _gru_specs(seed, h0, bias):
    rng = np.random.RandomState(seed)
    b, t, size = 4, 7, 5
    specs = {"Input": ("seq", rng.randn(b, t, 3 * size).astype(np.float32),
                       np.array([7, 3, 1, 5], np.int32)),
             "Weight": ("t", (rng.randn(size, 3 * size) * 0.5)
                        .astype(np.float32))}
    if bias:
        specs["Bias"] = ("t", rng.randn(1, 3 * size).astype(np.float32))
    if h0:
        specs["H0"] = ("t", rng.randn(b, size).astype(np.float32))
    return specs


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_dynamic_gru_matches_reference(reverse, h0, bias):
    specs = _gru_specs(40 + 4 * reverse + 2 * h0 + bias, h0, bias)
    compare_op("dynamic_gru", specs, {"is_reverse": reverse},
               tuple(specs))


def test_dynamic_gru_activations_match_reference():
    specs = _gru_specs(50, True, True)
    compare_op("dynamic_gru", specs, {"gate_activation": "sigmoid",
                                      "activation": "relu"}, tuple(specs))


def _speech(pkg, dims=SMALL):
    return chip_smoke.build_speech(PACKAGES[pkg], **dims)


@pytest.mark.parametrize("dims", ["small", "deepspeech2"])
def test_speech_programs_match_reference_bytes(dims):
    d = SMALL if dims == "small" else chip_smoke.SPEECH
    j, t = _speech("jax", d), _speech("port", d)
    for a, b in zip(j[:3], t[:3]):
        assert b.serialize_to_string() == a.serialize_to_string()
    ops = [op.type for op in t[0].global_block().ops]
    assert ops.count("dynamic_gru") == 2 * d["depth"]
    for op in ("warpctc", "warpctc_grad", "dynamic_gru_grad", "adam",
               "ctc_align", "edit_distance"):
        assert op in ops, op


def _feed(fluid):
    return chip_smoke.speech_batch(np, fluid, np.random.RandomState(3), 5,
                                   SMALL["bins"], SMALL["classes"], (6, 11),
                                   (1, 4))


def test_speech_trains_and_decodes_as_the_reference():
    j = _speech("jax")
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(j[1])
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        jdec = exe.run(j[2], feed=_feed(jfluid), fetch_list=[j[5], j[6]])
        want = [float(np.asarray(exe.run(j[0], feed=_feed(jfluid),
                                         fetch_list=[j[3]])[0]))
                for _ in range(3)]
    t = _speech("port")
    cpu = tfluid.CPUPlace()
    tscope, texe = tfluid.scope_from_numpy(init, cpu), tfluid.Executor(cpu)
    tdec = texe.run(t[2], feed=_feed(tfluid), fetch_list=[t[5], t[6]],
                    scope=tscope)
    got = [float(texe.run(t[0], feed=_feed(tfluid), fetch_list=[t[3]],
                          scope=tscope)[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    for a, b in ((jdec[0].data, tdec[0].data),
                 (jdec[0].lengths, tdec[0].lengths), (jdec[1], tdec[1])):
        a, b = np.asarray(a), as_np(b) if isinstance(b, torch.Tensor) \
            else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
