"""The port's LSTM (``kernels/lstm.py`` and the ``dynamic_lstm`` op)
against the JAX package, on the CPU.

* ``lstm_forward_plain`` against the TPU kernel ``pallas_lstm_fwd`` of
  ``tools/lstm_probe.py`` (its Pallas kernel run in interpret mode; the
  file is loaded by path and not edited) and against the probe's own
  ``xla_lstm_fwd``: zero bias, zero initial state, full lengths.  Both
  sides compute in float32 over 7 steps of width 16, so they agree to
  1e-6.
* The port's ``dynamic_lstm`` emitter against
  ``paddle_tpu/fluid/ops/rnn_ops.py``'s, over peepholes x direction x
  initial state, with ragged lengths that include 0 and 1, and one case
  of non-default activations: Hidden and Cell, and the gradients of
  Input, Weight, Bias, H0 and C0 (the port's hand-written backward of
  ``_DynamicLSTM`` against ``jax.vjp`` of the scan).  float32 on both
  sides, summation order only, over 9 steps of width 8: 1e-5.
* The wrapper refuses what it does not run: bf16 (``amp_dtype`` is not
  ported), unknown activations, devices other than the CPU and CUDA.
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.lod import SeqArray as JSeq
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.core.lod import SeqArray as TSeq
from paddle_tpu_torch.kernels import lstm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_TOL = dict(rtol=0, atol=1e-6)
OP_TOL = dict(rtol=0, atol=1e-5)
B, T, H = 5, 9, 8
LENGTHS = np.array([9, 0, 4, 1, 7], np.int32)


@functools.lru_cache(maxsize=1)
def _probe():
    """tools/lstm_probe.py, with its pallas_call run in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "lstm_probe_interpret", os.path.join(ROOT, "tools", "lstm_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        program_id=pl.program_id, when=pl.when, BlockSpec=pl.BlockSpec)
    return mod


def test_plain_forward_matches_the_probes_pallas_kernel():
    probe = _probe()
    h, b, t = 16, 4, 7
    r = np.random.RandomState(0)
    x_proj = (r.randn(b, t, 4 * h) * 0.1).astype(np.float32)
    w_h = (r.randn(h, 4 * h) * 0.05).astype(np.float32)
    want_pallas = np.asarray(probe.pallas_lstm_fwd(jnp.asarray(x_proj),
                                                   jnp.asarray(w_h), h))
    want_scan = np.asarray(probe.xla_lstm_fwd(jnp.asarray(x_proj),
                                              jnp.asarray(w_h), h))
    got, _ = lstm.lstm_forward_plain(
        torch.tensor(x_proj), torch.tensor(w_h), torch.zeros(4 * h),
        torch.full((b,), t, dtype=torch.int32), use_peepholes=False)
    np.testing.assert_allclose(got.numpy(), want_pallas, **PROBE_TOL)
    np.testing.assert_allclose(got.numpy(), want_scan, **PROBE_TOL)
    # the wrapper takes the plain version for CPU tensors
    got2, _ = lstm.lstm_forward(
        torch.tensor(x_proj), torch.tensor(w_h), torch.zeros(4 * h),
        torch.full((b,), t, dtype=torch.int32), use_peepholes=False)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


CASES = [dict(use_peepholes=p, is_reverse=r, init=i)
         for p in (False, True) for r in (False, True) for i in (False, True)]
CASES.append(dict(use_peepholes=True, is_reverse=True, init=True,
                  gate_activation="relu", cell_activation="identity",
                  candidate_activation="sigmoid"))


def _case_id(c):
    acts = c.get("gate_activation")
    return (f"{'peep' if c['use_peepholes'] else 'nopeep'}-"
            f"{'rev' if c['is_reverse'] else 'fwd'}-"
            f"{'h0c0' if c['init'] else 'zero'}" + (f"-{acts}" if acts
                                                     else ""))


def _inputs(case):
    r = np.random.RandomState(1)
    arr = {"Input": (r.randn(B, T, 4 * H) * 0.5).astype(np.float32),
           "Weight": (r.randn(H, 4 * H) * 0.3).astype(np.float32),
           "Bias": (r.randn((7 if case["use_peepholes"] else 4) * H)
                    * 0.2).astype(np.float32)}
    if case["init"]:
        arr["H0"] = r.randn(B, H).astype(np.float32)
        arr["C0"] = r.randn(B, H).astype(np.float32)
    attrs = {k: v for k, v in case.items() if k != "init"}
    return arr, attrs


def _desc(cls, attrs, arrays):
    return cls("dynamic_lstm", {s: [s] for s in arrays},
               {"Hidden": ["h"], "Cell": ["c"]}, attrs)


def _jax_op(arrays, attrs):
    """(Hidden, Cell) data of the JAX emitter as a function of the float
    inputs, in the order of ``arrays``."""
    info = jreg.get_op_info("dynamic_lstm")
    ctx = jreg.EmitCtx(_desc(JOpDesc, attrs, arrays))
    names = list(arrays)

    def f(*xs):
        ins = {n: [x] for n, x in zip(names, xs)}
        ins["Input"] = [JSeq(ins["Input"][0], jnp.asarray(LENGTHS))]
        out = info.emit(ctx, ins)
        return out["Hidden"][0].data, out["Cell"][0].data

    return f


def _port_op(arrays, attrs, leaves):
    info = treg.get_op_info("dynamic_lstm")
    ctx = treg.EmitCtx(_desc(TOpDesc, attrs, arrays))
    ins = {n: [t] for n, t in leaves.items()}
    ins["Input"] = [TSeq(leaves["Input"], torch.tensor(LENGTHS))]
    out = info.emit(ctx, ins)
    return out["Hidden"][0], out["Cell"][0]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dynamic_lstm_forward_matches_reference(case):
    arrays, attrs = _inputs(case)
    want_h, want_c = _jax_op(arrays, attrs)(
        *[jnp.asarray(a) for a in arrays.values()])
    got_h, got_c = _port_op(arrays, attrs, {n: torch.tensor(a)
                                            for n, a in arrays.items()})
    assert isinstance(got_h, TSeq) and isinstance(got_c, TSeq)
    np.testing.assert_array_equal(got_h.lengths.numpy(), LENGTHS)
    np.testing.assert_allclose(got_h.data.numpy(), np.asarray(want_h),
                               **OP_TOL)
    np.testing.assert_allclose(got_c.data.numpy(), np.asarray(want_c),
                               **OP_TOL)
    # past each row's length both outputs are exactly 0
    pad = np.arange(T)[None, :] >= LENGTHS[:, None]
    assert not got_h.data.numpy()[pad].any()
    assert not got_c.data.numpy()[pad].any()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_dynamic_lstm_backward_matches_reference_vjp(case):
    arrays, attrs = _inputs(case)
    r = np.random.RandomState(2)
    dh = r.randn(B, T, H).astype(np.float32)
    dc = r.randn(B, T, H).astype(np.float32)
    _, vjp = jax.vjp(_jax_op(arrays, attrs),
                     *[jnp.asarray(a) for a in arrays.values()])
    want = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    leaves = {n: torch.tensor(a, requires_grad=True)
              for n, a in arrays.items()}
    got_h, got_c = _port_op(arrays, attrs, leaves)
    got = torch.autograd.grad((got_h.data, got_c.data), list(leaves.values()),
                              (torch.tensor(dh), torch.tensor(dc)))
    for name, g, w in zip(arrays, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **OP_TOL)


def test_wrapper_refuses_what_it_does_not_run():
    x = torch.zeros(2, 3, 16)
    w, b = torch.zeros(4, 16), torch.zeros(28)
    lens = torch.full((2,), 3, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="amp_dtype"):
        lstm.lstm_forward(x.bfloat16(), w, b, lens)
    with pytest.raises(ValueError, match="activation"):
        lstm.lstm_forward(x, w, b, lens, gate_activation="gelu")
    with pytest.raises(ValueError, match="device"):
        lstm.lstm_forward(x.to("meta"), w.to("meta"), b.to("meta"),
                          lens.to("meta"))
    # meta tensors (shape inference) go through dynamic_lstm, which
    # launches nothing
    h, c = lstm.dynamic_lstm(x.to("meta"), w.to("meta"), b.to("meta"),
                             lens.to("meta"))
    assert h.shape == c.shape == (2, 3, 4) and h.device.type == "meta"



# -- the kernel's work split (kernels/lstm.py's planner) at an H100's
# limits: 132 SMs, 232,448 bytes of shared memory a block
SMS, SMEM = 132, 232448


def _owners(plan, B, H):
    """Who updates which (row, unit) under ``plan``, as csrc/lstm_fwd.cu
    assigns it: warp (mw, nw) of a block owns m-tile mw and n-tiles
    nw*ntw .. +ntw-1; after the gate exchange lane (g, t) holds row
    mw*16 + g (+8 for odd t) and unit 2*tile + t//2.  -> int arrays
    (row, unit, block, thread), one entry per pair a thread updates."""
    blk, warp, lane, tile = np.meshgrid(
        np.arange(plan["grid"]), np.arange(lstm.WARPS), np.arange(32),
        np.arange(plan["ntw"]), indexing="ij")
    ub, bg = blk % plan["nh"], blk // plan["nh"]
    mw, nw = warp % plan["wm"], warp // plan["wm"]
    g, t = lane >> 2, lane & 3
    nt = nw * plan["ntw"] + tile
    row = mw * 16 + g + 8 * (t & 1)
    du = nt * 2 + (t >> 1)
    b, u = bg * plan["Bs"] + row, ub * plan["k"] + du
    ok = ((nw < plan["wn"]) & (nt < plan["k"] // 2) & (row < plan["Bs"])
          & (b < B) & (u < H))
    return b[ok], u[ok], blk[ok], (warp * 32 + lane)[ok]


@pytest.mark.parametrize("H", [1, 200, 256, 512, 1000, 1280, 2048])
@pytest.mark.parametrize("B", [1, 4, 100, 128])
def test_plan_covers_every_pair_once_and_fits(B, H):
    plan = lstm.lstm_plan(B, H, SMS, SMEM)
    b, u, blk, thr = _owners(plan, B, H)
    # every (row, unit) pair has exactly one owner
    key = b.astype(np.int64) * H + u
    assert np.array_equal(np.sort(key), np.arange(B * H))
    # ... and a thread carries at most one pair per n-tile it owns
    _, per_thread = np.unique(blk.astype(np.int64) * lstm.THREADS + thr,
                              return_counts=True)
    assert per_thread.max() <= plan["ntw"]
    # one block per SM: the cooperative launch must be co-resident
    assert plan["grid"] == plan["nh"] * plan["nb"] <= SMS
    assert plan["nh"] * plan["k"] >= H and plan["nb"] * plan["Bs"] >= B
    assert plan["wm"] * plan["wn"] <= lstm.WARPS and plan["Bs"] <= \
        16 * plan["wm"] and 1 <= plan["ntw"] <= lstm.MAX_TILES
    # the shared-memory layout fits: weight slice, then the h ring
    w_bytes = 16 * plan["k"] * plan["kp"] if plan["w_smem"] else 0
    assert plan["ring_off"] * 4 == w_bytes
    assert plan["smem"] == w_bytes + 4 * plan["stages"] \
        * plan["stage_floats"] <= SMEM
    assert 2 <= plan["stages"] <= lstm.MAX_STAGES
    assert plan["hp"] % plan["kc"] == 0 and plan["hp"] >= H
    assert plan["kc"] % 16 == 0          # whole pairs of k-steps a chunk
    # bank-conflict-free slice rows (kp = 4 mod 8 words); ring rows are
    # kc words, swizzled
    assert plan["kp"] % 8 == 4 and plan["kp"] >= plan["hp"]
    assert plan["stage_floats"] == 16 * plan["wm"] * plan["kc"]
    # the weight slice is resident wherever any slice fits: the smallest
    # (fewest units a block) beside the smallest ring (two 16-column
    # slots of one 16-row tile) must not fit when it is not
    if not plan["w_smem"]:
        k0 = next(k for k in range(2, 4 * H + 3, 2) if -(-H // k) <= SMS)
        assert 4 * (4 * k0 * (-(-H // 16) * 16 + 4) + 2 * 16 * 16) > SMEM


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="no work split"):
        lstm.lstm_plan(128, 512, 1, 1024)


# -- the kernel's arithmetic: products on TF32 tensor cores


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


def test_3xtf32_recurrence_holds_the_fp32_tolerance_and_tf32_does_not():
    """The kernel splits each operand into two TF32 parts and sums three
    products.  Over 100 steps at H=512 that stays within chip_smoke's
    LSTM_TOL (1e-4 of max(1, magnitude)) of the float32 loop; a single
    TF32 product does not, which is why the kernel splits."""
    tol = 1e-4
    Bn, Tn, Hn = 8, 100, 512
    r = np.random.RandomState(3)
    x = torch.tensor((r.randn(Bn, Tn, 4 * Hn) * 0.5).astype(np.float32))
    w = torch.tensor((r.randn(Hn, 4 * Hn) * Hn ** -0.5).astype(np.float32))
    bias = torch.tensor((r.randn(7 * Hn) * 0.1).astype(np.float32))
    lens = torch.full((Bn,), Tn, dtype=torch.int32)
    # the rounding is the one the card's conversion makes
    probe = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -11)])
    assert _tf32(probe).tolist() == [1 + 2 ** -10, 1 + 2 ** -10,
                                     -(1 + 2 ** -10)]
    errs = {}
    want = lstm.lstm_forward_plain(x, w, bias, lens)
    mag = max(1.0, *(float(t.abs().max()) for t in want))
    for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32)):
        got = lstm.lstm_forward_plain(x, w, bias, lens, matmul=mm)
        errs[name] = max(float((g - e).abs().max())
                         for g, e in zip(got, want))
    assert errs["3xtf32"] <= tol * mag, errs
    assert errs["tf32"] > tol * mag, errs
