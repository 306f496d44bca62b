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
* bf16 (the op on bf16 parameters, ``dynamic_lstm(dtype="bfloat16")``):
  the port's emitter on bf16 inputs against the reference's, over the
  same cases and one of T=20, H=16: Hidden and Cell within 2e-2 absolute
  (measured: at most 7.8e-3, two bf16 ulps at magnitude 1-2; the two
  sides round at the same points, XLA may keep more precision between
  them), padding exactly 0, in bf16.  The gradients: the port's backward
  computes in float32 from the bf16 states, the reference's vjp in bf16,
  so each is held against the reference's float32 gradient on the same
  (bf16-valued) inputs: the port's relative L2 distance within
  max(1e-2, the bf16 vjp's own distance) (measured: at most 6e-3; the
  bf16 vjp's up to 7e-2 where relu gates flip).  The RNN benchmark model
  with bf16 LSTMs (``layers.cast`` before and after) serializes to the
  same bytes in both packages (its LSTM parameters bf16 through
  ``ParamAttr(keep_dtype=True)``) and one step from the reference's scope
  (bf16 parameters copied) gives its loss within 1e-3 relative
  (measured 3.5e-5) and its gradients within 5e-2 relative L2
  (measured at most 1.1e-2).
* The wrapper refuses what it does not run: dtypes other than float32 and
  bf16, mixed dtypes, unknown activations, devices other than the CPU
  and CUDA; a bf16 call on the CPU is the plain loop's, bit for bit.
* The kernel's work split at an H100's limits, for its fp32 and its
  bf16 kernel.
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.lod import SeqArray as JSeq
from paddle_tpu_torch import fluid as tfluid
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


# -- bf16: the op on bf16 parameters

BF16_OUT_ATOL = 2e-2
BF16_GRAD_FLOOR = 1e-2
BF16_CASES = [(c, (B, T, H, LENGTHS)) for c in CASES] + [
    (dict(use_peepholes=True, is_reverse=False, init=True),
     (6, 20, 16, np.array([20, 0, 5, 1, 17, 20], np.int32)))]


def _bf16(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16)


def _op_pair(arrays, attrs, lengths):
    """(the reference's emitter as a function of the arrays, the port's
    as a function of a dict of tensors) -> (Hidden data, Cell data)."""
    jinfo, tinfo = (jreg.get_op_info("dynamic_lstm"),
                    treg.get_op_info("dynamic_lstm"))
    jctx = jreg.EmitCtx(_desc(JOpDesc, attrs, arrays))
    tctx = treg.EmitCtx(_desc(TOpDesc, attrs, arrays))
    names = list(arrays)

    def jf(*xs):
        ins = {n: [x] for n, x in zip(names, xs)}
        ins["Input"] = [JSeq(ins["Input"][0], jnp.asarray(lengths))]
        out = jinfo.emit(jctx, ins)
        return out["Hidden"][0].data, out["Cell"][0].data

    def tf(leaves):
        ins = {n: [t] for n, t in leaves.items()}
        ins["Input"] = [TSeq(leaves["Input"], torch.tensor(lengths))]
        out = tinfo.emit(tctx, ins)
        return out["Hidden"][0].data, out["Cell"][0].data

    return jf, tf


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case,shape", BF16_CASES,
                         ids=[_case_id(c) + f"-T{s[1]}" for c, s in
                              BF16_CASES])
def test_dynamic_lstm_bf16_matches_reference(case, shape):
    b, t, h, lengths = shape
    r = np.random.RandomState(1)
    arrays = {"Input": r.randn(b, t, 4 * h) * 0.5,
              "Weight": r.randn(h, 4 * h) * 0.3,
              "Bias": r.randn((7 if case["use_peepholes"] else 4) * h) * 0.2}
    if case["init"]:
        arrays["H0"], arrays["C0"] = r.randn(b, h), r.randn(b, h)
    # bf16 values, held as float32 for the float32 reference
    arrays = {n: _bf16(a).astype(np.float32) for n, a in arrays.items()}
    attrs = {k: v for k, v in case.items() if k != "init"}
    dh = _bf16(r.randn(b, t, h)).astype(np.float32)
    dc = _bf16(r.randn(b, t, h)).astype(np.float32)
    jf, tf = _op_pair(arrays, attrs, lengths)
    (want_h, want_c), vjp_bf16 = jax.vjp(
        jf, *[jnp.asarray(_bf16(a)) for a in arrays.values()])
    want_bf16 = vjp_bf16((jnp.asarray(_bf16(dh)), jnp.asarray(_bf16(dc))))
    _, vjp_f32 = jax.vjp(jf, *[jnp.asarray(a) for a in arrays.values()])
    want_f32 = vjp_f32((jnp.asarray(dh), jnp.asarray(dc)))

    leaves = {n: torch.tensor(a).bfloat16().requires_grad_(True)
              for n, a in arrays.items()}
    got_h, got_c = tf(leaves)
    assert got_h.dtype == got_c.dtype == torch.bfloat16
    pad = np.arange(t)[None, :] >= lengths[:, None]
    for got, want in ((got_h, want_h), (got_c, want_c)):
        got = got.detach().float().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=0, atol=BF16_OUT_ATOL)
        assert not got[pad].any()
    got = torch.autograd.grad(
        (got_h, got_c), list(leaves.values()),
        (torch.tensor(dh).bfloat16(), torch.tensor(dc).bfloat16()))
    for name, g, wb, wf in zip(arrays, got, want_bf16, want_f32):
        assert g.dtype == torch.bfloat16, name
        ours, theirs = _rel_l2(g.float(), wf), _rel_l2(wb, wf)
        assert ours <= max(BF16_GRAD_FLOOR, theirs), (name, ours, theirs)


BF16_BENCH = dict(vocab=50, emb=8, hidden=8)


def build_bench_bf16(fluid):
    """chip_smoke's phase-33 bf16 RNN benchmark model (each fc's output
    cast to bf16 before ``dynamic_lstm(dtype="bfloat16")``, the last step
    cast back to float32 before the softmax fc) at small widths.  Its
    LSTMs' parameters are bf16 through ``ParamAttr(keep_dtype=True)``:
    without it both packages keep float32 master weights
    (``LayerHelper``), and the reference's step cannot carry bf16 state
    beside them."""
    return chip_smoke.build_rnn_benchmark(fluid, cell="lstm_bf16",
                                          **BF16_BENCH)


def test_bf16_rnn_benchmark_step_matches_reference():
    jm, js, jcost = build_bench_bf16(jfluid)
    tm, ts, tcost = build_bench_bf16(tfluid)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    lstm_params = [op.input(s)[0] for op in tm.global_block().ops
                   if op.type == "dynamic_lstm" for s in ("Weight", "Bias")]
    assert all(tm.global_block().var(n).dtype == "bfloat16"
               for n in lstm_params) and len(lstm_params) == 4
    r = np.random.RandomState(5)
    seqs = [r.randint(0, BF16_BENCH["vocab"], (n, 1)) for n in (10, 3, 1, 7)]
    label = r.randint(0, 2, (4, 1)).astype(np.int64)

    def feed(make_seq):
        return {"words": make_seq(seqs, dtype=np.int32, max_len=10),
                "label": label}
    params = [p.name for p in tm.global_block().all_parameters()]
    fetch = [tcost.name] + [n + "@GRAD" for n in params]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = exe.run(jm, feed=feed(jfluid.make_seq), fetch_list=fetch)
    assert init[lstm_params[0]].dtype.name == "bfloat16"
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    assert tscope.find_var(lstm_params[0]).dtype == torch.bfloat16
    got = tfluid.Executor(cpu).run(tm, feed=feed(tfluid.make_seq),
                                   fetch_list=fetch, scope=tscope)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-3)
    for n, g, w in zip(params, got[1:], want[1:]):
        assert _rel_l2(g, w) <= 5e-2, (n, _rel_l2(g, w))


def test_wrapper_refuses_what_it_does_not_run():
    x = torch.zeros(2, 3, 16)
    w, b = torch.zeros(4, 16), torch.zeros(28)
    lens = torch.full((2,), 3, dtype=torch.int32)
    # bf16 runs on the CPU as the plain loop in bf16 (the CUDA kernel's
    # counterpart); float16 and mixed dtypes are refused
    r = np.random.RandomState(4)
    xb, wb, bb = (torch.tensor(r.randn(*t.shape).astype(np.float32))
                  .bfloat16() for t in (x, w, b))
    got = lstm.lstm_forward(xb, wb, bb, lens)
    want = lstm.lstm_forward_plain(xb, wb, bb, lens)
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        lstm.lstm_forward(x.half(), w.half(), b.half(), lens)
    with pytest.raises(ValueError, match="share x's dtype"):
        lstm.lstm_forward(xb, w, bb, lens)
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


@pytest.mark.parametrize("elem", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("H", [1, 200, 256, 512, 1000, 1280, 1848, 2048])
@pytest.mark.parametrize("B", [1, 4, 100, 128])
def test_plan_covers_every_pair_once_and_fits(B, H, elem):
    plan = lstm.lstm_plan(B, H, SMS, SMEM, elem)
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
    w_bytes = 4 * elem * plan["k"] * plan["kp"] if plan["w_smem"] else 0
    assert plan["ring_off"] * elem == w_bytes
    assert plan["smem"] == w_bytes + elem * plan["stages"] \
        * plan["stage_elems"] <= SMEM
    assert 2 <= plan["stages"] <= lstm.MAX_STAGES
    assert plan["hp"] % plan["kc"] == 0 and plan["hp"] >= H
    # whole pairs of the mma's k-steps a chunk (8 fp32, 16 bf16 values:
    # 32 bytes), at most 16 pieces of 16 bytes a ring row
    assert plan["kc"] * elem % 64 == 0 and plan["kc"] * elem <= 256
    # bank-conflict-free slice rows (a pitch of 16 mod 32 bytes); ring
    # rows are kc values, swizzled
    assert plan["kp"] * elem % 32 == 16 and plan["kp"] >= plan["hp"]
    assert plan["stage_elems"] == 16 * plan["wm"] * plan["kc"]
    # the weight slice is resident wherever any slice fits: the smallest
    # (fewest units a block) beside the smallest ring (two 64-byte slots
    # of one 16-row tile) must not fit when it is not
    if not plan["w_smem"]:
        k0 = next(k for k in range(2, 4 * H + 3, 2) if -(-H // k) <= SMS)
        c0 = 64 // elem
        assert elem * (4 * k0 * (-(-H // c0) * c0 + 16 // elem)
                       + 2 * 16 * c0) > SMEM


def test_bf16_slice_stays_resident_to_a_wider_h():
    """The bf16 slice takes half the bytes: at B=128 on an H100 the
    widest H whose slice stays in shared memory is 1320 in fp32 and 1848
    in bf16 (chip_smoke's ``resident_edge`` cases)."""
    for elem, edge in ((4, 1320), (2, 1848)):
        assert lstm.lstm_plan(128, edge, SMS, SMEM, elem)["w_smem"]
        assert not lstm.lstm_plan(128, edge + 1, SMS, SMEM, elem)["w_smem"]


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
