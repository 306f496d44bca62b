"""``lstmp`` (the LSTM with a recurrent projection) and its layer
``dynamic_lstmp`` in the port against the JAX package, on the CPU.

* The op's emitter on the same seeded numpy inputs in both packages,
  over peepholes x direction x initial state and one case of other
  activations, with ragged lengths that include 0 and 1: Projection and
  Cell within 1e-5, and the gradients of Input, Weight, ProjWeight, Bias,
  H0 and C0 (autograd through the port's step loop against ``jax.vjp``
  of the reference's scan) within 1e-5.  float32 on both sides,
  summation order only, over 9 steps of width 6 projected to 4.
* The reference's ``tests/test_ops_misc.py`` case: shapes, finite
  values, and a zero ProjWeight changes the output (the projection feeds
  back).
* ``bench.py``'s RNN benchmark model with ``dynamic_lstmp`` in place of
  each ``dynamic_lstm`` (``size`` counts cells, the JAX package's
  convention) serializes to the same bytes in both packages, and 3 Adam
  steps from the reference's scope (``Weight``, ``ProjWeight`` and
  ``Bias`` copied by ``scope_from_numpy``) give its losses within 1e-5
  relative and its parameters within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.core.lod import SeqArray as JSeq
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.core.lod import SeqArray as TSeq

OP_TOL = dict(rtol=0, atol=1e-5)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
B, T, SIZE, PROJ = 5, 9, 6, 4
LENGTHS = np.array([9, 0, 4, 1, 7], np.int32)

CASES = [dict(use_peepholes=p, is_reverse=r, init=i)
         for p in (False, True) for r in (False, True) for i in (False, True)]
CASES.append(dict(use_peepholes=True, is_reverse=False, init=True,
                  gate_activation="relu", cell_activation="identity",
                  candidate_activation="sigmoid", proj_activation="identity"))


def _case_id(c):
    return (f"{'peep' if c['use_peepholes'] else 'nopeep'}-"
            f"{'rev' if c['is_reverse'] else 'fwd'}-"
            f"{'h0c0' if c['init'] else 'zero'}"
            + ("-acts" if "gate_activation" in c else ""))


def _inputs(case, seed=1):
    r = np.random.RandomState(seed)
    arr = {"Input": (r.randn(B, T, 4 * SIZE) * 0.5).astype(np.float32),
           "Weight": (r.randn(PROJ, 4 * SIZE) * 0.3).astype(np.float32),
           "ProjWeight": (r.randn(SIZE, PROJ) * 0.3).astype(np.float32),
           "Bias": (r.randn(1, (7 if case["use_peepholes"] else 4) * SIZE)
                    * 0.2).astype(np.float32)}
    if case["init"]:
        arr["H0"] = r.randn(B, PROJ).astype(np.float32)
        arr["C0"] = r.randn(B, SIZE).astype(np.float32)
    return arr, {k: v for k, v in case.items() if k != "init"}


def _desc(cls, attrs, arrays):
    return cls("lstmp", {s: [s] for s in arrays},
               {"Projection": ["r"], "Cell": ["c"]}, attrs)


def _jax_op(arrays, attrs):
    info = jreg.get_op_info("lstmp")
    ctx = jreg.EmitCtx(_desc(JOpDesc, attrs, arrays))
    names = list(arrays)

    def f(*xs):
        ins = {n: [x] for n, x in zip(names, xs)}
        ins["Input"] = [JSeq(ins["Input"][0], jnp.asarray(LENGTHS))]
        out = info.emit(ctx, ins)
        return out["Projection"][0].data, out["Cell"][0].data

    return f


def _port_op(arrays, attrs, leaves):
    info = treg.get_op_info("lstmp")
    ins = {n: [t] for n, t in leaves.items()}
    ins["Input"] = [TSeq(leaves["Input"], torch.tensor(LENGTHS))]
    out = info.emit(treg.EmitCtx(_desc(TOpDesc, attrs, arrays)), ins)
    return out["Projection"][0], out["Cell"][0]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_lstmp_matches_reference(case):
    arrays, attrs = _inputs(case)
    r = np.random.RandomState(2)
    dr = r.randn(B, T, PROJ).astype(np.float32)
    dc = r.randn(B, T, SIZE).astype(np.float32)
    (want_r, want_c), vjp = jax.vjp(
        _jax_op(arrays, attrs), *[jnp.asarray(a) for a in arrays.values()])
    want_g = vjp((jnp.asarray(dr), jnp.asarray(dc)))
    leaves = {n: torch.tensor(a, requires_grad=True)
              for n, a in arrays.items()}
    got_r, got_c = _port_op(arrays, attrs, leaves)
    assert isinstance(got_r, TSeq) and isinstance(got_c, TSeq)
    np.testing.assert_array_equal(got_r.lengths.numpy(), LENGTHS)
    assert got_r.data.shape == (B, T, PROJ)
    assert got_c.data.shape == (B, T, SIZE)
    pad = np.arange(T)[None, :] >= LENGTHS[:, None]
    for got, want in ((got_r, want_r), (got_c, want_c)):
        got = got.data.detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), **OP_TOL)
        assert not got[pad].any()
    got_g = torch.autograd.grad((got_r.data, got_c.data),
                                list(leaves.values()),
                                (torch.tensor(dr), torch.tensor(dc)))
    for name, g, w in zip(arrays, got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **OP_TOL)


def test_projection_feeds_back():
    """The reference's case: shapes and finite values; zeroing
    ProjWeight changes the projection."""
    arrays, attrs = _inputs(dict(use_peepholes=True, is_reverse=False,
                                 init=False), seed=15)
    leaves = {n: torch.tensor(a) for n, a in arrays.items()}
    r, c = _port_op(arrays, attrs, leaves)
    assert np.isfinite(r.data.numpy()).all()
    zero = dict(leaves, ProjWeight=torch.zeros(SIZE, PROJ))
    r0, _ = _port_op(arrays, attrs, zero)
    assert not np.allclose(r.data.numpy(), r0.data.numpy())


LSTMP = dict(vocab=50, emb=8, hidden=8, proj=4)


def build_bench_lstmp(fluid):
    """chip_smoke's phase-33 LSTMP classifier (bench.py's RNN benchmark
    model with ``dynamic_lstmp(hidden, proj)`` for each LSTM) at small
    widths."""
    return chip_smoke.build_rnn_benchmark(fluid, cell="lstmp", **LSTMP)


def test_lstmp_model_trains_as_the_reference():
    jm, js, jcost = build_bench_lstmp(jfluid)
    tm, ts, tcost = build_bench_lstmp(tfluid)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    shapes = {s: tm.global_block().var(op.input(s)[0]).shape
              for op in tm.global_block().ops if op.type == "lstmp"
              for s in ("Weight", "ProjWeight", "Bias")}
    assert shapes == {"Weight": (LSTMP["proj"], 4 * LSTMP["hidden"]),
                      "ProjWeight": (LSTMP["hidden"], LSTMP["proj"]),
                      "Bias": (1, 7 * LSTMP["hidden"])}
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        seqs = [rng.randint(0, LSTMP["vocab"], (n, 1))
                for n in rng.randint(1, 11, 6)]
        batches.append((seqs, rng.randint(0, 2, (6, 1)).astype(np.int64)))
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        want = [float(np.asarray(exe.run(
            jm, feed={"words": jfluid.make_seq(s, dtype=np.int32,
                                               max_len=10), "label": y},
            fetch_list=[jcost])[0])) for s, y in batches]
        after = {n: np.asarray(scope.find_var(n)) for n in init}
    cpu = tfluid.CPUPlace()
    tscope = tfluid.scope_from_numpy(init, cpu)
    texe = tfluid.Executor(cpu)
    got = [float(texe.run(
        tm, feed={"words": tfluid.make_seq(s, dtype=np.int32, max_len=10),
                  "label": y}, fetch_list=[tcost], scope=tscope)[0])
        for s, y in batches]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    got_params = tfluid.scope_to_numpy(tscope, list(init))
    for n in init:
        np.testing.assert_allclose(got_params[n], after[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    assert sum(not np.array_equal(after[n], init[n]) for n in init) >= 10
