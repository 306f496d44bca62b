"""The port's control flow (``fluid/ops/control_flow_ops.py``,
``fluid/layers/control_flow.py``, the sub-block runner in
``fluid/lowering.py``) and the tensor and sequence ops the seq2seq
models add, against the JAX package on the CPU.

* Every op without a sub-block (the compare, logical and tensor-array
  ops, ``increment``, the rank table and its relatives, IfElse's split
  and merge, the rank reorder, ``fill_constant_batch_size_like``,
  ``squeeze``, ``unsqueeze``, ``expand``, ``sequence_expand`` and
  ``sequence_pad``) through both emitters on the same seeded arrays:
  integer and boolean outputs exactly, float outputs and the gradient of
  sum(out * w) (where the op has one) within OUT_TOL (float32,
  summation order only).
* The ops with a sub-block (``while`` bounded and not, ``recurrent``,
  ``dynamic_recurrent``, ``conditional_block``) through programs, the
  reference's ``tests/test_control_flow.py`` mirrored (the array sum in
  a While, a bounded While's gradient, StaticRNN, DynamicRNN masking
  finished sequences under SGD, Switch, the array and lod-array round
  trips) and IfElse, plus a reversed DynamicRNN with a static sequence
  input, a memory from a fed var and two step outputs: each builder
  serializes to the reference's bytes (main and startup program), and
  the port's Executor gives the JAX Executor's fetches from the same
  initialized scope (OUT_TOL; the DynamicRNN's SGD steps PARAM_ATOL).
* The plan: a ``while`` without ``max_iters`` is a host loop (the card
  runs its step eagerly), a bounded one is not; the host loop reads its
  condition once per iteration and once to stop; both executors count
  the same cache hits and misses over the same runs.  A dropout inside
  a DynamicRNN body is seeded from the step's seed buffer: one mask
  for every time step, as the reference's fixed step key gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import lod as jlod
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu.fluid.ops import control_flow_ops as jcf
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.lowering import BlockPlan
from paddle_tpu_torch.fluid.ops import control_flow_ops as tcf
from tests.test_torch_amp import _emit

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-6
PACKAGES = {"jax": (jfluid, jlod, jcf, jnp.asarray),
            "port": (tfluid, tlod, tcf, torch.tensor)}

# -- ops without a sub-block ------------------------------------------------
#
# An input spec is ("t", array), ("seq", data, lengths), ("ta", data,
# size) or ("rt", lengths); the float data of the slots named in a
# case's ``wrt`` are the leaves its gradient is taken against.

LENS = np.array([3, 1, 4], np.int32)


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _value(pkg, spec, leaf=None):
    _, lod, cf, conv = PACKAGES[pkg]
    kind, data = spec[0], spec[1]
    d = conv(data) if leaf is None else leaf
    if kind == "t":
        return d
    if kind == "seq":
        return lod.SeqArray(d, conv(spec[2]))
    if kind == "ta":
        return cf.TensorArray(d, conv(np.int32(spec[2])))
    return cf.RankTable(conv(data))


def _numpy(v):
    """An output value as a tuple of numpy arrays."""
    if isinstance(v, (jlod.SeqArray, tlod.SeqArray)):
        return _numpy(v.data) + _numpy(v.lengths)
    if isinstance(v, (jcf.TensorArray, tcf.TensorArray)):
        return _numpy(v.data) + _numpy(v.size)
    if isinstance(v, (jcf.RankTable, tcf.RankTable)):
        return _numpy(v.lengths)
    if isinstance(v, torch.Tensor):
        return (v.detach().numpy(),)
    return (np.asarray(v),)


def _float_part(v):
    if isinstance(v, (jlod.SeqArray, tlod.SeqArray, jcf.TensorArray,
                      tcf.TensorArray)):
        return v.data
    return v


OP_CASES = {
    "less_than": ({"X": ("t", np.array([1, 5, 3], np.int32)),
                   "Y": ("t", np.array([2, 5, 1], np.int32))}, {}, ()),
    "less_equal": ({"X": ("t", np.array([1., 5., 3.], np.float32)),
                    "Y": ("t", np.array([2., 5., 1.], np.float32))}, {}, ()),
    "greater_than": ({"X": ("t", np.array([1, 5, 3], np.int32)),
                      "Y": ("t", np.array([2, 5, 1], np.int32))}, {}, ()),
    "greater_equal": ({"X": ("seq", _r(0, 3, 4), LENS),
                       "Y": ("seq", _r(1, 3, 4), LENS)}, {}, ()),
    "equal": ({"X": ("t", np.array([1, 5, 3], np.int32)),
               "Y": ("t", np.array([2, 5, 1], np.int32))}, {}, ()),
    "not_equal": ({"X": ("t", np.array([1, 5, 3], np.int32)),
                   "Y": ("t", np.array([2, 5, 1], np.int32))}, {}, ()),
    "logical_and": ({"X": ("t", np.array([1, 1, 0, 0], bool)),
                     "Y": ("t", np.array([1, 0, 1, 0], bool))}, {}, ()),
    "logical_or": ({"X": ("t", np.array([1, 1, 0, 0], bool)),
                    "Y": ("t", np.array([1, 0, 1, 0], bool))}, {}, ()),
    "logical_xor": ({"X": ("t", np.array([1, 1, 0, 0], bool)),
                     "Y": ("t", np.array([1, 0, 1, 0], bool))}, {}, ()),
    "logical_not": ({"X": ("t", np.array([1, 0], bool))}, {}, ()),
    "increment/int": ({"X": ("t", np.array([4], np.int32))},
                      {"step": 1.0}, ()),
    "increment/float": ({"X": ("t", np.array([0.25], np.float32))},
                        {"step": 0.1}, ()),
    "lod_rank_table/seq": ({"X": ("seq", _r(2, 3, 4, 2), LENS)}, {}, ()),
    "lod_rank_table/dense": ({"X": ("t", _r(2, 3, 4, 2))}, {}, ()),
    "max_sequence_len": ({"RankTable": ("rt", LENS)}, {}, ()),
    "write_to_array/first": ({"X": ("t", _r(3, 2, 3)),
                              "I": ("t", np.array([1], np.int32))},
                             {"capacity": 4}, ("X",)),
    "write_to_array/again": ({"X": ("t", _r(3, 2, 3)),
                              "I": ("t", np.array([2], np.int32)),
                              "Array": ("ta", _r(4, 4, 2, 3), 1)},
                             {"capacity": 4}, ("X", "Array")),
    "write_to_array/past_capacity": ({"X": ("t", _r(3, 2, 3)),
                                      "I": ("t", np.array([4], np.int32)),
                                      "Array": ("ta", _r(4, 4, 2, 3), 2)},
                                     {"capacity": 4}, ("X", "Array")),
    "read_from_array": ({"X": ("ta", _r(5, 4, 2, 3), 3),
                         "I": ("t", np.array([2], np.int32))}, {}, ("X",)),
    "read_from_array/clamped": ({"X": ("ta", _r(5, 4, 2, 3), 3),
                                 "I": ("t", np.array([7], np.int32))},
                                {}, ("X",)),
    "array_length": ({"X": ("ta", _r(5, 4, 2, 3), 3)}, {}, ()),
    "lod_tensor_to_array": ({"X": ("seq", _r(6, 3, 4, 2), LENS),
                             "RankTable": ("rt", LENS)}, {}, ("X",)),
    "array_to_lod_tensor": ({"X": ("ta", _r(7, 4, 3, 2), 4),
                             "RankTable": ("rt", LENS)}, {}, ("X",)),
    "shrink_rnn_memory": ({"X": ("t", _r(8, 3, 2)),
                           "RankTable": ("rt", LENS),
                           "I": ("t", np.array([1], np.int32))}, {},
                          ("X",)),
    "split_lod_tensor/dense": ({"X": ("t", _r(9, 3, 2)),
                                "Mask": ("t", np.array([[1], [0], [1]],
                                                       bool))},
                               {"level": 0}, ("X",)),
    "split_lod_tensor/seq": ({"X": ("seq", _r(9, 3, 4, 2), LENS),
                              "Mask": ("t", np.array([[0], [1], [1]],
                                                     bool))},
                             {"level": 0}, ("X",)),
    "merge_lod_tensor": ({"InTrue": ("t", _r(10, 3, 2)),
                          "InFalse": ("t", _r(11, 3, 2)),
                          "Mask": ("t", np.array([[1], [0], [1]], bool))},
                         {"level": 0}, ("InTrue", "InFalse")),
    "reorder_lod_tensor_by_rank": ({"X": ("seq", _r(12, 4, 3, 2),
                                          np.array([2, 3, 2, 1], np.int32)),
                                    "RankTable": ("rt", np.array(
                                        [2, 3, 2, 1], np.int32))},
                                   {}, ("X",)),
    "fill_constant_batch_size_like": ({"Input": ("seq", _r(13, 3, 4, 2),
                                                 LENS)},
                                      {"shape": [-1, 5], "dtype": "int64",
                                       "value": 7.0}, ()),
    "squeeze": ({"X": ("t", _r(14, 3, 1, 4, 1))}, {"axes": [3]}, ("X",)),
    "unsqueeze": ({"X": ("t", _r(15, 3, 4))}, {"axes": [2, 0]}, ("X",)),
    "expand": ({"X": ("t", _r(16, 3, 1, 2))}, {"expand_times": [1, 4, 2]},
               ("X",)),
    "sequence_expand": ({"X": ("t", _r(17, 3, 2)),
                         "Y": ("seq", _r(18, 3, 4, 5), LENS)}, {}, ("X",)),
    "sequence_pad": ({"X": ("seq", _r(19, 3, 4, 2), LENS)}, {}, ("X",)),
}


def _run_op(pkg, op_type, specs, attrs, leaves=None):
    leaves = leaves or {}
    ins = {s: [_value(pkg, spec, leaves.get(s))] for s, spec in specs.items()}
    reg, Desc = (jreg, JOpDesc) if pkg == "jax" else (treg, TOpDesc)
    return _emit(reg, Desc, op_type, ins, attrs)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op_type = case.split("/")[0]
    specs, attrs, wrt = OP_CASES[case]
    jo, to = _run_op("jax", op_type, specs, attrs), \
        _run_op("port", op_type, specs, attrs)
    assert sorted(jo) == sorted(to)
    for slot in jo:
        for jv, tv in zip(jo[slot], to[slot]):
            for a, b in zip(_numpy(jv), _numpy(tv)):
                assert b.shape == a.shape, (slot, b.shape, a.shape)
                if a.dtype.kind in "biu":
                    np.testing.assert_array_equal(b, a, err_msg=slot)
                else:
                    np.testing.assert_allclose(b, a, err_msg=slot,
                                               **OUT_TOL)
    if not wrt:
        return
    out_slot = "Out" if "Out" in jo else sorted(jo)[0]
    w = np.random.RandomState(20).randn(
        *np.shape(_float_part(jo[out_slot][0]))).astype(np.float32)

    def f(*xs):
        out = _run_op("jax", op_type, specs, attrs, dict(zip(wrt, xs)))
        return (_float_part(out[out_slot][0]) * w).sum()

    jg = jax.grad(f, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(specs[s][1]) for s in wrt])
    leaves = {s: torch.tensor(specs[s][1], requires_grad=True) for s in wrt}
    out = _run_op("port", op_type, specs, attrs, leaves)
    (_float_part(out[out_slot][0]) * torch.tensor(w)).sum().backward()
    for s, g in zip(wrt, jg):
        np.testing.assert_allclose(leaves[s].grad.numpy(), np.asarray(g),
                                   err_msg=s, **OUT_TOL)


def test_op_count():
    """The 26 control-flow ops and the six tensor and sequence ops are
    registered, as the reference registers them."""
    names = {"while", "recurrent", "dynamic_recurrent", "conditional_block",
             "write_to_array", "read_from_array", "array_length",
             "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
             "array_to_lod_tensor", "shrink_rnn_memory", "increment",
             "split_lod_tensor", "merge_lod_tensor",
             "reorder_lod_tensor_by_rank", "less_than", "less_equal",
             "greater_than", "greater_equal", "equal", "not_equal",
             "logical_and", "logical_or", "logical_xor", "logical_not"}
    assert len(names) == 26
    extra = {"fill_constant_batch_size_like", "squeeze", "unsqueeze",
             "expand", "sequence_expand", "sequence_pad"}
    ported = set(treg.registered_ops())
    assert names | extra <= ported
    assert names | extra <= set(jreg.registered_ops())
    assert {c.split("/")[0] for c in OP_CASES} | {
        "while", "recurrent", "dynamic_recurrent",
        "conditional_block"} == names | extra


# -- programs: the reference's control-flow tests, mirrored -------------------

def _while_sum(fluid, layers):
    d0 = layers.data(name="d0", shape=[10], dtype="float32")
    i = layers.fill_constant(shape=[1], dtype="int64", value=0)
    i.stop_gradient = True
    table = layers.lod_rank_table(d0)
    arr = layers.lod_tensor_to_array(layers.reshape(d0, [-1, 10, 1]), table)
    mem = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    n = layers.fill_constant(shape=[1], dtype="int64", value=10)
    n.stop_gradient = True
    cond = layers.less_than(x=i, y=n)
    loop = layers.While(cond=cond)
    with loop.block():
        elem = layers.array_read(array=arr, i=i)
        summed = layers.elementwise_add(x=mem, y=layers.reduce_sum(elem))
        layers.assign(summed, mem)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=n, cond=cond)
    return [mem, i], lambda lod: {"d0": _r(30, 3, 10)}


def _bounded_while(fluid, layers):
    x = layers.data(name="x", shape=[4], dtype="float32")
    x.stop_gradient = False
    i = layers.fill_constant(shape=[1], dtype="int64", value=0)
    i.stop_gradient = True
    n = layers.fill_constant(shape=[1], dtype="int64", value=3)
    n.stop_gradient = True
    acc = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    h = layers.scale(x, scale=0.5)
    cond = layers.less_than(x=i, y=n)
    loop = layers.While(cond=cond, max_iters=8)
    with loop.block():
        s = layers.reduce_sum(layers.square(layers.elementwise_mul(x, h)))
        layers.assign(layers.elementwise_add(x=acc, y=s), acc)
        layers.assign(layers.tanh(h), h)
        layers.increment(x=i, in_place=True)
        layers.less_than(x=i, y=n, cond=cond)
    loss = layers.mean(acc)
    fluid.append_backward(loss)
    return [loss, x.name + "@GRAD", i], \
        lambda lod: {"x": np.array([[1.0, 2.0, -1.0, 0.5],
                                    [0.3, -0.7, 1.1, 0.2]], np.float32)}


def _static_rnn(fluid, layers):
    T, D, H = 5, 3, 4
    x = layers.data(name="x", shape=[T, D], dtype="float32")
    x.stop_gradient = False
    h0 = layers.data(name="h0", shape=[H], dtype="float32")
    h0.stop_gradient = False
    rnn = layers.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        hprev = rnn.memory(init=h0)
        h = layers.fc(input=[xt, hprev], size=H, act="tanh", bias_attr=False)
        rnn.update_memory(hprev, h)
        rnn.step_output(h)
    out = rnn()
    loss = layers.mean(out)
    fluid.append_backward(loss)
    params = sorted(p.name for p in
                    fluid.default_main_program().global_block()
                    .all_parameters())
    return [out, h0.name + "@GRAD", x.name + "@GRAD"] + [
        p + "@GRAD" for p in params], \
        lambda lod: {"x": _r(31, 2, T, D), "h0": _r(32, 2, H)}


def _dyn_seqs():
    rng = np.random.RandomState(2)
    return [rng.randn(4, 2).astype(np.float32),
            rng.randn(2, 2).astype(np.float32),
            rng.randn(1, 2).astype(np.float32)]


def _dynamic_rnn(fluid, layers):
    H = 3
    x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
    drnn = layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        mem = drnn.memory(shape=[H], value=0.0)
        h = layers.fc(input=[xt, mem], size=H, act="sigmoid",
                      bias_attr=False)
        drnn.update_memory(mem, h)
        drnn.output(h)
    out = drnn()
    last = layers.sequence_last_step(out)
    loss = layers.mean(last)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [out, last, loss], lambda lod: {"x": lod.make_seq(_dyn_seqs())}


def _reverse_dynamic_rnn(fluid, layers):
    """is_reverse, a static sequence input read through sequence_pool,
    a memory from an init var, and two step outputs."""
    H = 3
    x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
    ctx = layers.data(name="ctx", shape=[2], dtype="float32", lod_level=1)
    boot = layers.data(name="boot", shape=[H], dtype="float32")
    boot.stop_gradient = False
    drnn = layers.DynamicRNN(is_reverse=True)
    with drnn.block():
        xt = drnn.step_input(x)
        c = drnn.static_input(ctx)
        mem = drnn.memory(init=boot, need_reorder=True)
        pooled = layers.sequence_pool(c, pool_type="sum")
        h = layers.fc(input=[xt, mem, pooled], size=H, act="tanh")
        drnn.update_memory(mem, h)
        drnn.output(h, layers.scale(h, scale=2.0))
    out, twice = drnn()
    loss = layers.mean(layers.sequence_pool(
        layers.elementwise_add(out, twice), pool_type="sum"))
    fluid.append_backward(loss)
    return [out, twice, loss, "boot@GRAD"], lambda lod: {
        "x": lod.make_seq(_dyn_seqs()),
        "ctx": lod.make_seq([_r(33, 2, 2), _r(34, 3, 2), _r(35, 1, 2)]),
        "boot": _r(36, 3, H)}


def _switch(fluid, layers):
    x = layers.data(name="x", shape=[1], dtype="float32")
    zero = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    one = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    out = layers.fill_constant(shape=[1], dtype="float32", value=-1.0)
    with layers.Switch() as sw:
        with sw.case(layers.less_than(x=x, y=zero)):
            layers.assign(layers.fill_constant(shape=[1], dtype="float32",
                                               value=10.0), out)
        with sw.case(layers.less_than(x=x, y=one)):
            layers.assign(layers.fill_constant(shape=[1], dtype="float32",
                                               value=20.0), out)
        with sw.default():
            layers.assign(layers.fill_constant(shape=[1], dtype="float32",
                                               value=30.0), out)
    return [out], None


def _array_roundtrip(fluid, layers):
    x = layers.data(name="x", shape=[3], dtype="float32")
    i0 = layers.fill_constant(shape=[1], dtype="int64", value=0)
    i1 = layers.fill_constant(shape=[1], dtype="int64", value=1)
    arr = layers.array_write(x, i0, capacity=4)
    doubled = layers.scale(x, scale=2.0)
    layers.array_write(doubled, i1, array=arr)
    r0 = layers.array_read(arr, i0)
    r1 = layers.array_read(arr, i1)
    ln = layers.array_length(arr)
    return [r0, r1, ln], lambda lod: {"x": _r(37, 2, 3)}


def _lod_array_roundtrip(fluid, layers):
    x = layers.data(name="x", shape=[4], dtype="float32", lod_level=1)
    table = layers.lod_rank_table(x)
    arr = layers.lod_tensor_to_array(x, table)
    back = layers.array_to_lod_tensor(arr, table)
    ml = layers.max_sequence_len(table)
    reordered = layers.reorder_lod_tensor_by_rank(x, table)
    return [back, ml, reordered], lambda lod: {"x": lod.make_seq(
        [np.ones((3, 4), np.float32), 2 * np.ones((5, 4), np.float32),
         3 * np.ones((5, 4), np.float32)])}


def _if_else(fluid, layers):
    x = layers.data(name="x", shape=[3], dtype="float32")
    x.stop_gradient = False
    limit = layers.fill_constant([1], "float32", 1.5)
    cond = layers.less_than(x=layers.reduce_sum(x, dim=1, keep_dim=True),
                            y=limit)
    ie = layers.IfElse(cond)
    with ie.true_block():
        d = ie.input(x)
        ie.output(layers.scale(d, scale=2.0))
    with ie.false_block():
        d = ie.input(x)
        ie.output(layers.tanh(d))
    merged, = ie()
    loss = layers.mean(merged)
    fluid.append_backward(loss)
    return [merged, "x@GRAD"], lambda lod: {"x": np.asarray(
        [[0.1, 0.2, 0.3], [0.9, 0.9, 0.9], [-1.0, 0.5, 0.2]], np.float32)}


BUILDERS = {"while_sum": _while_sum, "bounded_while": _bounded_while,
            "static_rnn": _static_rnn, "dynamic_rnn": _dynamic_rnn,
            "reverse_dynamic_rnn": _reverse_dynamic_rnn, "switch": _switch,
            "array_roundtrip": _array_roundtrip,
            "lod_array_roundtrip": _lod_array_roundtrip,
            "if_else": _if_else}


def build(pkg, name):
    fluid = PACKAGES[pkg][0]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch, feed = BUILDERS[name](fluid, fluid.layers)
    return main, startup, fetch, feed


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_program_bytes_match_reference(name):
    jm, js, _, _ = build("jax", name)
    tm, ts, _, _ = build("port", name)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    assert len(tm.blocks) > 1 or name in ("array_roundtrip",
                                          "lod_array_roundtrip", "if_else")


def _flat(v):
    if isinstance(v, (jlod.SeqArray, tlod.SeqArray)):
        return [np.asarray(v.data), np.asarray(v.lengths)]
    return [np.asarray(v)]


def _run_both(name, feeds, steps=1):
    """Both packages' executors on the CPU from the JAX package's
    initialized scope: the fetches of ``steps`` runs of each feed, the
    final scopes."""
    jm, js, fetch, _ = build("jax", name)
    tm, _, _, _ = build("port", name)
    fetch = [f if isinstance(f, str) else f.name for f in fetch]
    scope, exe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    want = []
    with jfluid.scope_guard(scope):
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.vars
                if scope.find_var(n) is not None}
        startup_stats = exe.cache_stats()
        for feed in feeds:
            for _ in range(steps):
                want.append(exe.run(jm, feed=feed(jlod), fetch_list=fetch,
                                    return_numpy=False))
        jstate = {n: np.asarray(scope.find_var(n)) for n in init}
    cpu = tfluid.CPUPlace()
    tscope, texe = tfluid.scope_from_numpy(init, cpu), tfluid.Executor(cpu)
    got = [texe.run(tm, feed=feed(tlod), fetch_list=fetch, scope=tscope,
                    return_numpy=False)
           for feed in feeds for _ in range(steps)]
    counts = {k: {c: (exe.cache_stats()[k][c] - startup_stats[k][c],
                      texe.cache_stats()[k][c]) for c in ("hits", "misses")}
              for k in ("executable", "structure")}
    return want, got, jstate, tfluid.scope_to_numpy(tscope, list(init)), \
        counts


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_program_runs_as_the_reference(name):
    if name == "switch":
        feeds = [lambda lod, v=v: {"x": np.array([[v]], np.float32)}
                 for v in (-5.0, 0.5, 7.0)]
    else:
        feeds = [build("port", name)[3]]
    steps = 3 if name == "dynamic_rnn" else 1
    want, got, jstate, tstate, _ = _run_both(name, feeds, steps)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            for x, y in zip(_flat(a), _flat(b)):
                assert y.shape == x.shape
                if x.dtype.kind in "biu":
                    np.testing.assert_array_equal(y, x)
                else:
                    np.testing.assert_allclose(y, x, **OUT_TOL)
    for n in jstate:
        np.testing.assert_allclose(tstate[n], jstate[n], rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)
    if name == "switch":
        assert [float(np.asarray(g[0]).reshape(())) for g in got] == [
            10.0, 20.0, 30.0]
    if name == "dynamic_rnn":
        data = np.asarray(got[0][0].data)
        assert np.all(data[1, 2:] == 0) and np.all(data[2, 1:] == 0)
    if name == "bounded_while":
        assert int(np.asarray(got[0][2]).reshape(())) == 3


def test_host_loop_plan_and_condition_reads():
    """A while without max_iters is a host loop; with max_iters it is
    not.  The array sum's loop runs 10 iterations and reads its
    condition 11 times, and a second run at the same signature is a hit
    in both executors."""
    tm, _, fetch, _ = build("port", "while_sum")
    plan = BlockPlan(tm.desc.global_block(), ["d0"], [fetch[0].name],
                     program=tm.desc)
    assert plan.host_loops == ["while"] and plan.sub_blocks
    with pytest.raises(ValueError, match="needs the program"):
        BlockPlan(tm.desc.global_block(), ["d0"], [fetch[0].name])
    bm, _, bfetch, _ = build("port", "bounded_while")
    bplan = BlockPlan(bm.desc.global_block(), ["x"], [bfetch[0].name],
                      program=bm.desc)
    assert bplan.host_loops == [] and bplan.sub_blocks
    feed = build("port", "while_sum")[3]
    tcf.HOST_LOOP.update(iterations=0, reads=0)
    want, got, _, _, counts = _run_both("while_sum", [feed, feed])
    assert tcf.HOST_LOOP == {"iterations": 20, "reads": 22}
    np.testing.assert_allclose(np.asarray(got[1][0]).sum(),
                               _r(30, 3, 10).sum(), rtol=1e-5)
    # (the JAX executor's, the port's) after the startup program
    assert counts == {k: {"hits": (1, 1), "misses": (1, 1)}
                      for k in ("executable", "structure")}


def test_print_raises_naming_the_op():
    """``layers.Print`` now builds the reference's ``print`` op (it raised
    before the op was ported): the program's bytes are the reference's,
    and the plan keeps the op live and marks the step uncapturable
    (``tests/test_torch_pipeline_io.py`` runs it)."""
    progs = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.layers.data(name="x", shape=[3], dtype="float32")
            assert fluid.layers.Print(x, message="m") is x
        progs[pkg] = main
    assert progs["port"].serialize_to_string() == \
        progs["jax"].serialize_to_string()
    plan = BlockPlan(progs["port"].desc.global_block(), ["x"], [],
                     program=progs["port"].desc)
    assert [op.type for op in plan.ops] == ["print"]
    assert plan.prints == ["print"]


def test_sub_block_random_ops_are_seeded():
    """A dropout inside a DynamicRNN body has its salt in the plan's seed
    buffer; every time step draws the same mask (the reference's fixed
    step key), a step's draws repeat under the same program seed and
    step, and the next step draws anew."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 9
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data(name="x", shape=[64], dtype="float32",
                               lod_level=1)
        drnn = tfluid.layers.DynamicRNN()
        with drnn.block():
            drnn.output(tfluid.layers.dropout(drnn.step_input(x), 0.5))
        out = drnn()
    salt = next(op for op in main.blocks[1].ops
                if op.type == "dropout").attr("__rng_salt__")
    plan = BlockPlan(main.desc.global_block(), ["x"], [out.name],
                     program=main.desc)
    assert plan.salts == [salt]
    feed = {"x": tlod.make_seq([np.ones((3, 64), np.float32)] * 2)}

    def run(scope):
        return tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed=feed, fetch_list=[out], scope=scope,
            return_numpy=False)[0].data.numpy()

    a, b = run(tfluid.Scope()), run(tfluid.Scope())
    np.testing.assert_array_equal(a, b)
    assert set(np.unique(a)) == {0.0, 2.0}
    np.testing.assert_array_equal(a[:, 0], a[:, 1])   # one mask a step
    scope = tfluid.Scope()
    run(scope)
    assert not np.array_equal(run(scope), a)           # step 2 draws anew
