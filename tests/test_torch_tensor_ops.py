"""The general tensor and reduce ops of the port
(``fluid/ops/tensor_ops.py``: ``gather``, ``scatter``, ``slice``,
``split``, ``one_hot``, ``shape``, ``multiplex``,
``truncated_gaussian_random``; ``fluid/ops/math_ops.py``:
``reduce_mean`` / ``max`` / ``min`` / ``prod`` and the SeqArray rules
of the whole reduce family), the initializers and nets that use them,
against the JAX package on the CPU.

* Each op through both emitters on the same seeded arrays: integer
  outputs exactly, float outputs and the gradient of sum(out * w) over
  every output (where the op has one) within OUT_TOL (float32,
  summation order only).  The cases hold repeated indices (``gather``,
  ``scatter`` adding), out-of-range ids (``one_hot``: a zero row), ties
  (``reduce_max`` / ``min``: the gradient shared), zeros
  (``reduce_prod``: one and two zeros in a row), SeqArray inputs
  (feature dims kept as a sequence, ``reduce_sum`` over everything
  masked) and the time-axis reduce that both packages refuse.
  ``scatter`` overwriting is held on unique ids only: with a repeated
  id the reference's ``.at[].set`` leaves open which update wins.
* ``truncated_gaussian_random``, ``TruncatedNormal`` and ``MSRA`` by
  statistics (range, mean, standard deviation): the reference's
  threefry bits cannot be reproduced.  Their startup programs
  serialize to the reference's bytes.
* ``nets.glu`` and ``nets.scaled_dot_product_attention``: the programs
  serialize to the reference's bytes, and the port's Executor gives the
  JAX Executor's outputs on the same feeds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.core import lod as jlod
from paddle_tpu.fluid.core import registry as jreg
from paddle_tpu.fluid.core.desc import OpDesc as JOpDesc
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.core import lod as tlod
from paddle_tpu_torch.fluid.core import registry as treg
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from tests.test_torch_amp import _emit

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
LENS = np.array([3, 1, 4], np.int32)


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ties(seed, *shape):
    """Small integers as float32: many equal values in a row."""
    return np.random.RandomState(seed).randint(0, 3, shape) \
        .astype(np.float32)


def _with_zeros(seed, *shape):
    x = np.random.RandomState(seed).uniform(0.5, 1.5, shape) \
        .astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0, 1] = 0.0                       # one zero in a row
    flat[1, 0] = flat[1, 2] = 0.0          # two zeros in a row
    return x


# slot -> ("t", array) | ("seq", data, lengths) | ("list", [arrays])
OP_CASES = {
    "gather/repeated": ({"X": ("t", _r(0, 6, 3)),
                         "Index": ("t", np.array([0, 2, 2, 5, 0, 2],
                                                 np.int32))}, {}, ("X",)),
    "gather/3d": ({"X": ("t", _r(1, 5, 2, 3)),
                   "Index": ("t", np.array([[4], [1], [4]], np.int32))},
                  {}, ("X",)),
    "scatter/add_repeated": ({"X": ("t", _r(2, 5, 3)),
                              "Ids": ("t", np.array([1, 3, 1, 1], np.int32)),
                              "Updates": ("t", _r(3, 4, 3))},
                             {"overwrite": False}, ("X", "Updates")),
    "scatter/overwrite_unique": ({"X": ("t", _r(4, 5, 3)),
                                  "Ids": ("t", np.array([4, 0, 2], np.int32)),
                                  "Updates": ("t", _r(5, 3, 3))},
                                 {}, ("X", "Updates")),
    "slice/negative": ({"X": ("t", _r(6, 4, 5, 6))},
                       {"axes": [0, 2], "starts": [1, -4],
                        "ends": [3, 100]}, ("X",)),
    "split/num": ({"X": ("t", _r(7, 4, 6))}, {"num": 3, "axis": 1},
                  ("X",)),
    "split/sections": ({"X": ("t", _r(8, 5, 4))},
                       {"sections": [1, 3, 1], "axis": 0}, ("X",)),
    "one_hot/out_of_range": ({"X": ("t", np.array([[1], [3], [0], [7], [-1]],
                                                  np.int32))},
                             {"depth": 4}, ()),
    "one_hot/2d": ({"X": ("t", np.array([[2, 0, 1], [1, 1, 3]], np.int32))},
                   {"depth": 4}, ()),
    "shape": ({"X": ("t", _r(9, 2, 3, 4))}, {}, ()),
    "shape/seq": ({"X": ("seq", _r(10, 3, 4, 2), LENS)}, {}, ()),
    "multiplex": ({"Ids": ("t", np.array([[1], [0], [2], [1]], np.int32)),
                   "X": ("list", [_r(11, 4, 5), _r(12, 4, 5),
                                  _r(13, 4, 5)])}, {}, ("X",)),
    "reduce_mean/dims": ({"X": ("t", _r(14, 3, 4, 5))},
                         {"dim": [0, 2], "keep_dim": False}, ("X",)),
    "reduce_mean/all": ({"X": ("t", _r(15, 3, 4))},
                        {"reduce_all": True, "keep_dim": True}, ("X",)),
    "reduce_max/ties": ({"X": ("t", _ties(16, 4, 6))}, {"dim": [1]},
                        ("X",)),
    "reduce_max/all_ties": ({"X": ("t", _ties(17, 3, 5))},
                            {"reduce_all": True}, ("X",)),
    "reduce_min/ties": ({"X": ("t", _ties(18, 2, 3, 5))},
                        {"dim": [-1], "keep_dim": True}, ("X",)),
    "reduce_prod/zeros": ({"X": ("t", _with_zeros(19, 4, 5))},
                          {"dim": [1]}, ("X",)),
    "reduce_prod/dims": ({"X": ("t", _with_zeros(20, 3, 2, 4))},
                         {"dim": [0, 2], "keep_dim": True}, ("X",)),
    "reduce_prod/all": ({"X": ("t", _with_zeros(21, 2, 4))},
                        {"reduce_all": True}, ("X",)),
    "reduce_sum/seq_all": ({"X": ("seq", _r(22, 3, 4, 2), LENS)},
                           {"reduce_all": True}, ("X",)),
    "reduce_mean/seq_feature": ({"X": ("seq", _r(23, 3, 4, 5), LENS)},
                                {"dim": [2]}, ("X",)),
    "reduce_max/seq_feature": ({"X": ("seq", _ties(24, 3, 4, 2, 3),
                                      LENS)},
                               {"dim": [-1, 2], "keep_dim": True}, ("X",)),
}

# a reduce over a sequence's time axis: both packages refuse it
RAISE_CASES = {
    "reduce_sum/seq_time": ({"X": ("seq", _r(25, 3, 4, 2), LENS)},
                            {"dim": [1]}),
    "reduce_max/seq_all": ({"X": ("seq", _r(26, 3, 4, 2), LENS)},
                           {"reduce_all": True}),
    "reduce_prod/seq_batch": ({"X": ("seq", _r(27, 3, 4, 2), LENS)},
                              {"dim": [0, 2]}),
}

PKG = {"jax": (jreg, JOpDesc, jlod, jnp.asarray),
       "port": (treg, TOpDesc, tlod, torch.tensor)}


def _value(pkg, spec, leaves):
    """The input value of ``spec``; ``leaves`` replace its float arrays
    (one each, in order)."""
    _, _, lod, conv = PKG[pkg]
    arrays = spec[1] if spec[0] == "list" else [spec[1]]
    vals = [conv(a) if leaves is None else leaves[i]
            for i, a in enumerate(arrays)]
    if spec[0] == "seq":
        return [lod.SeqArray(vals[0], conv(spec[2]))]
    return vals


def _run(pkg, op_type, specs, attrs, leaves=None):
    reg, Desc, _, _ = PKG[pkg]
    leaves = leaves or {}
    ins = {s: _value(pkg, spec, leaves.get(s)) for s, spec in specs.items()}
    return _emit(reg, Desc, op_type, ins, attrs)


def _parts(v):
    if isinstance(v, (jlod.SeqArray, tlod.SeqArray)):
        return [v.data, v.lengths]
    return [v]


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _floats(spec):
    return spec[1] if spec[0] == "list" else [spec[1]]


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op_type = case.split("/")[0]
    specs, attrs, wrt = OP_CASES[case]
    jo, to = _run("jax", op_type, specs, attrs), \
        _run("port", op_type, specs, attrs)
    assert sorted(jo) == sorted(to)
    for slot in jo:
        assert len(jo[slot]) == len(to[slot])
        for jv, tv in zip(jo[slot], to[slot]):
            assert isinstance(jv, jlod.SeqArray) == \
                isinstance(tv, tlod.SeqArray)
            for a, b in zip(map(_np, _parts(jv)), map(_np, _parts(tv))):
                assert b.shape == a.shape, (slot, b.shape, a.shape)
                if a.dtype.kind in "biu":
                    assert b.dtype.kind in "biu"
                    np.testing.assert_array_equal(b, a, err_msg=slot)
                else:
                    assert b.dtype == a.dtype, (b.dtype, a.dtype)
                    np.testing.assert_allclose(b, a, err_msg=slot,
                                               **OUT_TOL)
    if not wrt:
        return
    outs = [_parts(v)[0] for v in jo["Out"]]
    ws = [np.asarray(np.random.RandomState(30 + i).randn(*np.shape(o)),
                     np.float32) for i, o in enumerate(outs)]
    sizes = [len(_floats(specs[s])) for s in wrt]

    def f(*xs):
        leaves, k = {}, 0
        for s, n in zip(wrt, sizes):
            leaves[s], k = list(xs[k:k + n]), k + n
        out = _run("jax", op_type, specs, attrs, leaves)["Out"]
        return sum((_parts(o)[0] * w).sum() for o, w in zip(out, ws))

    flat = [a for s in wrt for a in _floats(specs[s])]
    jg = jax.grad(f, argnums=tuple(range(len(flat))))(
        *[jnp.asarray(a) for a in flat])
    tl = [torch.tensor(a, requires_grad=True) for a in flat]
    leaves, k = {}, 0
    for s, n in zip(wrt, sizes):
        leaves[s], k = tl[k:k + n], k + n
    out = _run("port", op_type, specs, attrs, leaves)["Out"]
    sum((_parts(o)[0] * torch.tensor(w)).sum()
        for o, w in zip(out, ws)).backward()
    for i, (t, g) in enumerate(zip(tl, jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   err_msg=f"grad {i}", **OUT_TOL)


@pytest.mark.parametrize("case", sorted(RAISE_CASES))
def test_reduce_over_sequence_time_raises(case):
    op_type = case.split("/")[0]
    specs, attrs = RAISE_CASES[case]
    for pkg in ("jax", "port"):
        with pytest.raises(NotImplementedError, match="time axis"):
            _run(pkg, op_type, specs, attrs)


def test_reduce_max_gradient_shared_among_ties():
    """The gradient of a max over equal values is shared equally, as
    JAX shares it (``torch.max(dim)``'s indices would give it all to
    one)."""
    x = torch.tensor([[2.0, 1.0, 2.0, 2.0]], requires_grad=True)
    out = _run("port", "reduce_max", {"X": ("t", None)}, {"dim": [1]},
               {"X": [x]})["Out"][0]
    out.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [[1 / 3, 0, 1 / 3, 1 / 3]],
                               rtol=1e-6)


def test_scatter_adding_repeated_ids_sums_in_a_fixed_order():
    """Repeated ids' updates are summed by ``segment_sum`` (no
    ``index_add_``), and gather's gradient the same way: twice the same
    call, the same bits."""
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(4, 8).astype(np.float32))
    ids = torch.tensor(rng.randint(0, 4, 64).astype(np.int32))
    upd = torch.tensor(rng.randn(64, 8).astype(np.float32) * 1e3)
    a, b = (_run("port", "scatter", {"X": ("t", None), "Ids": ("t", None),
                                     "Updates": ("t", None)},
                 {"overwrite": False},
                 {"X": [x], "Ids": [ids], "Updates": [upd]})["Out"][0]
            for _ in range(2))
    assert torch.equal(a, b)
    want = x.double().index_add(0, ids.long(), upd.double())
    np.testing.assert_allclose(a.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-2)


def _draw(op_type, attrs, seed):
    ctx = treg.EmitCtx(TOpDesc(op_type, {}, {}, attrs), seed=seed)
    return treg.get_op_info(op_type).emit(ctx, {})["Out"][0].numpy()


# the standard deviation of a standard normal truncated to [-2, 2]
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(2 / math.sqrt(2)))


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (0.5, 0.02)])
def test_truncated_gaussian_random_statistics(mean, std):
    attrs = {"shape": [200, 500], "dtype": "float32", "mean": mean,
             "std": std}
    x = _draw("truncated_gaussian_random", attrs, seed=11)
    ref = np.asarray(jreg.get_op_info("truncated_gaussian_random").emit(
        jreg.EmitCtx(JOpDesc("truncated_gaussian_random", {}, {}, attrs),
                     rng=jax.random.PRNGKey(11)), {})["Out"][0])
    n = x.size
    for a in (x, ref):
        assert a.shape == (200, 500) and a.dtype == np.float32
        assert a.min() >= mean - 2 * std - 1e-6 * std
        assert a.max() <= mean + 2 * std + 1e-6 * std
        # mean and std within 5 standard errors of the distribution's
        assert abs(a.mean() - mean) < 5 * std * TRUNC_STD / math.sqrt(n)
        assert abs(a.std() / std - TRUNC_STD) < 5 * 0.6 / math.sqrt(n)
    assert np.array_equal(x, _draw("truncated_gaussian_random", attrs, 11))
    assert not np.array_equal(x, _draw("truncated_gaussian_random", attrs,
                                       12))


def _init_program(fluid, init, shape):
    """The startup program of an fc whose [in, out] weight ``w`` has
    ``init``."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [shape[0]], "float32")
        fluid.layers.fc(x, size=shape[1], bias_attr=False,
                        param_attr=fluid.ParamAttr(name="w",
                                                   initializer=init(fluid)))
    return startup


INITS = {
    "TruncatedNormal": (lambda f: f.initializer.TruncatedNormal(0.1, 0.5),
                        "trunc", (0.1, 0.5)),
    "MSRA/uniform": (lambda f: f.initializer.MSRA(), "uniform", None),
    "MSRA/normal": (lambda f: f.initializer.MSRA(uniform=False), "normal",
                    None),
    "MSRA/fan_in": (lambda f: f.initializer.MSRA(fan_in=50), "uniform",
                    None),
}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializer_program_and_statistics(name):
    init, kind, loc_scale = INITS[name]
    shape = [400, 300]
    js, ts = (_init_program(f, init, shape) for f in (jfluid, tfluid))
    assert ts.serialize_to_string() == js.serialize_to_string()
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(ts, scope=scope)
    w = tfluid.scope_to_numpy(scope, ["w"])["w"]
    assert w.shape == tuple(shape)
    n = w.size
    fan_in = 50 if name.endswith("fan_in") else shape[0]
    if kind == "trunc":
        mean, std = loc_scale
        assert mean - 2 * std <= w.min() and w.max() <= mean + 2 * std
        sd = std * TRUNC_STD
    elif kind == "uniform":
        mean, lim = 0.0, math.sqrt(6.0 / fan_in)
        assert -lim <= w.min() and w.max() <= lim
        assert w.max() > 0.99 * lim and w.min() < -0.99 * lim
        sd = lim / math.sqrt(3)
    else:
        mean, sd = 0.0, math.sqrt(2.0 / fan_in)
    assert abs(w.mean() - mean) < 5 * sd / math.sqrt(n)
    assert abs(w.std() / sd - 1) < 0.02


def _glu(fluid):
    x = fluid.layers.data("x", [6, 8], "float32")
    return [fluid.nets.glu(x, dim=-1), fluid.nets.glu(x, dim=1)]


def _sdpa(fluid):
    q = fluid.layers.data("q", [5, 8], "float32")
    k = fluid.layers.data("k", [7, 8], "float32")
    v = fluid.layers.data("v", [7, 4], "float32")
    return [fluid.nets.scaled_dot_product_attention(q, k, v)]


NETS = {"glu": (_glu, {"x": _r(40, 3, 6, 8)}),
        "scaled_dot_product_attention": (
            _sdpa, {"q": _r(41, 2, 5, 8), "k": _r(42, 2, 7, 8),
                    "v": _r(43, 2, 7, 4)})}


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_reference(name):
    build, feed = NETS[name]
    progs = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs = build(fluid)
        progs[pkg] = (main, outs)
    assert progs["port"][0].serialize_to_string() == \
        progs["jax"][0].serialize_to_string()
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            progs["jax"][0], feed=feed, fetch_list=progs["jax"][1])
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        progs["port"][0], feed=feed, fetch_list=progs["port"][1],
        scope=tfluid.Scope())
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, np.asarray(a), **OUT_TOL)
