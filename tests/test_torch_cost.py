"""The port's cost model (``paddle_tpu_torch.fluid.analysis.cost``,
``comms``, ``recompile``) and the HBM admission it feeds, against the
JAX package's, on the CPU.

* The golden op costs of ``tests/test_cost_analysis.py`` (mul, matmul,
  conv2d, cache_write, the int8 paged write, the ragged attention, the
  conservative default, the derived grad rule): one-op programs built by
  the reference, the same bytes parsed by both packages, and the port's
  ``op_cost`` equal to the reference's and to the hand-computed numbers,
  flops and bytes, bit for bit.
* ``plan_program`` (peak, coordinates, components, top-k, timelines) on
  the seeded program, a 2-layer Transformer training step, the small
  paged generator's unified program (every pool dtype) and the book
  nets; ``roofline`` at one explicit ``ChipSpec`` built alike; the
  comms report of a sharded program; the recompile lint.  All equal.
* Every HBM estimate equal to the reference's: ``estimate_generator_hbm``,
  ``estimate_speculative_hbm`` and the generator's, the speculative
  pair's and the engine's ``static_hbm_estimate``.
* The fault this slice repairs: a scheduler budget below a model's
  estimate refuses it with the reference's ``HBMBudgetError`` and
  ``suggested_model_axis``, before any lane opens; a budget at the
  estimate admits it, and ``stats()`` reports what the reference's does.
* ``CHIP_SPECS`` holds the H100 and no TPU; ``get_chip``'s order.
* ``profiler.op_cost_table``'s products (mul, matmul, conv2d and their
  grads) count the reference's flops; ``Executor.cost_analysis`` is the
  table's totals.
"""

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.analysis import cost as jcost
from paddle_tpu.fluid.analysis.dataflow import ProgramView as JView
from paddle_tpu.fluid.core.desc import OpDesc, VarDesc
from paddle_tpu.serving import paged_decoder as jpd
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving import speculative as jspec
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.analysis import cost as tcost
from paddle_tpu_torch.fluid.analysis.dataflow import ProgramView as TView
from paddle_tpu_torch.serving import paged_decoder as tpd
from paddle_tpu_torch.serving import scheduler as tsched
from paddle_tpu_torch.serving import speculative as tspec

from op_test import OpTestCase
from tests.test_torch_analysis import (CLEAN, _ref_program, analyze_both,
                                       parse_both)

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def one_chip(monkeypatch):
    """Both packages price at one ChipSpec built alike: the port's H100
    entry, added to the reference's table and named by the flag both
    read."""
    from tests.test_torch_analysis import same_chip

    monkeypatch.setenv("PADDLE_TPU_CHIP", same_chip(monkeypatch))


def _op_costs(main):
    """(reference, port) OpCost of the last op of ``main``'s global block,
    each package over its own parse of the same bytes."""
    jp, tp = parse_both(main)
    out = []
    for prog, cost, view in ((jp, jcost, JView), (tp, tcost, TView)):
        env = cost.CostEnv(view(prog.desc), 0)
        c = cost.op_cost(env, prog.global_block().desc.ops[-1])
        out.append((c.flops, c.bytes_read, c.bytes_written, c.registered))
    return out


def _one_op(op_type, inputs, attrs=None, n_outputs=None):
    t = OpTestCase(op_type, inputs, attrs=attrs, n_outputs=n_outputs)
    main, *_ = t._build(t._discover_outputs(), infer_shape=True)
    return main


N_PAGES, N_LAYER, PAGE, H, D = 4, 1, 4, 2, 4
ROWS = N_PAGES * N_LAYER * 2
KV_ELEMS = 2 * (2 * 1 * H * D)

# (inputs, attrs, n_outputs, (flops, bytes read, bytes written)): the
# hand-computed goldens of tests/test_cost_analysis.py
GOLDEN = {
    "mul": ({"X": np.ones((4, 8), np.float32),
             "Y": np.ones((8, 16), np.float32)}, None, {"Out": 1},
            (2.0 * 4 * 16 * 8, (4 * 8 + 8 * 16) * 4, 4 * 16 * 4)),
    "matmul": ({"X": np.ones((2, 4, 8), np.float32),
                "Y": np.ones((2, 8, 16), np.float32)}, None, {"Out": 1},
               (2.0 * (2 * 4 * 16) * 8, (2 * 4 * 8 + 2 * 8 * 16) * 4,
                2 * 4 * 16 * 4)),
    "conv2d": ({"Input": np.ones((2, 3, 8, 8), np.float32),
                "Filter": np.ones((4, 3, 3, 3), np.float32)},
               {"strides": [1, 1], "paddings": [1, 1]}, {"Output": 1},
               (2.0 * (2 * 4 * 8 * 8) * 3 * 3 * 3,
                (2 * 3 * 8 * 8 + 4 * 3 * 3 * 3) * 4, 2 * 4 * 8 * 8 * 4)),
    "cache_write": ({"Cache": np.zeros((2, 16, 2, 4), np.float32),
                     "Value": np.ones((2, 1, 2, 4), np.float32),
                     "Index": np.zeros(1, np.int32)}, {"axis": 1},
                    {"Out": 1},
                    (0.0, 2 * 1 * 2 * 4 * 4 + 4, 2 * 1 * 2 * 4 * 4)),
    "quantized_paged_cache_write": (
        {"Pool": np.zeros((H, ROWS, PAGE, D), np.int8),
         "Scales": np.zeros((1, ROWS, PAGE), np.float32),
         "K": np.ones((2, 1, H, D), np.float32),
         "V": np.ones((2, 1, H, D), np.float32),
         "Pages": np.ones((2, 1), np.int32),
         "Offsets": np.zeros((2, 1), np.int32)},
        {"layer": 0, "n_layer": N_LAYER}, {"Out": 1, "ScalesOut": 1},
        (6.0 * KV_ELEMS, KV_ELEMS * 4 + 2 * 1 * 4 * 2,
         KV_ELEMS * 1 + 2 * (2 * 1) * 4)),
    "ragged_decode_attention": (
        {"Q": np.ones((2, 1, H, D), np.float32),
         "Pool": np.zeros((H, ROWS, PAGE, D), np.int8),
         "PageTable": np.ones((2, 2), np.int32),
         "Lengths": np.ones(2, np.int32),
         "QBase": np.zeros(2, np.int32),
         "Scales": np.zeros((1, ROWS, PAGE), np.float32)},
        {"layer": 0, "n_layer": N_LAYER, "causal": True}, {"Out": 1},
        (4.0 * 2 * 1 * H * (2 * PAGE) * D,
         2.0 * 2 * 2 * PAGE * H * D + 2 * 1 * H * D * 4 + 2 * 2 * 4 + 2 * 4
         + 2.0 * 2 * 2 * PAGE * 4, None)),
}


@pytest.mark.parametrize("op_type", sorted(GOLDEN))
def test_golden_op_costs_match_reference(op_type):
    inputs, attrs, n_out, want = GOLDEN[op_type]
    jc, tc = _op_costs(_one_op(op_type, inputs, attrs, n_out))
    assert tc == jc
    got = tc[:3] if want[2] is not None else tc[:2]
    assert got == tuple(w for w in want if w is not None) and tc[3]


def _desc_program(ops, vars_):
    main = jfluid.Program()
    b = main.global_block().desc
    for name, kw in vars_.items():
        b.add_var(VarDesc(name, **kw))
    for op in ops:
        b.append_op(op)
    return main


def test_default_and_derived_grad_rules_match_reference():
    mystery = _desc_program(
        [OpDesc("mystery_op", {"X": ["x"]}, {"Out": ["y"]}, {})],
        {"x": dict(shape=[4, 4]), "y": dict(shape=[4, 4])})
    jc, tc = _op_costs(mystery)
    assert tc == jc == (16.0, 64.0, 64.0, False)
    jd, td = analyze_both(mystery, level="cost", fetch=["y"])
    assert len(td.by_code("unregistered-cost-rule")) == 1
    grad = _desc_program(
        [OpDesc("mul_grad", {"X": ["x"], "Y": ["w"], "Out@GRAD": ["og"]},
                {"X@GRAD": ["xg"]}, {})],
        {"x": dict(shape=[4, 8]), "w": dict(shape=[8, 16]),
         "og": dict(shape=[4, 16]), "xg": dict(shape=[4, 8])})
    jc, tc = _op_costs(grad)
    assert tc == jc and tc[0] == 2.0 * (2.0 * 4 * 16 * 8) and tc[3]


# -- the planner and the roofline -------------------------------------------------

def seeded_plan_program():
    """x -> mul w -> h -> concat -> c -> relu -> r (aliases c) ->
    reduce_sum -> out: peak 5120 bytes at op#1 (tests/test_cost_analysis)."""
    return _desc_program(
        [OpDesc("mul", {"X": ["x"], "Y": ["w"]}, {"Out": ["h"]}, {}),
         OpDesc("concat", {"X": ["h", "h"]}, {"Out": ["c"]}, {"axis": 1}),
         OpDesc("relu", {"X": ["c"]}, {"Out": ["r"]}, {}),
         OpDesc("reduce_sum", {"X": ["r"]}, {"Out": ["out"]}, {})],
        {"x": dict(shape=[8, 16]), "w": dict(shape=[16, 32],
                                             persistable=True),
         "h": dict(shape=[8, 32]), "c": dict(shape=[8, 64]),
         "r": dict(shape=[8, 64]), "out": dict(shape=[1])})


def plans_equal(jplan, tplan):
    """Peak, coordinates, components, top-k and every block's timeline
    and contributors (the to_dict of both plans) equal."""
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.top(8) == jplan.top(8)
    assert tplan.describe() == jplan.describe()


def _plans(program, **kw):
    jp, tp = parse_both(program)
    return jcost.plan_program(jp, **kw), tcost.plan_program(tp, **kw)


def test_seeded_plan_matches_reference_and_hand_walk():
    jplan, tplan = _plans(seeded_plan_program())
    plans_equal(jplan, tplan)
    assert tplan.peak_bytes == 5120
    assert (tplan.peak_block, tplan.peak_op) == (0, 1)
    assert tplan.components == {"params": 2048, "kv_pool": 0,
                                "activations": 3072, "feeds": 0}
    assert tplan.top(1)[0]["var"] == "c→r"
    assert tplan.blocks[0].timeline == [1536, 3072, 2048, 2052]
    for donation in (True, False):
        plans_equal(*_plans(seeded_plan_program(), assume_batch=4,
                            assume_donation=donation))
    _, tp = parse_both(seeded_plan_program())
    from paddle_tpu.fluid.analysis.cost import legacy_stats as jstats

    jp, _ = parse_both(seeded_plan_program())
    assert tcost.legacy_stats(tp) == jstats(jp)


@pytest.mark.parametrize("name", ["transformer", "conv_net", "smallnet",
                                  "word2vec", "while_loop"])
def test_program_plans_match_reference(name):
    main, _ = _ref_program(CLEAN[name])
    for batch in (1, 8):
        plans_equal(*_plans(main, assume_batch=batch))
    plans_equal(*_plans(main, assume_batch=8, assume_donation=False))


CHIP = dict(peak_flops=123e12, hbm_bw=1.5e12, hbm_bytes=24 * 2 ** 30,
            ici_bw=300e9, dcn_bw=25e9, conv_flops=61e12)


@pytest.mark.parametrize("name", ["transformer", "conv_net", "while_loop"])
def test_roofline_at_one_spec_matches_reference(name):
    main, _ = _ref_program(CLEAN[name])
    jp, tp = parse_both(main)
    for batch in (1, 16):
        jr = jcost.roofline(jp, jcost.ChipSpec("test", **CHIP), batch)
        tr = tcost.roofline(tp, tcost.ChipSpec("test", **CHIP), batch)
        assert tr.to_dict() == jr.to_dict()
        assert tr.step_time_s > 0 and tr.total_flops > 0


def test_cost_level_reports_match_reference():
    main, fetch = _ref_program(CLEAN["conv_net"])
    opts = {"assume_batch": 64, "chip": "h100", "budget_bytes": 10 ** 6}
    jd, td = analyze_both(main, level="cost", fetch=fetch, options=opts)
    assert td.reports == jd.reports
    assert [f.code for f in td.errors()] == ["over-budget"]
    assert td.reports["cost"]["roofline"]["total_flops"] > 1e8


def test_chip_specs_hold_the_card():
    assert set(tcost.CHIP_SPECS) == {"h100"}
    h = tcost.get_chip("h100")
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.ici_bw) == \
        (989e12, 3.35e12, 80 * 2 ** 30, 900e9)
    assert tcost.get_chip(h) is h
    with pytest.raises(ValueError):
        tcost.get_chip("v5e")
    # no card here, no flag: the default is the H100
    assert tcost.get_chip() is tcost.get_chip("h100")


def test_get_chip_reads_the_flag_then_the_card(monkeypatch):
    import torch

    monkeypatch.delenv("PADDLE_TPU_CHIP")
    assert tcost.get_chip() is tcost.CHIP_SPECS["h100"]
    spec = tcost.ChipSpec("other", 1e12, 1e11, 2 ** 30)
    monkeypatch.setitem(tcost.CHIP_SPECS, "other", spec)
    monkeypatch.setenv("PADDLE_TPU_CHIP", "other")
    assert tcost.get_chip() is spec
    assert tcost.get_chip("h100") is tcost.CHIP_SPECS["h100"]
    monkeypatch.delenv("PADDLE_TPU_CHIP")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert tcost.get_chip() is tcost.CHIP_SPECS["h100"]


# -- comms and the recompile lint -------------------------------------------------

def _sharded_net():
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        x = jfluid.layers.data("x", [64], "float32")
        y = jfluid.layers.data("y", [1], "float32")
        h = jfluid.layers.fc(input=x, size=128, act="relu")
        pred = jfluid.layers.fc(
            input=h, size=1,
            param_attr=jfluid.ParamAttr(name="w2", sharding=["mp", None]))
        loss = jfluid.layers.mean(jfluid.layers.square_error_cost(pred, y))
        jfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, loss


def test_comms_reports_match_reference():
    main, loss = _sharded_net()
    opts = {"assume_batch": 32, "mesh_axes": {"dp": 8, "mp": 4},
            "dcn_axes": ["dp"], "chip": "h100"}
    jp, tp = parse_both(main)
    from paddle_tpu.fluid.analysis.comms import estimate_comms as jest
    from paddle_tpu_torch.fluid.analysis.comms import estimate_comms as test

    spec = dict(peak_flops=1e12, hbm_bw=1e11, hbm_bytes=2 ** 30,
                ici_bw=300e9, dcn_bw=50e9)
    jr = jest(jp, options=dict(opts, chip=jcost.ChipSpec("c", **spec)))
    tr = test(tp, options=dict(opts, chip=tcost.ChipSpec("c", **spec)))
    assert tr.to_dict() == jr.to_dict()
    rep = tr.to_dict()
    assert len([c for c in rep["collectives"]
                if c["kind"] == "allreduce(grad-sync)"]) == 4
    assert rep["per_axis"]["dp"]["tier"] == "dcn"
    # silent on an unsharded program, as the reference
    jd, td = analyze_both(seeded_plan_program(), level="cost",
                          fetch=["out"])
    assert not td.by_pass("comms")
    assert td.reports["comms"]["collectives"] == []


def test_recompile_lint_matches_reference():
    value_shape = _desc_program(
        [OpDesc("beam_search_decode",
                {"Ids": ["ids"], "Scores": ["scores"],
                 "ParentIdx": ["parents"]},
                {"SentenceIds": ["out_ids"],
                 "SentenceScores": ["out_scores"]}, {})],
        {n: dict(shape=[-1, 1]) for n in ("ids", "scores", "parents",
                                           "out_ids", "out_scores")})
    _, td = analyze_both(value_shape, level="cost", fetch=["out_ids"])
    assert td.by_code("value-shape-op") and not td.reports["recompile"][
        "closed"]
    ragged = _desc_program(
        [OpDesc("reduce_sum", {"X": ["x"]}, {"Out": ["y"]}, {"dim": 1}),
         OpDesc("print", {"X": ["s"]}, {}, {})],
        {"x": dict(shape=[-1, -1, 4]), "s": dict(shape=[-1, 1], lod_level=1),
         "y": dict(shape=[-1, 4])})
    for opts in (None, {"batch_buckets": (2, 4), "time_buckets": (8, 16)}):
        jd, td = analyze_both(ragged, level="cost", fetch=["y"],
                              options=opts)
        assert td.reports["recompile"] == jd.reports["recompile"]
    assert td.by_code("dynamic-inner-dim")


def test_preflight_counters_key_on_level():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4], "float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(input=x, size=8))
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    feed = {"x": np.zeros((2, 4), np.float32)}
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
            validate="structural")
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                validate="cost")
    st = exe.cache_stats()["validate"]
    assert (st["runs"], st["cached"]) == (2, 1)
    assert st["by_level"] == {"structural": {"runs": 1, "cached": 0},
                              "cost": {"runs": 1, "cached": 1}}


# -- the HBM estimates and the scheduler's admission -----------------------------

GEN = dict(n_layer=2, n_head=2, d_key=4, d_value=4, d_model=16,
           d_inner_hid=32, max_length=64, src_len=8, max_out_len=8,
           page_size=4, chunk_size=4, num_pages=32)


def _config(kv_dtype="float32", prefix="tcost", **kw):
    return dict(GEN, src_vocab_size=30, trg_vocab_size=30,
                param_prefix=prefix, kv_dtype=kv_dtype, **kw)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_generator_estimates_match_reference(kv_dtype):
    cfg = _config(kv_dtype)
    variants = ({}, {"assume_lanes": 2, "assume_donation": False},
                {"verify_tokens": 5, "logit_masks": True}) \
        if kv_dtype == "int8" else ({},)
    for kw in variants:
        plans_equal(jpd.estimate_generator_hbm(cfg, **kw),
                    tpd.estimate_generator_hbm(cfg, **kw))
    want = jpd.kv_page_bytes(2, 2, 4, 4, kv_dtype) * 32
    assert tpd.estimate_generator_hbm(cfg).components["kv_pool"] == want
    with pytest.raises(NotImplementedError, match="A15"):
        tpd.estimate_generator_hbm(cfg, mesh_axes={"model": 2})
    with pytest.raises(NotImplementedError, match="A15"):
        tpd.build_manifest_program(dict(cfg, mesh_axes={"model": 2}))


def test_speculative_estimate_matches_reference():
    target, draft = _config(prefix="tgt"), _config(prefix="dft", n_layer=1)
    for k, lanes in ((4, None), (2, 3)):
        want = jspec.estimate_speculative_hbm(target, draft, k=k,
                                              assume_lanes=lanes)
        got = tspec.estimate_speculative_hbm(target, draft, k=k,
                                             assume_lanes=lanes)
        assert (got.peak_bytes, got.components) == \
            (want.peak_bytes, want.components)
        plans_equal(want.target_plan, got.target_plan)
        plans_equal(want.draft_plan, got.draft_plan)


def _generators(side, prefix="tcost", n_layer=2, scope=None, **kw):
    if side == "jax":
        cls, fl = jpd.PagedTransformerGenerator, jfluid
    else:
        cls, fl = tpd.PagedTransformerGenerator, tfluid
    gen = dict(GEN, n_layer=n_layer)
    return cls(30, 30, param_prefix=prefix, place=fl.CPUPlace(),
               scope=scope, **gen, **kw)


@pytest.fixture(scope="module")
def gens():
    return {side: _generators(side) for side in ("jax", "port")}


def test_static_estimates_match_reference(gens):
    for lanes in (None, 2, 8):
        plans_equal(gens["jax"].static_hbm_estimate(lanes),
                    gens["port"].static_hbm_estimate(lanes))
    plan = gens["port"].static_hbm_estimate()
    assert plan.components["kv_pool"] == \
        gens["port"].page_bytes * gens["port"].num_pages
    assert plan.peak_bytes == tpd.estimate_generator_hbm(
        _config()).peak_bytes
    specs = {}
    for side, fl in (("jax", jfluid), ("port", tfluid)):
        scope = fl.Scope()
        target = _generators(side, "tgt", scope=scope)
        draft = _generators(side, "dft", n_layer=1, scope=scope)
        cls = jspec.SpeculativeGenerator if side == "jax" \
            else tspec.SpeculativeGenerator
        specs[side] = cls(target, draft, k=4)
    for lanes in (None, 3):
        want = specs["jax"].static_hbm_estimate(lanes)
        got = specs["port"].static_hbm_estimate(lanes)
        assert (got.peak_bytes, got.components) == \
            (want.peak_bytes, want.components)
    got = specs["port"].static_hbm_estimate(3)
    assert got.peak_bytes == tspec.estimate_speculative_hbm(
        _config(prefix="tgt"), _config(prefix="dft", n_layer=1),
        assume_lanes=3).peak_bytes


def test_engine_estimate_matches_reference():
    from paddle_tpu.serving.engine import InferenceEngine as JEngine
    from paddle_tpu_torch.serving.engine import InferenceEngine as TEngine

    est = {}
    for side, fl, cls in (("jax", jfluid, JEngine), ("port", tfluid,
                                                     TEngine)):
        main, startup = fl.Program(), fl.Program()
        scope = fl.Scope()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data(name="x", shape=[6], dtype="float32")
            y = fl.layers.fc(input=x, size=4)
        fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
        eng = cls(program=fl.io.prune_program(main, [y]), feed_names=["x"],
                  fetch_vars=[y], scope=scope, place=fl.CPUPlace(),
                  batch_buckets=(2, 8))
        est[side] = [eng.static_hbm_estimate(b) for b in (None, 2, 256)]
    for want, got in zip(est["jax"], est["port"]):
        plans_equal(want, got)
    small, big = est["port"][1], est["port"][2]
    assert big.peak_bytes > small.peak_bytes
    assert big.components["params"] == small.components["params"]


def _hbm_stats(sched):
    st = sched.stats()
    return st["models"], st["hbm"]


def test_scheduler_refuses_what_the_reference_refuses(gens):
    """The repaired fault: a declared HBM budget refuses a paged generator
    that does not fit, with the reference's error and
    ``suggested_model_axis``, before any lane opens; at the estimate it
    admits, and ``stats()`` reports what the reference's does."""
    plan = gens["port"].static_hbm_estimate(assume_lanes=2)
    for budget in (plan.peak_bytes - 1, plan.peak_bytes // 3, 10 ** 4):
        errs = []
        for side, mod in (("jax", jsched), ("port", tsched)):
            sched = mod.ContinuousBatchingScheduler(hbm_budget_bytes=budget)
            with pytest.raises(mod.HBMBudgetError) as ei:
                sched.add_model("m@1", gens[side], 2)
            errs.append((str(ei.value), ei.value.suggested_model_axis,
                         sched.hbm_committed()))
            assert "m@1" not in sched.stats().get("models", {})
        assert errs[1] == errs[0]
    stats = []
    for side, mod in (("jax", jsched), ("port", tsched)):
        sched = mod.ContinuousBatchingScheduler(
            hbm_budget_bytes=plan.peak_bytes + 64)
        sched.add_model("m@1", gens[side], 2)
        assert not sched.can_admit_model(plan.peak_bytes)
        with pytest.raises(mod.HBMBudgetError):
            sched.add_model("m@2", gens[side], 2)
        stats.append(_hbm_stats(sched))
    assert stats[1] == stats[0]
    assert stats[1][0]["m@1"]["static_hbm_bytes"] == plan.peak_bytes
    assert stats[1][1]["committed_bytes"] == plan.peak_bytes


def test_scheduler_suggests_the_reference_model_axis(gens):
    """A budget the params and pool overrun but a model-axis shard of
    them would fit: both schedulers suggest the same axis."""
    plan = gens["port"].static_hbm_estimate(assume_lanes=2)
    comp = plan.components
    budget = comp["activations"] + comp["feeds"] + \
        (comp["params"] + comp["kv_pool"]) // 2 + 1
    got = []
    for side, mod in (("jax", jsched), ("port", tsched)):
        sched = mod.ContinuousBatchingScheduler(hbm_budget_bytes=budget)
        with pytest.raises(mod.HBMBudgetError) as ei:
            sched.add_model("m", gens[side], 2)
        got.append(ei.value.suggested_model_axis)
    assert got[1] == got[0] == 2


# -- op_cost_table and cost_analysis ---------------------------------------------

def _products(fluid):
    """conv2d -> pool -> fc (mul) -> matmul, with its backward: the three
    product ops and their grads at small shapes."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [2, 8, 8], "float32")
        conv = fluid.layers.conv2d(img, num_filters=4, filter_size=3,
                                   padding=1, act="relu")
        pool = fluid.layers.pool2d(conv, pool_size=2, pool_stride=2)
        h = fluid.layers.fc(pool, size=6)
        h2 = fluid.layers.fc(pool, size=6)
        out = fluid.layers.matmul(h, h2, transpose_y=True)
        loss = fluid.layers.mean(out)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


PRODUCTS = ("mul", "matmul", "conv2d", "mul_grad", "matmul_grad",
            "conv2d_grad")


def test_op_cost_table_products_match_reference():
    feed = {"img": np.random.RandomState(0).randn(3, 2, 8, 8)
            .astype(np.float32)}
    rows = {}
    for side, fl in (("jax", jfluid), ("port", tfluid)):
        main, startup, loss = _products(fl)
        scope = fl.Scope()
        fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
        table = fl.profiler.op_cost_table(main, feed=feed, scope=scope,
                                          print_table=False)
        rows[side] = {r["op"]: r for r in table}
        if side == "port":
            exe = tfluid.Executor(CPU)
            ca = exe.cost_analysis(main, feed=feed, scope=scope)
            assert ca == {"flops": sum(r["flops"] for r in table),
                          "bytes accessed": sum(r["bytes"] for r in table)}
    assert set(rows["port"]) == set(rows["jax"])
    products = [op for op in rows["port"] if op.split()[1] in PRODUCTS]
    assert sorted({op.split()[1] for op in products}) == sorted(PRODUCTS)
    for op in products:
        assert rows["port"][op]["flops"] == rows["jax"][op]["flops"] > 0, op
