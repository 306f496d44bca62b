"""The port's static analyzer (``paddle_tpu_torch.fluid.analysis``) against
the JAX package's, on the CPU.

* Every program is built by the reference, serialized to canonical JSON,
  and the same bytes are parsed into both packages
  (``Program.parse_from_string``); both analyzers then run at the same
  level with the same fetch roots, and their findings must be equal:
  code, severity, pass, block / op coordinates, op type, slot, var and
  message.
* The malformed programs of ``tests/test_analysis.py`` (use before write,
  write after write, dead ops, shape / dtype mismatches after
  deserialization, the grad-shape rule, sharding rank / axis / layout,
  orphan grads, grad op base lint, donation reads and interleaved host
  IO, the malformed block graph), one parametrized case each.
* Clean programs (the book's conv net and word2vec, bench.py's
  SmallNet and a 2-layer Transformer training step, the bounded while
  loop) analyze clean on both sides.
* The port's executor pre-flight (``run(validate=...)``,
  ``PADDLE_TPU_VALIDATE``) mirrors ``tests/test_analysis.py``: one
  analysis per program structure, bad programs refused, results
  unchanged; ``memory_analysis`` and ``device_time_per_step`` keep the
  reference's return keys.
* ``plint``: exit codes and ``--json`` output equal the reference's on
  the same files, ``--cost --budget`` included (both priced at one
  ``ChipSpec`` built alike); ``--shard`` exits 2, naming ROADMAP A15.
"""

import json

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.analysis import cost as jcost
from paddle_tpu.fluid.core.desc import OpDesc, VarDesc
from paddle_tpu.models import transformer as JT
from paddle_tpu.tools import plint as jplint
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.analysis import (ProgramValidationError,
                                             analyze_program,
                                             structural_errors)
from paddle_tpu_torch.fluid.analysis import cost as tcost
from paddle_tpu_torch.fluid.core.desc import OpDesc as TOpDesc
from paddle_tpu_torch.fluid.core.desc import VarDesc as TVarDesc
from paddle_tpu_torch.tools import plint as tplint

CPU = tfluid.CPUPlace()


# -- shared: programs built by the reference, parsed by both ----------------

def ref_net():
    """Small forward + backward + optimizer program (the reference's
    ``tests/test_analysis.py::_net``), built by the reference."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup), jfluid.unique_name.guard():
        x = jfluid.layers.data("x", [4], "float32")
        y = jfluid.layers.data("y", [1], "float32")
        h = jfluid.layers.fc(input=x, size=8, act="relu")
        pred = jfluid.layers.fc(input=h, size=1)
        loss = jfluid.layers.mean(jfluid.layers.square_error_cost(pred, y))
        jfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def parse_both(program_or_bytes):
    """The same canonical JSON bytes parsed by each package."""
    data = program_or_bytes if isinstance(program_or_bytes, bytes) \
        else program_or_bytes.desc.serialize_to_string()
    return (jfluid.Program.parse_from_string(data),
            tfluid.Program.parse_from_string(data))


def findings(diag):
    return [f.to_dict() for f in diag.findings]


def analyze_both(program_or_bytes, level="full", fetch=None, options=None):
    """Both analyzers over the same bytes; asserts equal findings and
    returns the (reference, port) Diagnostics."""
    jp, tp = parse_both(program_or_bytes)
    jd = jp.analyze(level=level, fetch_list=fetch, options=options)
    td = tp.analyze(level=level, fetch_list=fetch, options=options)
    assert findings(td) == findings(jd)
    return jd, td


def same_chip(monkeypatch, name="h100"):
    """One ChipSpec built alike on both sides, under one name: the port's
    H100 entry added to the reference's table for the test."""
    spec = tcost.CHIP_SPECS["h100"]
    monkeypatch.setitem(jcost.CHIP_SPECS, name, jcost.ChipSpec(
        name, spec.peak_flops, spec.hbm_bw, spec.hbm_bytes,
        ici_bw=spec.ici_bw, dcn_bw=spec.dcn_bw))
    return name


# -- malformed programs: the findings of tests/test_analysis.py ------------

def _use_before_write(b):
    b.add_var(VarDesc("late", shape=[-1, 4], dtype="float32"))
    b.add_var(VarDesc("late_out", shape=[-1, 4], dtype="float32"))
    b.ops.insert(1, OpDesc("relu", {"X": ["late"]}, {"Out": ["late_out"]},
                           {}))
    b.append_op(OpDesc("relu", {"X": ["x"]}, {"Out": ["late"]}, {}))
    return "structural", True, "use-before-write"


def _write_after_write(b):
    b.add_var(VarDesc("dup", shape=[-1, 2], dtype="float32"))
    b.append_op(OpDesc("split", {"X": ["x"]}, {"Out": ["dup", "dup"]},
                       {"num": 2}))
    return "structural", True, "write-after-write"


def _dead_op(b, fetch=True):
    b.add_var(VarDesc("deadv", shape=[-1, 4], dtype="float32"))
    b.append_op(OpDesc("relu", {"X": ["x"]}, {"Out": ["deadv"]}, {}))
    return "structural", fetch, "dead-op"


def _shape_mismatch(b):
    b.vars["fc_0.tmp_1"].shape = [7, 99]
    return "full", True, "shape-mismatch"


def _dtype_mismatch(b):
    b.vars["fc_0.tmp_1"].shape = [-1, 8]
    b.vars["fc_0.tmp_1"].dtype = "int32"
    return "full", True, "dtype-mismatch"


def _grad_shape(b):
    grads = [n for n in b.vars if "@GRAD@RENAME@" in n
             and b.vars[n].shape is not None]
    b.vars[sorted(grads)[0]].shape = [3, 3, 3]
    return "full", True, "grad-shape-mismatch"


def _param(b):
    return sorted(n for n, v in b.vars.items()
                  if v.persistable and v.shape and len(v.shape) == 2)[0]


def _sharding(b, kind):
    p = _param(b)
    if kind == "rank":
        b.vars[p].sharding = ["mp"]
        return "structural", True, "rank-mismatch"
    if kind == "axis":
        b.vars[p].sharding = ["mp", "mp"]
        return "structural", True, "axis-reuse"
    b.vars[p].sharding = ["mp", None]
    b.vars[p + "@GRAD"].sharding = [None, "mp"] if kind == "layout" \
        else ["mp", None]
    return "structural", True, ("producer-consumer-conflict"
                                if kind == "layout" else None)


def _orphan_grad(b):
    b.add_var(VarDesc("ghost@GRAD", shape=[4], dtype="float32"))
    return "structural", True, "orphan-grad"


def _grad_base(b):
    b.add_var(VarDesc("zz", shape=[4], dtype="float32"))
    b.add_var(VarDesc("zz2", shape=[4], dtype="float32"))
    b.append_op(OpDesc("no_such_thing_grad", {"X": ["zz"]},
                       {"Out": ["zz2"]}, {}))
    return "structural", True, "grad-base-unregistered"


def _save_transient(b):
    b.append_op(OpDesc("save", {"X": ["fc_0.tmp_2"]}, {},
                       {"file_path": "/tmp/x.pt"}))
    return "structural", True, "donation-read"


def _save_persistable(b):
    pname = sorted(n for n, v in b.vars.items() if v.persistable)[0]
    b.append_op(OpDesc("save", {"X": [pname]}, {},
                       {"file_path": "/tmp/x.pt"}))
    return "structural", True, None


def _host_io_interleaved(b):
    pname = sorted(n for n, v in b.vars.items() if v.persistable)[0]
    b.ops.insert(2, OpDesc("save", {"X": [pname]}, {},
                           {"file_path": "/tmp/x.pt"}))
    return "structural", True, "host-io-interleaved"


def _undeclared(b):
    b.append_op(OpDesc("relu", {"X": ["does_not_exist"]}, {"Out": ["nope"]},
                       {}))
    return "structural", False, "undeclared-input"


MALFORMED = {
    "use_before_write": _use_before_write,
    "write_after_write": _write_after_write,
    "dead_op_fetched": _dead_op,
    "dead_op_no_fetch": lambda b: _dead_op(b, fetch=False),
    "shape_mismatch": _shape_mismatch,
    "dtype_mismatch": _dtype_mismatch,
    "grad_shape": _grad_shape,
    "sharding_rank": lambda b: _sharding(b, "rank"),
    "sharding_axis_reuse": lambda b: _sharding(b, "axis"),
    "sharding_layout": lambda b: _sharding(b, "layout"),
    "sharding_consistent": lambda b: _sharding(b, "consistent"),
    "orphan_grad": _orphan_grad,
    "grad_op_base": _grad_base,
    "donation_read": _save_transient,
    "save_persistable": _save_persistable,
    "host_io_interleaved": _host_io_interleaved,
    "undeclared_vars": _undeclared,
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_findings_match_reference(case):
    main, _, loss = ref_net()
    level, fetch, code = MALFORMED[case](main.global_block().desc)
    jd, td = analyze_both(main, level=level,
                          fetch=[loss.name] if fetch else None)
    if code is not None:
        assert td.by_code(code), td.render()
    if case == "sharding_consistent":
        assert not td.by_pass("sharding"), td.render()
    if case == "save_persistable":
        assert not td.by_code("donation-read")
    if case == "dead_op_no_fetch":
        assert all(f.severity == "info" for f in td.by_code("dead-op"))
    assert td.has_errors == (case not in ("dead_op_fetched",
                                          "dead_op_no_fetch",
                                          "sharding_consistent",
                                          "save_persistable"))


def test_malformed_block_graph_findings_match_reference():
    """Lying idx/parent_idx and bogus sub-block refs give findings, not
    hangs, on both sides (``tests/test_analysis.py:478``)."""
    main, _, _ = ref_net()
    d = json.loads(main.desc.serialize_to_string())
    d["blocks"].append({"idx": 5, "parent_idx": 3, "vars": {},
                        "ops": [{"type": "relu",
                                 "inputs": {"X": ["ghost_in"]},
                                 "outputs": {"Out": ["ghost_out"]},
                                 "attrs": {"b": {"__block__": 77}}}]})
    raw = json.dumps(d, sort_keys=True, separators=(",", ":")).encode()
    _, td = analyze_both(raw, level="structural")
    msgs = [f.legacy() for f in td.errors()]
    assert any("parent_idx" in m for m in msgs)
    assert any("ghost_in" in m for m in msgs)
    assert any("sub-block index 77" in m for m in msgs)
    _, tp = parse_both(raw)
    from paddle_tpu.fluid.analysis import structural_errors as jerrors

    assert structural_errors(tp) == jerrors(parse_both(raw)[0])


# -- clean programs ------------------------------------------------------------

_BUILT = {}


def _ref_program(build):
    """(program, fetch names) built by the reference, once per process:
    the tests parse its bytes and never change it."""
    if build not in _BUILT:
        main, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, startup), \
                jfluid.unique_name.guard():
            fetch = build()
        _BUILT[build] = (main, [v.name for v in fetch])
    return _BUILT[build]


def _conv_net():
    from paddle_tpu.models import recognize_digits

    img = jfluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    label = jfluid.layers.data(name="label", shape=[1], dtype="int64")
    _, avg_cost, acc = recognize_digits.conv_net(img, label)
    jfluid.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return [avg_cost, acc]


def _word2vec():
    from paddle_tpu.models import word2vec

    words = [jfluid.layers.data(name=f"w{i}", shape=[1], dtype="int64")
             for i in range(5)]
    avg_cost, _ = word2vec.ngram_model(words, 30, embed_size=8,
                                       hidden_size=32)
    jfluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return [avg_cost]


def _smallnet():
    from paddle_tpu.models import benchmark_nets

    img = jfluid.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
    label = jfluid.layers.data(name="label", shape=[1], dtype="int64")
    pred = benchmark_nets.smallnet_cifar(img, class_num=10)
    loss = jfluid.layers.mean(jfluid.layers.cross_entropy(input=pred,
                                                          label=label))
    jfluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(loss)
    return [loss]


# bench.py's Transformer training step (fused attention, Adam) at 2 layers
# and narrow widths
SMALL_TRANSFORMER = dict(src_vocab_size=64, trg_vocab_size=64, max_length=32,
                         n_layer=2, n_head=2, d_key=8, d_value=8, d_model=16,
                         d_inner_hid=32, dropout_rate=0.1, src_seq_len=16,
                         trg_seq_len=16, fused=True)


def _transformer():
    avg_cost, _, _ = JT.transformer(**SMALL_TRANSFORMER)
    jfluid.optimizer.Adam(1e-3).minimize(avg_cost)
    return [avg_cost]


def _while_loop():
    i = jfluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
    n = jfluid.layers.fill_constant(shape=[1], dtype="int64", value=5)
    acc = jfluid.layers.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = jfluid.layers.less_than(x=i, y=n)
    loop = jfluid.layers.While(cond=cond, max_iters=8)
    with loop.block():
        jfluid.layers.increment(x=acc, value=2.0, in_place=True)
        jfluid.layers.increment(x=i, in_place=True)
        jfluid.layers.less_than(x=i, y=n, cond=cond)
    return [acc]


CLEAN = {"conv_net": _conv_net, "word2vec": _word2vec,
         "smallnet": _smallnet, "transformer": _transformer,
         "while_loop": _while_loop}


@pytest.mark.parametrize("name", sorted(CLEAN))
def test_clean_programs_analyze_clean_on_both_sides(name):
    main, fetch = _ref_program(CLEAN[name])
    _, td = analyze_both(main, level="full", fetch=fetch)
    assert not td.has_errors, td.render()
    # the Transformer's backward leaves one assign of a gradient nothing
    # reads (the reference's own finding, equal on both sides above)
    assert {f.code for f in td.warnings()} <= (
        {"dead-op"} if name == "transformer" else set()), td.render()


def test_port_built_program_analyzes_clean():
    """A program the port builds itself re-checks clean at every level
    (the shape re-check runs the port's own emitters on meta tensors)."""
    from paddle_tpu_torch.models import transformer as TT

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        avg_cost, _, _ = TT.transformer(**SMALL_TRANSFORMER)
        tfluid.optimizer.Adam(1e-3).minimize(avg_cost)
    for level in ("structural", "full", "cost"):
        d = main.analyze(level=level, fetch_list=[avg_cost])
        assert not d.has_errors, d.render()
    assert not startup.analyze(level="full").has_errors


def test_levels_and_pass_selection():
    main, _, _ = ref_net()
    _, tp = parse_both(main)
    with pytest.raises(ValueError):
        analyze_program(tp, level="everything")
    with pytest.raises(ValueError):
        analyze_program(tp, passes=("nope",))
    with pytest.raises(NotImplementedError, match="A15"):
        analyze_program(tp, level="shard")
    assert not analyze_program(tp, passes=("structural",)).findings
    # the render and the JSON round trip
    tp.global_block().desc.add_var(TVarDesc("ghost@GRAD", shape=[4],
                                            dtype="float32"))
    diag = tp.analyze(level="structural")
    assert "orphan-grad" in diag.render()
    payload = json.loads(json.dumps(diag.to_dict()))
    assert payload["counts"]["error"] == len(diag.errors()) == 1


# -- the executor pre-flight -----------------------------------------------------

def port_net():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4], "float32")
        y = tfluid.layers.data("y", [1], "float32")
        h = tfluid.layers.fc(input=x, size=8, act="relu")
        pred = tfluid.layers.fc(input=h, size=1)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _xy(rng):
    return {"x": rng.randn(4, 4).astype(np.float32),
            "y": rng.randn(4, 1).astype(np.float32)}


def test_executor_preflight_caches_by_fingerprint():
    main, startup, loss = port_net()
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    rng = np.random.RandomState(0)
    exe.run(startup, scope=scope)
    for _ in range(5):
        exe.run(main, feed=_xy(rng), fetch_list=[loss], scope=scope,
                validate="full")
    st = exe.cache_stats()["validate"]
    assert (st["runs"], st["cached"], st["size"]) == (1, 4, 1), st
    assert st["by_level"] == {"full": {"runs": 1, "cached": 4}}
    # mutating the program changes the fingerprint: analyzed again
    b = main.global_block().desc
    b.add_var(TVarDesc("extra", shape=[-1, 4], dtype="float32"))
    b.append_op(TOpDesc("relu", {"X": ["x"]}, {"Out": ["extra"]}, {}))
    main._bump_version()
    exe.run(main, feed=_xy(rng), fetch_list=[loss], scope=scope,
            validate="full")
    assert exe.cache_stats()["validate"]["runs"] == 2


def test_executor_preflight_rejects_bad_program_and_reads_the_flag(
        monkeypatch):
    main, startup, loss = port_net()
    main.global_block().desc.append_op(
        TOpDesc("relu", {"X": ["missing_input"]}, {"Out": ["nowhere"]}, {}))
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.zeros((2, 4), np.float32),
            "y": np.zeros((2, 1), np.float32)}
    with pytest.raises(ProgramValidationError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                validate="structural")
    assert "missing_input" in str(ei.value)
    assert ei.value.diagnostics.has_errors
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "structural")
    exe.run(startup, scope=tfluid.Scope())      # startup itself is clean
    with pytest.raises(ProgramValidationError):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    with pytest.raises(ProgramValidationError):      # run_steps reads it too
        exe.run_steps(main, feeds=[feed], fetch_list=[loss], scope=scope)
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "bogus")
    with pytest.raises(ValueError):
        exe.run(startup, scope=tfluid.Scope())
    monkeypatch.delenv("PADDLE_TPU_VALIDATE")
    with pytest.raises(NotImplementedError, match="A15"):
        exe.run(startup, scope=tfluid.Scope(), validate="shard")
    with pytest.raises(NotImplementedError, match="A13"):
        exe.run(startup, scope=tfluid.Scope(), guard="raise")


def test_executor_results_unchanged_by_validation():
    main, startup, loss = port_net()
    fv = _xy(np.random.RandomState(3))
    startup.random_seed = 11
    got = []
    for validate in (None, "full"):
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(startup, scope=scope, validate=validate)
        got.append([exe.run(main, feed=fv, fetch_list=[loss], scope=scope,
                            validate=validate)[0] for _ in range(3)])
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(got[1]))


def test_memory_analysis_and_device_time_keep_the_reference_keys():
    main, startup, loss = port_net()
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    before = {n: np.asarray(v).copy() for n, v in scope.vars.items()}
    feed = _xy(np.random.RandomState(1))
    ma = exe.memory_analysis(main, feed=feed, fetch_list=[loss], scope=scope)
    assert set(ma) == {"argument_bytes", "output_bytes", "temp_bytes",
                       "alias_bytes", "generated_code_bytes", "peak_bytes"}
    # feeds (4x4 + 4x1) and the 4 parameters and the learning rate read
    assert ma["argument_bytes"] == (16 + 4 + 32 + 8 + 8 + 1 + 1) * 4
    # the parameters are written in place: every output byte but the loss
    assert ma["alias_bytes"] == (32 + 8 + 8 + 1) * 4
    assert ma["output_bytes"] == ma["alias_bytes"] + 4
    # no allocator peak on the CPU
    assert np.isnan(ma["temp_bytes"]) and np.isnan(ma["peak_bytes"])
    t = exe.device_time_per_step(main, feed=feed, fetch_list=[loss],
                                 scope=scope, iters=2, trials=3)
    assert isinstance(t, float) and t > 0
    # neither touched the scope
    for n, v in before.items():
        np.testing.assert_array_equal(np.asarray(scope.find_var(n)), v)


# -- plint ---------------------------------------------------------------------

def _plint_both(argv, capsys):
    """Both CLIs on the same argv: ``(rc, stdout)`` of each."""
    out = []
    for cli in (jplint, tplint):
        rc = cli.main(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


def test_plint_matches_reference(tmp_path, capsys, monkeypatch):
    chip = same_chip(monkeypatch)
    main, _, loss = ref_net()
    clean = tmp_path / "clean.json"
    clean.write_bytes(main.desc.serialize_to_string())
    bad = jfluid.Program.parse_from_string(main.desc.serialize_to_string())
    bad.global_block().desc.append_op(
        OpDesc("relu", {"X": ["does_not_exist"]}, {"Out": ["nope"]}, {}))
    badf = tmp_path / "bad.json"
    badf.write_bytes(bad.desc.serialize_to_string())
    cases = [
        ([str(clean), "--fetch", loss.name], 0),
        ([str(clean), "--fetch", loss.name, "--json"], 0),
        ([str(badf), "--level", "structural"], 1),
        ([str(badf), "--json"], 1),
        ([str(clean), "--cost", "--chip", chip, "--json", "--assume-batch",
          "32", "--fetch", loss.name], 0),
        ([str(clean), "--cost", "--chip", chip, "--budget", "100",
          "--json", "--fetch", loss.name], 1),
        ([str(clean), "--cost", "--chip", chip, "--budget", "1000000",
          "--fetch", loss.name], 0),
        ([str(clean), "--cost", "--chip", chip, "--fetch", loss.name,
          "--fail-on", "unregistered-cost-rule"], 1),
        ([str(tmp_path / "missing.json")], 2),
    ]
    for argv, rc in cases:
        (jrc, jout), (trc, tout) = _plint_both(argv, capsys)
        assert (trc, jrc) == (rc, rc), argv
        if "--json" in argv:
            assert json.loads(tout) == json.loads(jout), argv
        else:
            assert tout == jout, argv
    assert tplint.main([str(clean), "--shard"]) == 2
    assert "A15" in capsys.readouterr().err
