"""The input pipeline, ``print`` and the profiler in the port
(``fluid/pipeline_io.py``, ``utils/reader.py``, ``fluid/ops/io_ops.py``,
``fluid/profiler.py``) against the JAX package on the CPU.

* ``DataLoader``: the batches in the reader's order, converted by a
  ``DataFeeder`` on the producer thread; a reader's error re-raised at
  the consuming ``next()`` after the batches before it; a callable
  reader restarts each epoch; a one-shot iterator refuses a second
  epoch; bad arguments and non-dict items refused — each as the
  reference does.  ``run_pipeline`` over a DataLoader is the synchronous
  loop bit for bit; ``decorate_reader`` and the ``layers`` shims build
  the same loaders.
* ``layers.Print`` builds the reference's op and prints at every step
  (the reference's emitter raises a ``KeyError`` on the ``In`` slot its
  own layer writes).
* The profiler: ``executor_step/<mode>`` events with the reference's
  names and call counts, the printed table, ``record_event`` spans in
  the tracer, ``cuda_profiler`` writing a Chrome trace, and
  ``op_cost_table``'s products (the rest is in
  tests/test_torch_cost.py).
"""

import json
import os
import sys
import threading

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import pipeline_io as jpio
from paddle_tpu.fluid import profiler as jprof
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import pipeline_io as tpio
from paddle_tpu_torch.fluid import profiler as tprof
from paddle_tpu_torch.observability.tracing import tracer
from tests.test_torch_io import _feed, _jax_state, _mlp

CPU = tfluid.CPUPlace()


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[(rng.randn(8).astype(np.float32), [int(rng.randint(0, 4))])
             for _ in range(3)] for _ in range(n)]


def _loader(pkg, reader, **kw):
    if pkg == "jax":
        return jpio.DataLoader(reader, **kw)
    return tpio.DataLoader(reader, place=CPU, **kw)


def _host(feed):
    return {k: np.asarray(v) for k, v in feed.items()}


def _drain(pkg, make, **kw):
    """Iterate a loader: (feeds, the error raised, if any)."""
    out = []
    try:
        for f in _loader(pkg, make, **kw):
            out.append(_host(f))
    except Exception as e:          # noqa: BLE001 — compared below
        return out, f"{type(e).__name__}: {e}"
    return out, None


def _feeders():
    feeders = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data("x", [8], "float32")
            y = fluid.layers.data("y", [1], "int64")
        feeders[pkg] = fluid.DataFeeder([x, y])
    return feeders


def _failing():
    yield _feed(0)
    yield _feed(1)
    raise ValueError("reader broke at batch 2")


CASES = {
    "order": (lambda: (_feed(i) for i in range(5)), {}),
    "feeder": (lambda: iter(_rows(4)), {"feeder": True}),
    "error": (_failing, {}),
    "no_prefetch": (lambda: (_feed(i) for i in range(3)),
                    {"device_prefetch": False, "capacity": 1}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_data_loader_yields_the_references_batches(case):
    make, kw = CASES[case]
    got = {}
    for pkg in ("jax", "port"):
        k = dict(kw)
        if k.pop("feeder", False):
            k["feeder"] = _feeders()[pkg]
        got[pkg] = _drain(pkg, make, **k)
    (jf, je), (tf, te) = got["jax"], got["port"]
    assert te == je
    assert len(tf) == len(jf) > 0
    for a, b in zip(tf, jf):
        assert sorted(a) == sorted(b)
        for k in a:
            # the reference's runtime narrows int64 to int32, as the port
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_data_loader_epochs_and_refusals_are_the_references():
    for pkg in ("jax", "port"):
        calls = []

        def reader():
            calls.append(1)
            return iter([_feed(i) for i in range(2)])

        loader = _loader(pkg, reader)
        assert [len(list(loader)) for _ in range(3)] == [2, 2, 2]
        assert len(calls) == 3
        once = _loader(pkg, iter([_feed(0), _feed(1)]))
        assert len(list(once)) == 2
        with pytest.raises(RuntimeError, match="one-shot"):
            list(once)
        with pytest.raises(ValueError, match="capacity"):
            _loader(pkg, reader, capacity=0)
        with pytest.raises(ValueError, match="needs a reader"):
            _loader(pkg, None)
        with pytest.raises(TypeError, match="feed dicts"):
            list(_loader(pkg, lambda: iter([[1, 2]])))


def test_run_pipeline_over_a_data_loader_is_the_sync_loop_bitwise():
    state = _jax_state()
    main, _, _, loss = _mlp(tfluid)
    feeds = [_feed(i) for i in range(6)]
    exe, scope = tfluid.Executor(CPU), tfluid.scope_from_numpy(state, CPU)
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    exe, scope = tfluid.Executor(CPU), tfluid.scope_from_numpy(state, CPU)
    got = exe.run_pipeline(main, tfluid.DataLoader(lambda: iter(feeds),
                                                   place=CPU),
                           fetch_list=[loss], scope=scope, fetch_every=4)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w)


def test_decorate_reader_and_the_layer_shims_build_loaders():
    feeder = _feeders()["port"]
    feeder.place = CPU
    loaders = [feeder.decorate_reader(lambda: iter(_rows(2)), capacity=3),
               tfluid.layers.io.data_loader(lambda: iter(_rows(2)),
                                            feed_list=feeder.feed_vars,
                                            place=CPU),
               tfluid.layers.io.py_reader(2, feed_list=feeder.feed_vars,
                                          reader=lambda: iter(_rows(2)),
                                          place=CPU)]
    want = [_host(feeder.feed(b)) for b in _rows(2)]
    for loader in loaders:
        assert isinstance(loader, tfluid.DataLoader)
        got = [_host(f) for f in loader]
        for a, b in zip(got, want):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert tfluid.layers.io.double_buffer(loaders[0]) is loaders[0]
    with pytest.raises(ValueError, match="not both"):
        tfluid.layers.io.data_loader(lambda: iter([]), feed_list=[1],
                                     feeder=feeder)


def _print_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [3], "float32")
        fluid.layers.Print(x, message="the x")
        z = fluid.layers.scale(x, 2.0)
    return main, z


def test_print_prints_at_every_step(capsys):
    tmain, tz = _print_program(tfluid)
    jmain, jz = _print_program(jfluid)
    assert tmain.serialize_to_string() == jmain.serialize_to_string()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        with pytest.raises(KeyError, match="X"):
            jexe.run(jmain, feed={"x": x}, fetch_list=[jz])
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    capsys.readouterr()
    for _ in range(2):                    # a miss, then a hit
        out, = exe.run(tmain, feed={"x": x}, fetch_list=[tz], scope=scope)
        np.testing.assert_array_equal(out, 2 * x)
    printed = capsys.readouterr().out
    assert printed.count("the x ") == 2
    assert printed.count(str(x)) == 2
    assert exe.cache_stats()["executable"]["hits"] == 1


def _profiled(pkg, steps, capsys):
    fluid = jfluid if pkg == "jax" else tfluid
    prof = jprof if pkg == "jax" else tprof
    main, _, pred, loss = _mlp(fluid)
    state = _jax_state()
    if pkg == "jax":
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        for n, v in state.items():
            scope.set_var(n, v)
    else:
        exe, scope = (tfluid.Executor(CPU),
                      tfluid.scope_from_numpy(state, CPU))
    infer = main.clone(for_test=True)
    capsys.readouterr()
    with fluid.scope_guard(scope), prof.profiler(sorted_key="calls"):
        for i in range(steps):
            exe.run(main, feed=_feed(i), fetch_list=[loss])
        exe.run(infer, feed=_feed(0), fetch_list=[pred], mode="infer")
        with prof.record_event("user/block"):
            pass
    rows = prof.get_profile_table("calls")
    return ([(r["name"], r["calls"]) for r in rows],
            capsys.readouterr().out)


def test_profiler_table_is_the_references(capsys):
    want, jout = _profiled("jax", 3, capsys)
    got, tout = _profiled("port", 3, capsys)
    assert got == want == [("executor_step/train", 3),
                           ("executor_step/infer", 1), ("user/block", 1)]
    assert tout.splitlines()[0] == jout.splitlines()[0]
    assert [ln.split()[:2] for ln in tout.splitlines()[1:]] == \
        [ln.split()[:2] for ln in jout.splitlines()[1:]]
    spans = tracer().events(name="user/block", cat="profiler")
    assert spans and spans[-1]["ph"] == "X"
    tprof.reset_profiler()
    assert tprof.get_profile_table() == []


def test_record_event_loses_no_event_across_threads():
    """``record_event`` from more threads than cores, with a short
    switch interval: every event lands in the table."""
    threads, per = 4 * (os.cpu_count() or 2), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tprof.profiler(print_table=False):
            def work():
                for _ in range(per):
                    with tprof.record_event("stress"):
                        pass
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            rows = tprof.get_profile_table()
    finally:
        sys.setswitchinterval(old)
    assert [(r["name"], r["calls"]) for r in rows] == [
        ("stress", threads * per)]


def test_cuda_profiler_writes_a_trace_and_op_cost_table_is_refused(
        tmp_path):
    main, _, pred, loss = _mlp(tfluid)
    exe = tfluid.Executor(CPU)
    scope = tfluid.scope_from_numpy(_jax_state(), CPU)
    with tprof.cuda_profiler(str(tmp_path)) as d:
        exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    assert d == str(tmp_path)
    traces = [n for n in os.listdir(tmp_path) if n.endswith(".json")]
    assert len(traces) == 1
    events = json.load(open(tmp_path / traces[0]))["traceEvents"]
    # the lowering names each op's range after its type under a profiler
    assert any(e.get("name") == "mul" for e in events)
    # op_cost_table is ported: the two fc products, 2 * M * N * K flops
    # at the feed's batch of 5, as the reference's table counts them
    rows = tprof.op_cost_table(main, feed=_feed(0), scope=scope,
                               print_table=False)
    fwd = sorted(r["flops"] for r in rows if r["op"].endswith(" mul"))
    assert fwd == [2.0 * 5 * 16 * 4, 2.0 * 5 * 8 * 16]
