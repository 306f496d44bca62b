"""The port's persistent compile cache (``fluid/compile_cache.py``,
``kernels/_build.py``), on the CPU.

The reference's ``tests/test_compile_cache.py`` is red on this tree (its
PJRT executables do not round-trip here), so the port is held to that
module's docstring, and to the reference where the two still agree:

* keys: the same dispatch is the same key, a changed salt is a distinct
  key, and an entry whose header carries another salt is a miss;
* the Executor round trip: a second executor over the same directory
  hits (record loaded and checked against its plan) and fetches the
  same values bitwise; ``cache_stats()["persistent"]`` and the
  ``paddle_aot_*`` / persistent executor series count it;
* a corrupt entry is a miss and is then overwritten; the seeded
  ``aot.corrupt`` point tears a read into a miss, with the reference
  injector's draws;
* LRU eviction bounds the directory;
* kernel libraries: ``library_plan`` picks built / cached / nvcc; a
  stored copy restores byte for byte, a corrupt one is refused (never
  loaded) and the library goes to nvcc;
* ``InferenceEngine.preresolve``: a closed bucket set stored once is
  loaded by a fresh executor; ``stop_on_compile`` stops at the first
  miss; the gateway's ``_warm`` runs it over a shipped ``compiled/``;
* ``tools/aot_compile``: a second run reports 0 compiles with
  byte-stable keys; its exit codes equal the reference's for bad
  arguments, a missing artifact and a failing one.
"""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from paddle_tpu.resilience.chaos import FaultInjector as JaxInjector
from paddle_tpu.tools import aot_compile as jax_aot
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import compile_cache as cc
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.observability.metrics import registry as obs_registry
from paddle_tpu_torch.resilience.chaos import FaultInjector, install
from paddle_tpu_torch.tools import aot_compile


@pytest.fixture(autouse=True)
def _inert_chaos():
    prev = install(FaultInjector())
    yield
    install(prev)


def _build_mlp(size=16, seed=3):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(input=x, size=size, act="relu")
        y = fluid.layers.fc(input=h, size=4)
    startup.random_seed = seed
    return main, startup, y


def _feed(batch=3):
    return {"x": np.random.RandomState(0).randn(batch, 6)
            .astype(np.float32)}


def _run_fresh(cache, size=16, batch=3, keep=None):
    """Fresh program + scope + executor against ``cache``; returns
    (fetch, persistent stats).  ``keep`` (a list) keeps the executor
    alive for a later scrape."""
    main, startup, y = _build_mlp(size=size)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace(), compile_cache=cache)
    exe.run(startup, scope=scope)
    out = exe.run(main, feed=_feed(batch), fetch_list=[y], scope=scope)
    if keep is not None:
        keep.append(exe)
    return out[0], exe.cache_stats()["persistent"]


def test_keys_are_stable_and_salted(tmp_path):
    a = cc.CompileCache(str(tmp_path))
    parts = (("fp", "train", (("x", (3, 6, "torch.float32")),)), ("d", 1))
    assert a.entry_key(parts) == cc.CompileCache(str(tmp_path)).entry_key(
        parts)
    assert a.entry_key(parts) != a.entry_key(parts + (("v", 2),))
    b = cc.CompileCache(str(tmp_path), extra_salt={"epoch": 2})
    assert a.entry_key(parts) != b.entry_key(parts)
    salt = a.salt()
    for k in ("torch", "cuda", "device_name", "capability",
              "device_count", "kernels"):
        assert k in salt
    assert set(salt["kernels"]) == {"ragged_paged_attention", "lstm_fwd",
                                    "flash_attention_fwd",
                                    "flash_attention_bwd"}


def test_stale_salt_is_a_miss(tmp_path):
    """A new salt addresses another entry (a miss); an entry file whose
    header carries a stale salt under our key is a miss too."""
    out0, st0 = _run_fresh(cc.CompileCache(str(tmp_path)))
    assert st0["misses"] == 2 and st0["stores"] == 2
    _, st1 = _run_fresh(cc.CompileCache(str(tmp_path),
                                        extra_salt={"epoch": 1}))
    assert st1["hits"] == 0 and st1["misses"] == 2
    cache = cc.CompileCache(str(tmp_path))
    key = cache.keys()[0]
    other = cc.CompileCache(str(tmp_path), extra_salt={"stale": True})
    other.store(key, {"plan": {}})          # our key, another salt
    assert cache.load(key) is None and cache._stats["corrupt"] == 1


def test_executor_round_trip_bitwise_and_counted(tmp_path):
    cache_dir = str(tmp_path / "cc")
    want, _ = _run_fresh(False)
    got0, st0 = _run_fresh(cc.CompileCache(cache_dir))
    alive = []
    got1, st1 = _run_fresh(cc.CompileCache(cache_dir), keep=alive)
    np.testing.assert_array_equal(got0, want)
    np.testing.assert_array_equal(got1, want)
    assert (st0["misses"], st0["stores"], st0["hits"]) == (2, 2, 0)
    assert (st1["hits"], st1["misses"], st1["stores"]) == (2, 0, 0)
    assert st1["bytes"] > 0 and st1["cache"]["entries"] == 2
    text = obs_registry().render_prometheus()
    assert 'paddle_executor_cache_events_total{cache="persistent",' \
           'event="hits"}' in text
    assert 'paddle_aot_cache_events_total{event="stores"}' in text
    record = cc.CompileCache(cache_dir).load(
        cc.CompileCache(cache_dir).keys()[0])
    assert set(record) == {"signature", "mode", "device", "plan",
                           "libraries"}
    assert record["device"] == "cpu" and record["libraries"] == []


def test_corrupt_entry_is_a_miss_then_overwritten(tmp_path):
    cache = cc.CompileCache(str(tmp_path))
    _run_fresh(cache)
    for key in cache.keys():
        p = tmp_path / (key + ".plan")
        p.write_bytes(p.read_bytes()[:-7] + b"garbage")
    want, _ = _run_fresh(False)
    got, st = _run_fresh(cc.CompileCache(str(tmp_path)))
    np.testing.assert_array_equal(got, want)
    assert st["hits"] == 0 and st["misses"] == 2 and st["stores"] == 2
    assert st["cache"]["corrupt"] == 2
    _, st2 = _run_fresh(cc.CompileCache(str(tmp_path)))
    assert st2["hits"] == 2 and st2["misses"] == 0


def test_seeded_aot_corrupt_point(tmp_path):
    """``aot.corrupt=1`` tears every read into a miss (and the step still
    runs right); the injector's draws are the reference's."""
    cache_dir = str(tmp_path)
    want, _ = _run_fresh(cc.CompileCache(cache_dir))
    install(FaultInjector("aot.corrupt=1.0", seed=5))
    got, st = _run_fresh(cc.CompileCache(cache_dir))
    np.testing.assert_array_equal(got, want)
    assert st["hits"] == 0 and st["cache"]["corrupt"] == 2
    mine = FaultInjector("aot.corrupt=0.5", seed=11)
    ref = JaxInjector("aot.corrupt=0.5", seed=11)
    assert [mine.should("aot.corrupt") for _ in range(32)] == \
        [ref.should("aot.corrupt") for _ in range(32)]


def test_eviction_bounds_the_directory(tmp_path):
    cache = cc.CompileCache(str(tmp_path), max_bytes=1)
    _run_fresh(cache)
    assert len(cache.keys()) == 1, \
        "max_bytes must keep only the just-stored entry"
    assert cache._stats["evictions"] >= 1


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``kernels/build/`` redirected to a temp dir holding a fake built
    ragged library (bytes, never loaded here)."""
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    lib = _build._target("ragged_paged_attention")
    lib.write_bytes(b"\x7fELF fake library " * 64)
    return lib


def test_library_plan_store_and_restore(fake_build, tmp_path):
    name = "ragged_paged_attention"
    cache = cc.CompileCache(str(tmp_path / "cc"))
    assert _build.library_plan(name, [cache.dirname]) == ("built",
                                                          fake_build)
    assert cache.store_libraries([name]) == 1
    assert cache.store_libraries([name]) == 0          # already sound
    assert cache.libraries() == [fake_build.name]
    blob = fake_build.read_bytes()
    fake_build.unlink()
    how, copy = _build.library_plan(name, [str(tmp_path / "none"),
                                           cache.dirname])
    assert how == "cache" and copy.parent == Path(cache.dirname)
    assert _build.restore_library(name, copy)
    assert fake_build.read_bytes() == blob
    # a torn copy is refused: nothing written, the library goes to nvcc
    fake_build.unlink()
    raw = copy.read_bytes()
    copy.write_bytes(raw[:len(raw) - 5])
    rejects = _build.stats["cache_rejects"]
    assert not _build.restore_library(name, copy)
    assert _build.stats["cache_rejects"] == rejects + 1
    assert not fake_build.exists()
    assert not cache.load_libraries([name])
    assert _build.library_plan(name, []) == ("nvcc", fake_build)


def test_a_record_whose_library_is_missing_is_a_miss(fake_build, tmp_path):
    """A sound record naming a library with no sound copy (and none
    built) is a miss: nothing is loaded."""
    cache = cc.CompileCache(str(tmp_path / "cc"))
    _run_fresh(cache)
    for key in cache.keys():
        rec = cache.load(key)
        rec["libraries"] = ["ragged_paged_attention"]
        cache.store(key, rec)
    fake_build.unlink()
    _, st = _run_fresh(cc.CompileCache(cache.dirname))
    assert st["hits"] == 0 and st["misses"] == 2


def _save_engine_artifact(tmp_path, name="cls"):
    main, startup, y = _build_mlp()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_versioned_inference_model(
            str(tmp_path), name, "1", ["x"], [y], exe, main_program=main)
    return fluid.io.model_version_dir(str(tmp_path), name, "1")


def test_engine_preresolve_and_stop_on_compile(tmp_path):
    from paddle_tpu_torch.serving import InferenceEngine

    dirname = _save_engine_artifact(tmp_path)
    cache_dir = str(tmp_path / "cc")

    def fresh(buckets=(1, 4, 8)):
        exe = fluid.Executor(fluid.CPUPlace(),
                             compile_cache=cc.CompileCache(cache_dir))
        return InferenceEngine(dirname=dirname, executor=exe,
                               place=fluid.CPUPlace(),
                               batch_buckets=buckets)

    eng0 = fresh()
    eng0.warmup([{"x": np.zeros((1, 6), np.float32)}])
    eng = fresh()
    n = eng.preresolve(stop_on_compile=True)
    st = eng.exe.cache_stats()["persistent"]
    assert n == 2 and st["hits"] == 1 and st["misses"] == 1
    eng2 = fresh()
    assert eng2.preresolve() == 3
    st2 = eng2.exe.cache_stats()["persistent"]
    assert st2["hits"] == 2 and st2["misses"] == 1
    eng3 = fresh()
    assert eng3.preresolve(stop_on_compile=True) == 3
    assert eng3.exe.cache_stats()["persistent"]["misses"] == 0
    out = eng3.infer({"x": np.ones((4, 6), np.float32)})
    assert out[0].shape == (4, 4)


def test_gateway_warm_preresolves_a_shipped_engine(tmp_path):
    """An engine artifact whose ``compiled/`` was pre-warmed offline:
    the registry-mounted cache loads it at ``_warm``, zero compiles."""
    from paddle_tpu_torch.serving.gateway import Gateway, ModelRegistry

    dirname = _save_engine_artifact(tmp_path)
    r1 = aot_compile.precompile(dirname, place=fluid.CPUPlace(),
                                batch_buckets=(1, 4))
    assert r1["kind"] == "engine" and r1["signatures"] == 2
    assert r1["compiles"] == 2
    gw = Gateway(registry=ModelRegistry(root=str(tmp_path),
                                        place=fluid.CPUPlace()))
    gw.load_model("cls", "1", batch_buckets=(1, 4))
    eng = gw.registry.instance("cls")
    st = eng.exe.cache_stats()["persistent"]
    assert st["hits"] == 2 and st["misses"] == 0
    assert eng.infer({"x": np.ones((3, 6), np.float32)})[0].shape == (3, 4)


def _cli(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_aot_compile_second_run_zero_compiles(tmp_path):
    dirname = _save_engine_artifact(tmp_path)
    argv = ["--dirname", dirname, "--batch-bucket", "1", "--json", "--cpu"]
    (rc0, out0), (rc1, out1) = _cli(aot_compile.main, argv), \
        _cli(aot_compile.main, argv)
    assert rc0 == rc1 == 0
    first, second = json.loads(out0), json.loads(out1)
    assert first["compiles"] == 1 and first["stores"] == 1
    assert second["compiles"] == 0 and second["loads"] == 1
    assert second["keys"] == first["keys"] and len(first["keys"]) == 1


def test_aot_compile_exit_codes_match_reference(tmp_path):
    bogus = tmp_path / "bogus"
    bogus.mkdir()
    (bogus / "gateway.json").write_text(json.dumps({"kind": "bogus"}))
    cases = [[],                                          # no artifact arg
             ["--root", str(tmp_path), "--model", "none"],  # no versions
             ["--dirname", str(tmp_path / "nope")],       # missing dir
             ["--dirname", str(bogus), "--mesh", "model"],  # bad --mesh
             ["--dirname", str(bogus)]]                   # load fails
    for argv in cases:
        want, _ = _cli(jax_aot.main, argv)
        got, _ = _cli(aot_compile.main, argv + ["--cpu"])
        assert got == want, (argv, got, want)
    assert [_cli(aot_compile.main, a + ["--cpu"])[0]
            for a in cases] == [2, 2, 2, 2, 1]
