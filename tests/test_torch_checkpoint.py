"""Training checkpoints in the port (``fluid/checkpoint.py``) against the
JAX package on the CPU.

* ``CheckpointManager`` writes the reference's tensor files and META
  names and checksums from the same state, and each package restores
  the other's checkpoint to the same values.
* ``restore`` falls back past a newest checkpoint that is corrupt (a
  flipped byte), torn (truncated, also by the chaos injector's
  ``ckpt.truncate`` point) or consistently rewritten (caught by META's
  sha256 alone), as the reference does; ``max_to_keep`` prunes.
* ``PodCheckpointManager`` restores only committed manifests, from a
  rank copy that verifies, across packages.
* A run resumed from a checkpoint by a fresh scope and executor is the
  uninterrupted run bit for bit (the program has no random op; as in the
  reference, no RNG state is saved), and a restore into the executor and
  scope whose step is already cached is read by the next step.
"""

import json
import os

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import checkpoint as jckpt
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import checkpoint as tckpt
from paddle_tpu_torch.resilience import chaos as tchaos
from tests.test_torch_io import _feed, _jax_state, _mlp, _same

CPU = tfluid.CPUPlace()


def _port_scope(state):
    return tfluid.scope_from_numpy(state, CPU)


def _jax_scope(state):
    scope = jfluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    return scope


def _tensor_files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n != "META.json"}


def test_checkpoint_files_are_the_references_and_cross_restore(tmp_path):
    state = _jax_state()
    tmain = _mlp(tfluid)[0]
    jmain = _mlp(jfluid)[0]
    tm = tckpt.CheckpointManager(str(tmp_path / "t"), max_to_keep=2)
    jm = jckpt.CheckpointManager(str(tmp_path / "j"), max_to_keep=2)
    tm2 = tckpt.CheckpointManager(str(tmp_path / "t"), max_to_keep=2,
                                  save_interval_steps=2)
    assert not tm2.save(3, tmain, _port_scope(state))
    for step in (2, 4, 6):
        assert tm.save(step, tmain, _port_scope(state))
        assert jm.save(step, jmain, _jax_scope(state))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == ["ckpt-4", "ckpt-6", "latest"]
    t6, j6 = tmp_path / "t" / "ckpt-6", tmp_path / "j" / "ckpt-6"
    assert _tensor_files(t6) == _tensor_files(j6)
    tmeta = json.load(open(t6 / "META.json"))
    jmeta = json.load(open(j6 / "META.json"))
    assert {k: tmeta[k] for k in ("names", "checksums", "step")} == \
        {k: jmeta[k] for k in ("names", "checksums", "step")}
    assert tm.latest_step() == jm.latest_step() == 6
    # each package restores the other's
    tscope, jscope = tfluid.Scope(), jfluid.Scope()
    assert tckpt.CheckpointManager(str(tmp_path / "j")).restore(
        tmain, tscope) == 6
    assert jckpt.CheckpointManager(str(tmp_path / "t")).restore(
        jmain, jscope) == 6
    for n, v in state.items():
        _same(tscope.find_var(n), v)
        _same(jscope.find_var(n), v)


def _rewrite(path):
    """A torn-then-reframed file: a self-consistent frame of other bytes,
    which only META's checksum catches."""
    value = tfluid.io.load_tensor(path)
    tfluid.io.save_tensor(np.asarray(value) + 1, path)


@pytest.mark.parametrize("fault", ["flip", "truncate", "rewrite", "chaos"])
def test_restore_falls_back_past_a_bad_newest_checkpoint(fault, tmp_path):
    state = _jax_state()
    main = _mlp(tfluid)[0]
    results = {}
    for pkg, ckpt, chaos in (("port", tckpt, tchaos),
                             ("jax", jckpt, jchaos)):
        d = str(tmp_path / pkg)
        mgr = ckpt.CheckpointManager(d, max_to_keep=3)
        scope = _port_scope(state) if pkg == "port" else _jax_scope(state)
        prog = main if pkg == "port" else _mlp(jfluid)[0]
        mgr.save(1, prog, scope)
        if fault == "chaos":
            prev = chaos.install(chaos.FaultInjector("ckpt.truncate=1.0"))
            try:
                mgr.save(2, prog, scope)
            finally:
                chaos.install(prev)
        else:
            mgr.save(2, prog, scope)
            name = sorted(n for n in os.listdir(os.path.join(d, "ckpt-2"))
                          if n != "META.json")[0]
            path = os.path.join(d, "ckpt-2", name)
            if fault == "rewrite":
                _rewrite(path)
            else:
                buf = open(path, "rb").read()
                if fault == "flip":
                    buf = buf[:20] + bytes([buf[20] ^ 1]) + buf[21:]
                else:
                    buf = buf[: len(buf) // 2]
                open(path, "wb").write(buf)
        out = tfluid.Scope() if pkg == "port" else jfluid.Scope()
        results[pkg] = mgr.restore(prog, out)
        # the newest is still listed, and the marker names it
        assert mgr.latest_step() == 2
    assert results == {"port": 1, "jax": 1}


def test_pod_manager_restores_only_committed_manifests(tmp_path):
    rng = np.random.RandomState(8)
    items = {r: {"w": rng.randn(3, 2).astype(np.float32),
                 "step": np.array([r], np.int32)} for r in range(2)}
    for ckpt in (tckpt, jckpt):
        d = str(tmp_path / ckpt.__name__.split(".")[0])
        pod = ckpt.PodCheckpointManager(d, max_to_keep=2)
        assert pod.restore(0) is None
        for r in range(2):
            pod.stage(1, r, 2, items[r])
        assert pod.latest_committed() is None
        assert pod.commit(1, 2)
        # step 2: rank 1 never stages, so the manifest never commits
        pod.stage(2, 0, 2, items[0])
        assert not pod.commit(2, 2)
        assert pod.committed_steps() == [1]
        step, got = pod.restore(1)
        assert step == 1
        for k in items[1]:
            np.testing.assert_array_equal(np.asarray(got[k]), items[1][k])
        # a world of 3 reads rank 2 % 2 = rank 0's copy
        step, got = pod.restore(2)
        np.testing.assert_array_equal(np.asarray(got["w"]), items[0]["w"])
        # a corrupt rank copy falls back to another committed rank's
        path = os.path.join(d, "pod-1", "rank-1", "w")
        open(path, "ab").write(b"x")
        step, got = pod.restore(1)
        np.testing.assert_array_equal(np.asarray(got["w"]), items[0]["w"])
    # the port restores the reference's manifests and back
    for src, ckpt in (("paddle_tpu", tckpt), ("paddle_tpu_torch", jckpt)):
        step, got = ckpt.PodCheckpointManager(
            str(tmp_path / src)).restore(0)
        assert step == 1
        np.testing.assert_array_equal(np.asarray(got["w"]), items[0]["w"])


def _train(exe, scope, main, loss, steps, start=0):
    return [np.asarray(exe.run(main, feed=_feed(i), fetch_list=[loss],
                               scope=scope)[0])
            for i in range(start, start + steps)]


def _state(scope, main):
    return {v.name: np.asarray(tfluid.scope_to_numpy(scope, [v.name])
                               [v.name])
            for v in main.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}


def test_resume_is_the_uninterrupted_run_bitwise(tmp_path):
    state = _jax_state()
    main, _, _, loss = _mlp(tfluid)
    exe, scope = tfluid.Executor(CPU), _port_scope(state)
    want = _train(exe, scope, main, loss, 6)
    want_state = _state(scope, main)

    mgr = tckpt.CheckpointManager(str(tmp_path), save_interval_steps=2)
    exe, scope = tfluid.Executor(CPU), _port_scope(state)
    got = []
    for i in range(4):
        got += _train(exe, scope, main, loss, 1, i)
        mgr.save(i + 1, main, scope)
    del exe, scope                      # a crash
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    assert mgr.restore(main, scope) == 4
    got += _train(exe, scope, main, loss, 2, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got_state = _state(scope, main)
    assert sorted(got_state) == sorted(want_state)
    for n in want_state:
        np.testing.assert_array_equal(got_state[n], want_state[n], err_msg=n)


def test_restore_into_a_cached_step_is_read_by_the_next_step(tmp_path):
    """The executor's entry holds the scope's state in its buffers (the
    captured graph's, on the card); a restore replaces the scope's vars,
    and the next step copies them in."""
    state = _jax_state()
    main, _, _, loss = _mlp(tfluid)
    exe, scope = tfluid.Executor(CPU), _port_scope(state)
    want = _train(exe, scope, main, loss, 4)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    exe, scope = tfluid.Executor(CPU), _port_scope(state)
    _train(exe, scope, main, loss, 2)
    mgr.save(2, main, scope)
    _train(exe, scope, main, loss, 2, 2)       # steps 3-4, a hit each
    assert mgr.restore(main, scope) == 2
    again = _train(exe, scope, main, loss, 2, 2)
    assert exe.cache_stats()["executable"]["misses"] == 1
    for g, w in zip(again, want[2:]):
        np.testing.assert_array_equal(g, w)
