"""The launcher against the JAX package's, and a 3-host pod through it.

* The same rank scripts (plain Python, no torch) through the port's and
  the reference's ``launch``: each rank's environment, the first fatal
  exit code, elastic restarts and their exhausted budget, append-mode
  per-rank logs, SIGTERM -> SIGKILL teardown, ``pod_rendezvous`` (the
  launcher's own coordinator, or an address passed through), and
  ``launch_hosts`` on localhost and through a stand-in ``ssh`` (the
  remote command line, token for token).  ``_parse_hosts`` and the CLI's
  exit codes are the reference's.
* ``slow``, as the reference marks its own multi-process pod
  (``tests/test_coordinator_e2e.py``; its tier-1 counterpart is
  ``test_torch_coordinator.py::test_host_loss_in_process_is_the_references``):
  ``python -m paddle_tpu_torch.launch --nprocs 3 --pod-rendezvous auto
  --pod-min-world 2 --max-restarts 1``: three CPU ranks train the fc
  regression of ``tests/test_coordinator_e2e.py`` in pod mode through
  the port's fluid; a seeded ``coord.crash`` (armed in the victim's
  first life only) SIGKILLs one at step 5's barrier; the launcher
  respawns it, the survivors re-rendezvous at world 2 and rewind to the
  last committed manifest, the respawned host regrows the pod to world
  3, a pre-seeded torn manifest is never restored, and the run finishes
  with no lost or duplicated step and every host's parameters bit for
  bit the committed manifest's.  Every child has a wall limit of its
  own (``communicate(timeout=...)`` and a kill).
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from paddle_tpu import launch as jlaunch
from paddle_tpu_torch import launch as plaunch
from paddle_tpu_torch.fluid.checkpoint import PodCheckpointManager
from paddle_tpu_torch.resilience import FaultInjector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = (("port", plaunch), ("jax", jlaunch))
# the pod scenario's wall limit: the launcher's coordinator evicts a
# silent host after 10 s, each rank imports torch (a few seconds)
POD_WALL = 240


def _script(tmp_path, name, body):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(textwrap.dedent(body))
    return path


ENV_DUMP = """
    import json, os, sys
    keys = ("PADDLE_TPU_COORDINATOR", "PADDLE_TPU_NPROCS",
            "PADDLE_TPU_PROC_ID", "PADDLE_TPU_HOST_ID",
            "PADDLE_TPU_POD_COORDINATOR", "PADDLE_TPU_POD_HOST",
            "PADDLE_TPU_METRICS_HOST", "PADDLE_TPU_POD_HEARTBEAT",
            "EXTRA")
    rank = os.environ.get("PADDLE_TPU_PROC_ID")
    with open(os.path.join(sys.argv[1], f"env-{rank}.json"), "w") as f:
        json.dump({k: os.environ.get(k) for k in keys}, f)
    addr = os.environ.get("PADDLE_TPU_POD_COORDINATOR")
    if addr and len(sys.argv) > 2:
        import urllib.request
        with urllib.request.urlopen(f"http://{addr}/ping", timeout=10) as r:
            assert json.loads(r.read())["ok"]
"""


def _envs(out_dir):
    return {int(n[4:-5]): json.load(open(os.path.join(out_dir, n)))
            for n in os.listdir(out_dir) if n.startswith("env-")}


def _normalized(envs, keys=("PADDLE_TPU_COORDINATOR",
                            "PADDLE_TPU_POD_COORDINATOR")):
    """Rank envs with the per-run addresses replaced by their host."""
    out = {}
    for rank, env in envs.items():
        e = dict(env)
        for k in keys:
            if e[k] is not None:
                host, _, port = e[k].rpartition(":")
                assert port.isdigit()
                e[k] = host
        out[rank] = e
    return out


def test_rank_environment_is_the_references(tmp_path):
    script = _script(tmp_path, "env.py", ENV_DUMP)
    got = {}
    for name, mod in PACKAGES:
        out = tmp_path / name
        out.mkdir()
        assert mod.launch(3, [script, str(out)],
                          env_extra={"EXTRA": "x"}) == 0
        envs = _envs(str(out))
        # one coordinator address for every rank
        assert len({e["PADDLE_TPU_COORDINATOR"] for e in envs.values()}) == 1
        got[name] = _normalized(envs)
    assert got["port"] == got["jax"]
    assert [got["port"][r]["PADDLE_TPU_PROC_ID"] for r in range(3)] == \
        ["0", "1", "2"]
    assert got["port"][0]["PADDLE_TPU_POD_COORDINATOR"] is None


def test_pod_rendezvous_exports_are_the_references(tmp_path):
    script = _script(tmp_path, "env.py", ENV_DUMP)
    got = {}
    for name, mod in PACKAGES:
        out = tmp_path / name
        out.mkdir()
        # "auto": the launcher serves the coordinator the ranks ping
        assert mod.launch(2, [script, str(out), "ping"],
                          pod_rendezvous="auto", pod_heartbeat=0.5) == 0
        auto = _normalized(_envs(str(out)))
        out2 = tmp_path / f"{name}-ext"
        out2.mkdir()
        assert mod.launch(2, [script, str(out2)],
                          pod_rendezvous="10.0.0.9:1234") == 0
        got[name] = (auto, _normalized(_envs(str(out2)),
                                       ("PADDLE_TPU_COORDINATOR",)))
    assert got["port"] == got["jax"]
    auto, ext = got["port"]
    assert [auto[r]["PADDLE_TPU_POD_HOST"] for r in (0, 1)] == \
        ["host-0", "host-1"]
    assert auto[1]["PADDLE_TPU_METRICS_HOST"] == "host-1"
    assert auto[0]["PADDLE_TPU_POD_HEARTBEAT"] == "0.5"
    assert ext[0]["PADDLE_TPU_POD_COORDINATOR"] == "10.0.0.9:1234"


CRASHY = """
    import os, sys
    marker_dir = sys.argv[1]
    n = len(os.listdir(marker_dir))
    open(os.path.join(marker_dir, f"inc-{n}"), "w").close()
    print("incarnation", n, "rank", os.environ["PADDLE_TPU_PROC_ID"],
          flush=True)
    if n < 2:
        os._exit(7)          # die hard on the first two incarnations
    sys.exit(0)
"""


@pytest.mark.parametrize("restarts,want_rc,want_runs", [(3, 0, 3),
                                                        (1, 7, 2),
                                                        (0, 7, 1)])
def test_elastic_restarts_and_budget_as_the_reference(tmp_path, restarts,
                                                      want_rc, want_runs):
    script = _script(tmp_path, "crashy.py", CRASHY)
    logs = {}
    for name, mod in PACKAGES:
        marks = tmp_path / f"marks-{name}"
        marks.mkdir()
        logdir = str(tmp_path / f"logs-{name}")
        rc = mod.launch(1, [script, str(marks)], max_restarts=restarts,
                        kill_grace=2.0, log_dir=logdir)
        assert rc == want_rc, name
        assert len(os.listdir(marks)) == want_runs
        logs[name] = open(os.path.join(logdir, "rank-0.log")).read()
    assert logs["port"] == logs["jax"]
    assert logs["port"].count("incarnation") == want_runs


def test_first_fatal_exit_tears_down_a_wedged_rank(tmp_path):
    """A rank exiting 3 ends the job with 3; the other rank ignores
    SIGTERM and is SIGKILLed after the grace period."""
    script = _script(tmp_path, "wedge.py", """
        import os, signal, sys, time
        flag = sys.argv[1]
        if os.environ["PADDLE_TPU_PROC_ID"] == "0":
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            open(flag, "w").write("ready")
            time.sleep(600)
        else:
            while not os.path.exists(flag):
                time.sleep(0.01)
            sys.exit(3)
    """)
    for name, mod in PACKAGES:
        flag = str(tmp_path / f"ready-{name}")
        t0 = time.monotonic()
        assert mod.launch(2, [script, flag], kill_grace=1.0) == 3, name
        assert time.monotonic() - t0 < 30


FAKE_SSH = """
    import json, os, sys
    with open(os.environ["SSH_LOG"], "a") as f:
        f.write(json.dumps(sys.argv[1:]) + "\\n")
"""


def test_launch_hosts_local_and_remote_as_the_reference(tmp_path):
    script = _script(tmp_path, "env.py", ENV_DUMP)
    ssh = _script(tmp_path, "ssh.py", FAKE_SSH)
    wrapper = str(tmp_path / "fake-ssh")
    with open(wrapper, "w") as f:
        f.write(f"#!/bin/sh\nexec {sys.executable} {ssh} \"$@\"\n")
    os.chmod(wrapper, 0o755)
    got = {}
    for name, mod in PACKAGES:
        out = tmp_path / name
        out.mkdir()
        assert mod.launch_hosts(["localhost", "127.0.0.1"], 2,
                                [script, str(out)]) == 0
        envs = _normalized(_envs(str(out)))
        assert [envs[r]["PADDLE_TPU_HOST_ID"] for r in range(4)] == \
            ["0", "0", "1", "1"]
        with pytest.raises(ValueError, match="mixed"):
            mod.launch_hosts(["localhost", "node-b"], 1, [script])
        log = str(tmp_path / f"ssh-{name}.log")
        os.environ["SSH_LOG"] = log
        try:
            assert mod.launch_hosts(["node-a", "node b"], 1,
                                    [script, "arg with space"],
                                    ssh_cmd=wrapper,
                                    env_extra={"K": "v w"}) == 0
        finally:
            del os.environ["SSH_LOG"]
        got[name] = (envs, sorted(open(log).read().splitlines()))
    assert got["port"] == got["jax"]
    remote = [json.loads(ln) for ln in got["port"][1]]
    assert remote[0][:2] == ["node b", "env"] and \
        "'K=v w'" in remote[0]
    hosts = tmp_path / "hosts"
    hosts.write_text("# pod\nnode-a\n\nnode-b\n")
    for spec in (f"@{hosts}", "a, b,,c"):
        assert plaunch._parse_hosts(spec) == jlaunch._parse_hosts(spec)


def test_free_port_and_held_port():
    assert 0 < plaunch.find_free_port() < 65536
    port, held = plaunch._hold_port()
    try:
        assert held.getsockname()[1] == port
    finally:
        held.close()


def _cli(args, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "paddle_tpu_torch.launch",
                             *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def test_cli_exit_codes(tmp_path):
    script = _script(tmp_path, "fail.py", """
        import os, sys
        sys.exit(3 if os.environ["PADDLE_TPU_PROC_ID"] == "1" else 0)
    """)
    assert _cli(["--nprocs", "2", script])[0] == 3
    rc, _, err = _cli(["--nprocs", "2", "--hosts", "a", script])
    assert rc == 2 and "exactly one of --nprocs / --hosts" in err


# -- a 3-host pod through the launcher ---------------------------------------

# seed 5 at p = 0.12: FaultInjector.decision(5, "coord.crash", i) first
# fires at draw 4, so the victim dies entering step 5's barrier, after
# the world-3 manifests of steps 2 and 4 committed
CRASH_SEED, CRASH_PROB, CRASH_STEP = 5, 0.12, 5
NAN_STEP, MAX_STEPS = 2, 8

POD_WORKER = """
    import json, os, sys, time
    import numpy as np

    ckpt, out = sys.argv[1:3]
    host = os.environ["PADDLE_TPU_POD_HOST"]
    addr = os.environ["PADDLE_TPU_POD_COORDINATOR"]
    max_steps, nan_step = int(sys.argv[3]), int(sys.argv[4])

    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.parallel import PodClient
    from paddle_tpu_torch.resilience import (FaultInjector,
                                             ResilientTrainer, install)

    life = os.path.join(out, host + ".lives")
    first = not os.path.exists(life)
    with open(life, "a") as f:
        f.write("life\\n")
    client = PodClient(addr, host, poll_interval=0.05)
    if host == "host-2":
        if first:
            # the crash is armed in the victim's first life only: the
            # respawn must not draw it again
            install(FaultInjector(spec="coord.crash=%s", seed=%s,
                                  log_path=os.path.join(out, "chaos.log")))
        else:
            # rejoin once the pod has evicted the dead incarnation
            while host in client.status()["members"]:
                time.sleep(0.1)

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4], "float32")
        y = fluid.layers.data("y", [1], "float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        pairs = fluid.append_backward(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    names = [p.name for p, _ in pairs]
    gvars = [g for _, g in pairs]
    W = np.array([1.5, -2.0, 0.5, 3.0], np.float32)

    def read_chunk(step, rank, world):
        r = np.random.RandomState(step)
        xs = r.randn(12, 4).astype(np.float32)
        return xs[rank::world], (xs @ W[:, None])[rank::world]

    losses = open(os.path.join(out, host + ".losses"), "a")

    def train_step(rec, step):
        o = exe.run(main, feed={"x": rec[0], "y": rec[1]},
                    fetch_list=[loss] + gvars, scope=scope)
        losses.write(f"{step} {float(np.asarray(o[0]))}\\n")
        losses.flush()
        grads = {n: np.asarray(g) for n, g in zip(names, o[1:])}
        if step == nan_step and host == "host-0":
            grads = {k: v * np.nan for k, v in grads.items()}
        return True, grads

    def apply_update(reduced, step):
        for n in names:
            cur = fluid.scope_to_numpy(scope, [n])[n]
            scope.set_var(n, (cur - 0.05 * reduced[n]).astype(np.float32))

    def cold_init():
        open(os.path.join(out, host + ".fresh"), "w").close()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(11)       # identical init pod-wide
        for n in names:
            shape = fluid.scope_to_numpy(scope, [n])[n].shape
            scope.set_var(n, rng.uniform(-1, 1, shape).astype(np.float32))
        np.savez(os.path.join(out, host + ".init.npz"),
                 **fluid.scope_to_numpy(scope, names))

    trainer = ResilientTrainer(
        ckpt, coordinator=client, read_chunk=read_chunk,
        apply_update=apply_update, program=main, scope=scope,
        save_interval_steps=2, rendezvous_deadline=120.0,
        step_deadline=120.0,
        heartbeat_interval=float(os.environ["PADDLE_TPU_POD_HEARTBEAT"]))
    final = trainer.run(train_step, init_fn=cold_init, max_steps=max_steps)
    np.savez(os.path.join(out, host + ".final.npz"),
             **fluid.scope_to_numpy(scope, names))
    print("WORKER-DONE", host, final, json.dumps(trainer.status()),
          flush=True)
""" % (CRASH_PROB, CRASH_SEED)


def _timeline(events):
    """One host's pod-* journal replayed: verdicts advance the timeline,
    resync / rollback-restore rewind it."""
    line = []
    for rec in events:
        if rec["event"] in ("pod-resync", "pod-rollback-restore"):
            line = [(s, v) for s, v in line if s <= rec["step"]]
        else:
            line.append((rec["step"], rec["event"]))
    return line


@pytest.mark.slow
def test_three_host_pod_through_the_launcher(tmp_path):
    script = _script(tmp_path, "pod_worker.py", POD_WORKER)
    ckpt, out = str(tmp_path / "pod"), str(tmp_path / "out")
    os.makedirs(out)
    torn = PodCheckpointManager(ckpt)
    torn.stage(999, 0, 3, {"fc_0.w_0": np.full((4, 1), 77.0, np.float32)})
    rc, stdout, stderr = _cli(
        ["--nprocs", "3", "--pod-rendezvous", "auto", "--pod-min-world",
         "2", "--max-restarts", "1", "--pod-heartbeat", "0.2",
         "--log-dir", str(tmp_path / "logs"), script, ckpt, out,
         str(MAX_STEPS), str(NAN_STEP)], timeout=POD_WALL)
    logs = "".join(open(os.path.join(tmp_path / "logs", f)).read()
                   for f in sorted(os.listdir(tmp_path / "logs")))
    assert rc == 0, logs[-4000:]
    # the victim died once, by its own seeded hand, and came back
    assert open(os.path.join(out, "host-2.lives")).read().count("life") \
        == 2
    fired = [int(ln.split()[1]) for ln in open(os.path.join(out,
                                                            "chaos.log"))
             if ln.split()[0] == "coord.crash" and ln.split()[3] == "1"]
    assert fired == [CRASH_STEP - 1]
    for ln in open(os.path.join(out, "chaos.log")):
        point, index, value, _ = ln.split()
        assert abs(float(value) - FaultInjector.decision(
            CRASH_SEED, point, int(index))) < 1e-9
    # every first life cold-started: the torn manifest was skipped
    for h in ("host-0", "host-1", "host-2"):
        assert os.path.exists(os.path.join(out, h + ".fresh")), h
    pm = PodCheckpointManager(ckpt)
    assert pm.latest_committed() == MAX_STEPS
    assert 999 not in pm.committed_steps()
    step, items = pm.restore(0)
    assert step == MAX_STEPS
    finals = {h: np.load(os.path.join(out, h + ".final.npz"))
              for h in ("host-0", "host-1", "host-2")}
    for h, f in finals.items():
        assert sorted(f.files) == sorted(items)
        for n in f.files:
            assert f[n].tobytes() == items[n].tobytes(), (h, n)
    per_host, verdicts = {}, {}
    for ln in open(os.path.join(ckpt, "guard.journal")):
        rec = json.loads(ln)
        per_host.setdefault(rec["host"], []).append(rec)
        if rec["event"] not in ("pod-resync", "pod-rollback-restore"):
            verdicts.setdefault((rec["generation"], rec["step"]),
                                set()).add(rec["event"])
    assert all(len(v) == 1 for v in verdicts.values()), verdicts
    for h in ("host-0", "host-1"):
        line = _timeline(per_host[h])
        assert [s for s, _ in line] == list(range(1, MAX_STEPS + 1)), line
        assert {s for s, v in line if v == "pod-skip"} == {NAN_STEP}
        resyncs = [r for r in per_host[h] if r["event"] == "pod-resync"]
        # shrunk to 2 below the crash step; a regrow to 3 (the respawned
        # victim joining before the survivors finish) rewinds again
        assert resyncs[0]["world"] == 2 and \
            resyncs[0]["step"] < CRASH_STEP, resyncs
        assert {r["world"] for r in resyncs[1:]} <= {3}, resyncs
    # the respawned victim finished at the pod's last step
    assert "WORKER-DONE host-2 %d" % MAX_STEPS in logs
    # trained: a held-out batch's loss fell from the initial parameters
    xs = np.random.RandomState(100).randn(64, 4).astype(np.float32)
    ys = xs @ np.array([1.5, -2.0, 0.5, 3.0], np.float32)[:, None]

    def held_out(p):
        (w,) = [p[n] for n in p.files if p[n].ndim == 2]
        (b,) = [p[n] for n in p.files if p[n].ndim == 1]
        return float(np.mean((xs @ w + b - ys) ** 2))

    init = np.load(os.path.join(out, "host-0.init.npz"))
    assert held_out(finals["host-0"]) < held_out(init)


# -- syncheck, the lint every lock of these modules passes -------------------

SYNC_FIXTURE = textwrap.dedent("""\
    import os
    import threading
    import time
    from threading import RLock as R

    RAW = threading.Lock()

    class Bad:
        def __init__(self):
            self._lock = threading.Lock()
            self._cv = threading.Condition()
            self.other = R()

        def write_under_lock(self, f):
            with self._lock:
                time.sleep(0.1)
                os.fsync(f.fileno())
                with open("x") as g:
                    g.write("y")

        def bare_wait(self, flag):
            with self._cv:
                if not flag:
                    self._cv.wait()

        def fine(self, f):
            with self._lock:  # syncheck: ok
                os.fsync(f.fileno())
            with self._lock:
                def helper():
                    time.sleep(1)
                return helper

        def looped(self, pred):
            with self._cv:
                while not pred():
                    self._cv.wait()
    """)

# the port's device waits, where the reference names device_put and
# block_until_ready
DEVICE_FIXTURE = textwrap.dedent("""\
    import torch

    class Step:
        def sync_under_lock(self, t):
            with self._lock:
                torch.cuda.synchronize()
                n = t.item()
                host = t.cpu()
                rows = t.tolist()
            return n, host, rows

        def outside(self, t):
            torch.cuda.synchronize()
            return t.item()
    """)


def test_syncheck_findings_are_the_references(tmp_path):
    from paddle_tpu.tools import syncheck as jsync
    from paddle_tpu_torch.tools import syncheck

    p = tmp_path / "fixture.py"
    p.write_text(SYNC_FIXTURE)
    ours = [f.to_dict() for f in syncheck.check_file(str(p))]
    assert ours == [f.to_dict() for f in jsync.check_file(str(p))]
    assert sorted(f["code"] for f in ours) == \
        ["io-under-lock"] * 4 + ["raw-lock"] * 4 + ["wait-no-loop"]
    assert syncheck.main([str(p), "--quiet"]) == 1
    clean = tmp_path / "clean.py"
    clean.write_text("import threading\n")
    assert syncheck.main([str(clean), "--quiet"]) == 0
    dev = tmp_path / "device.py"
    dev.write_text(DEVICE_FIXTURE)
    got = [(f.line, f.code) for f in syncheck.check_file(str(dev))]
    assert got == [(6, "io-under-lock"), (7, "io-under-lock"),
                   (8, "io-under-lock"), (9, "io-under-lock")]
    assert jsync.check_file(str(dev)) == []


def test_syncheck_cli_json_and_the_port_tree(tmp_path):
    p = tmp_path / "fixture.py"
    p.write_text(SYNC_FIXTURE)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = {}
    for pkg in ("paddle_tpu_torch", "paddle_tpu"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.tools.syncheck", str(p),
             "--json"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 1
        outs[pkg] = json.loads(proc.stdout)
    assert outs["paddle_tpu_torch"] == outs["paddle_tpu"]
    from paddle_tpu_torch.tools import syncheck

    tree = os.path.join(ROOT, "paddle_tpu_torch")
    findings = syncheck.check_paths([tree])
    # the two raw locks older port code holds (ROADMAP Queue C); nothing
    # else, and nothing in the control plane's modules
    assert sorted((os.path.relpath(f.path, tree), f.code)
                  for f in findings) == [
        ("fluid/executor.py", "raw-lock"),
        ("kernels/_build.py", "raw-lock")]
