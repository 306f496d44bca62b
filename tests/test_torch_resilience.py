"""The port's retry policy, elastic master, resilient trainer and
supervised service against the JAX package, on the CPU.

* ``RetryPolicy``: the seeded backoff schedule equals the reference's
  delay for delay, and ``call`` makes the same attempts and sleeps;
* ``TaskQueue``: one scripted sequence of leases, finishes, failures,
  timeouts (a fake clock), hand-backs and an epoch rollover gives the
  reference's counts at every step, and its snapshot file is the
  reference's bytes; each package recovers the other's snapshot;
* ``MasterServer`` / ``MasterClient``: a master restart from its
  snapshot is a pause for the client (its retry), and the injected
  lost request / lost reply chaos points drain the queue exactly once;
* ``ResilientTrainer``: a guarded run over a master interrupted by a
  chaos fault, resumed by a fresh trainer on the same checkpoint
  directory, ends on the parameters of an uninterrupted run, bit for
  bit, with no chunk lost; the reference's trainer makes the same
  leases, steps and checkpoints over the same dataset; pod mode
  (``coordinator=``) takes the reference's constructor rules (its runs
  are in ``test_torch_coordinator.py``);
* ``run_supervised`` / ``SupervisedService``: a ``python -c`` child
  that fails once is respawned and the run ends 0; a SIGKILLed child
  comes back (the one kill of these files).
"""

import os
import threading
import time
import urllib.error

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.parallel import TaskQueue as JaxTaskQueue
from paddle_tpu.resilience import ResilientTrainer as JaxTrainer
from paddle_tpu.resilience import RetryPolicy as JaxRetry
from paddle_tpu_torch import fluid
from paddle_tpu_torch.parallel import (MasterClient, MasterServer,
                                       TaskQueue, master_reader)
from paddle_tpu_torch.resilience import (FaultInjector,
                                         GuardPolicy, ResilientTrainer,
                                         RetryPolicy, StepFault,
                                         SupervisedService, install,
                                         run_supervised)

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _no_ambient_chaos():
    prev = install(None)
    yield
    install(prev)


# -- RetryPolicy ---------------------------------------------------------------

@pytest.mark.parametrize("seed,base,cap", [(0, 0.05, 2.0), (7, 0.01, 0.5),
                                           (123, 0.2, 0.3)])
def test_retry_schedule_equals_reference(seed, base, cap):
    kw = dict(base_delay=base, max_delay=cap, seed=seed)
    got, want = RetryPolicy(**kw).delays(), JaxRetry(**kw).delays()
    a = [next(got) for _ in range(40)]
    b = [next(want) for _ in range(40)]
    assert a == b
    assert all(base <= d <= cap for d in a)


def test_retry_call_attempts_and_sleeps_as_reference():
    def run(cls):
        sleeps, calls = [], []
        clock = iter(i * 0.1 for i in range(1000))

        def fn():
            calls.append(1)
            if len(calls) < 4:
                raise ConnectionError("transient")
            return len(calls)
        pol = cls(max_attempts=6, deadline=10.0, base_delay=0.05,
                  max_delay=1.0, seed=5, sleep=sleeps.append,
                  clock=lambda: next(clock))
        return pol.call(fn), sleeps
    assert run(RetryPolicy) == run(JaxRetry)
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=None, deadline=None)
    with pytest.raises(KeyError):       # non-retryable: raised at once
        RetryPolicy(sleep=lambda s: None).call(
            lambda: (_ for _ in ()).throw(KeyError("x")))


# -- TaskQueue -----------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def queue_script(cls, path):
    """One scripted run of the worker protocol -> (counts after every
    move, the snapshot's bytes)."""
    clock = FakeClock()
    q = cls(timeout_secs=5.0, failure_max=2, clock=clock)
    q.set_dataset([["a", 1], ["b", 2], {"c": [3]}, "d", 5])
    trace = []

    def note(x):
        trace.append((x, q.counts()))
    t0 = q.get_task("w0")
    t1 = q.get_task("w1")
    note(q.task_finished(t0.task_id))
    note(q.task_failed(t1.task_id))
    t2 = q.get_task("w0")
    note(q.task_returned(t2.task_id, "w9"))      # a foreign hand-back
    note(q.task_returned(t2.task_id, "w0"))
    t3 = q.get_task("w2")
    clock.t += 6.0                                # its lease expires
    note(q.check_timeouts())
    note(t3.task_id)
    while True:
        t = q.get_task("w0")
        if t is None:
            break
        note(q.task_finished(t.task_id))
    note(q.all_done())
    q.new_epoch()
    note(q.get_task("w1").chunk)
    q.snapshot(path)
    return trace, open(path, "rb").read()


def test_task_queue_script_and_snapshot_bytes_equal_reference(tmp_path):
    got, got_bytes = queue_script(TaskQueue, str(tmp_path / "t.snap"))
    want, want_bytes = queue_script(JaxTaskQueue, str(tmp_path / "j.snap"))
    assert got == want
    assert got_bytes == want_bytes
    # each package recovers the other's snapshot
    for mine, other in ((TaskQueue, tmp_path / "j.snap"),
                        (JaxTaskQueue, tmp_path / "t.snap")):
        q = mine.recover(str(other))
        assert q.counts() == want[-1][1] | {"pending": 0,
                                            "todo": q.counts()["todo"]}
        assert q.counts()["todo"] == 5


def test_master_reader_and_json_checks():
    q = TaskQueue(timeout_secs=30)
    q.set_dataset([[0, 1], [2, 3], [4, 5]])
    assert sorted(master_reader(q, lambda c: list(c))()) == list(range(6))
    assert q.all_done() and q.counts()["done"] == 3
    with pytest.raises(TypeError):
        TaskQueue().set_dataset([{1: "non-string key"}])
    with pytest.raises(TypeError):
        TaskQueue().set_dataset([np.zeros(2)])


# -- the master over HTTP ------------------------------------------------------

def quick_retry(seed=3):
    return RetryPolicy(max_attempts=None, deadline=20.0, base_delay=0.02,
                       max_delay=0.2,
                       retryable=(urllib.error.URLError, ConnectionError,
                                  TimeoutError), seed=seed)


def test_master_restart_is_a_pause_for_the_client(tmp_path):
    snap = str(tmp_path / "master.snap")
    q = TaskQueue(timeout_secs=30)
    q.set_dataset(["a", "b"])
    server = MasterServer(q, snapshot_path=snap, snapshot_every=1)
    addr = server.start()
    host, port = addr.split(":")
    client = MasterClient(addr, worker="w", retry=quick_retry())
    assert client.ping()
    t = client.get_task()
    assert client.task_finished(t.task_id)
    server.stop()                                # the master goes away
    boot = []

    def restart():
        time.sleep(0.3)                          # the client retries
        s2 = MasterServer(None, host=host, port=int(port),
                          snapshot_path=snap)
        s2.start()
        boot.append(s2)

    th = threading.Thread(target=restart)
    th.start()
    try:
        t2 = client.get_task()                   # spans the outage
        assert t2 is not None and t2.chunk == "b"
        assert client.task_finished(t2.task_id)
        assert client.counts()["done"] == 2 and client.all_done()
    finally:
        th.join()
        for s in boot:
            s.stop()
    with pytest.raises(ValueError):             # queue AND snapshot
        MasterServer(TaskQueue(), snapshot_path=snap)


def test_lost_requests_and_replies_drain_exactly_once():
    install(FaultInjector(spec="master.drop=0.2,master.drop_reply=0.2",
                          seed=4))
    q = TaskQueue(timeout_secs=30)
    q.set_dataset([[i, i + 1] for i in range(0, 12, 2)])
    server = MasterServer(q)
    addr = server.start()
    try:
        client = MasterClient(addr, worker="w", timeout=5,
                              retry=quick_retry(seed=9))
        seen = list(master_reader(client, lambda c: list(c),
                                  poll_interval=0.01)())
    finally:
        server.stop()
        install(None)
    assert q.all_done() and q.counts()["done"] == 6
    # at-least-once: a lost reply to a get_task orphans a lease that
    # re-dispatches, so every record came at least once
    assert set(seen) == set(range(12))


# -- ResilientTrainer ----------------------------------------------------------

def build_net(pkg, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4], "float32")
        y = pkg.layers.data("y", [1], "float32")
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
    return main, startup, loss


W = np.array([1.0, -2.0, 0.5, 3.0], np.float32)


def read_chunk(seed):
    r = np.random.RandomState(seed)
    return [(xs, xs @ W[:, None]) for xs in
            (r.randn(8, 4).astype(np.float32) for _ in range(3))]


def port_run(ckpt, addr, init, fault_at=None, max_steps=None):
    """A guarded port trainer over the master at ``addr``; a chaos fault
    (``guard.fault``, no retry: a StepFault) at step ``fault_at``."""
    main, _, loss = build_net(fluid)
    exe = fluid.Executor(CPU)
    scope = fluid.Scope()
    policy = GuardPolicy("skip")
    trainer = ResilientTrainer(
        ckpt, MasterClient(addr, worker="w0", retry=quick_retry()),
        read_chunk, program=main, scope=scope, save_interval_steps=2,
        poll_interval=0.02, guard=policy, guard_executor=exe)

    def train_step(rec, step):
        if step == fault_at:
            install(FaultInjector(spec="guard.fault=1.0", seed=0))
        try:
            exe.run(main, feed={"x": rec[0], "y": rec[1]},
                    fetch_list=[loss], scope=scope, guard=policy)
        finally:
            install(None)

    def init_fn():
        for n, v in fluid.scope_from_numpy(init, CPU).vars.items():
            scope.set_var(n, v)
    final = trainer.run(train_step, init_fn=init_fn, max_steps=max_steps)
    return final, fluid.scope_to_numpy(scope, list(init)), trainer


def jax_init():
    main, startup, _ = build_net(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return {n: np.asarray(scope.find_var(n)).copy() for n in scope.vars
            if scope.find_var(n) is not None}


def test_trainer_resumes_to_the_uninterrupted_parameters(tmp_path):
    """The fault hits the second chunk's first record, right after the
    first chunk's end was checkpointed: the failed lease requeues, the
    fresh trainer restores step 3 and trains the second chunk as the
    uninterrupted run did (a fault mid-chunk re-delivers the chunk's
    earlier records: at-least-once, as in the reference)."""
    init = jax_init()
    finals = {}
    for name, fault in (("straight", None), ("interrupted", 4)):
        q = TaskQueue(timeout_secs=30)
        q.set_dataset([0, 1])
        server = MasterServer(q, snapshot_path=str(tmp_path / f"{name}.m"))
        addr = server.start()
        ckpt = str(tmp_path / name)
        try:
            if fault is None:
                final, params, _ = port_run(ckpt, addr, init)
            else:
                with pytest.raises(StepFault):
                    port_run(ckpt, addr, init, fault_at=fault)
                assert q.counts()["failed"] == 0 and not q.all_done()
                final, params, trainer = port_run(ckpt, addr, init)
                assert trainer.manager.latest_step() == final
            assert final == 6 and q.all_done()
            assert q.counts()["done"] == 2 and q.counts()["failed"] == 0
        finally:
            server.stop()
        finals[name] = params
    for n in init:
        assert finals["straight"][n].tobytes() == \
            finals["interrupted"][n].tobytes(), n

    # the reference's trainer over the same dataset: the same final step
    # and checkpoints, close parameters (float32, summation order)
    main, startup, loss = build_net(jfluid)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    q = JaxTaskQueue(timeout_secs=30)
    q.set_dataset([0, 1])
    trainer = JaxTrainer(str(tmp_path / "jax"), q, read_chunk, program=main,
                         scope=scope, save_interval_steps=2,
                         poll_interval=0.02)

    def jstep(rec, step):
        exe.run(main, feed={"x": rec[0], "y": rec[1]}, fetch_list=[loss])

    def jinit():
        for n, v in init.items():
            scope.set_var(n, v)
    with jfluid.scope_guard(scope):
        assert trainer.run(jstep, init_fn=jinit) == 6
    assert sorted(os.listdir(str(tmp_path / "jax"))) == \
        sorted(os.listdir(str(tmp_path / "straight")))
    for n in init:
        np.testing.assert_allclose(finals["straight"][n],
                                   np.asarray(scope.find_var(n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_trainer_status_and_pod_mode_refused(tmp_path):
    q = TaskQueue()
    q.set_dataset([0])
    t = ResilientTrainer(str(tmp_path), q, read_chunk)
    assert t.status()["last_step"] is None and not t.status()["guarded"]
    # pod mode takes the reference's constructor rules: a coordinator
    # needs apply_update, and with it the trainer is built
    for cls in (ResilientTrainer, JaxTrainer):
        with pytest.raises(ValueError, match="apply_update"):
            cls(str(tmp_path), None, read_chunk, coordinator=object())
        pod = cls(str(tmp_path), None, read_chunk, coordinator=object(),
                  apply_update=lambda *a: 0)
        assert pod.pod is not None and pod.status()["pod"] is None
        with pytest.raises(ValueError, match="queue"):
            cls(str(tmp_path))


# -- supervised services ---------------------------------------------------------

def test_run_supervised_respawns_a_failing_child(tmp_path):
    """The child fails on its first run (it leaves a marker) and exits 0
    on the second: one respawn, a clean end, both runs in the log."""
    marker = tmp_path / "ran"
    code = (f"import os, sys; m = {str(marker)!r}; "
            f"print('proc', os.environ['PADDLE_TPU_PROC_ID']); "
            f"first = not os.path.exists(m); open(m, 'a').close(); "
            f"sys.exit(3 if first else 0)")
    assert run_supervised(["-c", code], max_restarts=2,
                          log_dir=str(tmp_path / "logs")) == 0
    log = open(tmp_path / "logs" / "rank-0.log").read()
    assert log.count("proc 0") == 2
    # out of budget: the last exit code comes back
    assert run_supervised(["-c", "import sys; sys.exit(5)"],
                          max_restarts=1) == 5


def test_supervised_service_restarts_a_killed_child(tmp_path):
    svc = SupervisedService(["-c", "import time; time.sleep(60)"],
                            max_restarts=1, name="sleeper",
                            log_path=str(tmp_path / "svc.log"),
                            kill_grace=2.0).start()
    try:
        deadline = time.monotonic() + 20
        while svc.pid is None and time.monotonic() < deadline:
            time.sleep(0.02)
        first = svc.pid
        assert svc.kill() == first
        while (svc.restarts < 1 or svc.pid in (None, first)) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.restarts == 1 and svc.running() and svc.pid != first
    finally:
        rc = svc.stop()
    assert rc is not None and rc != 0 and not svc.running()
    assert svc.wait(5)
