"""The pod coordinator and ``ResilientTrainer``'s pod mode against the
JAX package's.

* ``agree_verdicts``, ``pack_arrays`` / ``unpack_arrays`` and
  ``_reduce_mean`` bit for bit on the same inputs (seeded numpy).
* ``PodCoordinator``'s replies (membership views: generation, rank,
  world; barrier verdicts and reduced payloads; staged / committed) to
  one scripted sequence of joins, heartbeats, votes and clock steps, bit
  for bit, and its ``status()`` after each script.
* The HTTP surface: a port ``PodClient`` and a reference ``PodClient``
  in one pod over the port's ``CoordinatorServer`` receive the same
  reduced bytes (the wire format is the reference's); regrow staleness;
  retries through the seeded ``net.partition`` chaos point.
* The two-host in-process pod of ``tests/test_coordinator.py:463`` (a
  host's NaN at step 3 becomes an agreed pod-wide skip) through both
  packages: on numpy parameters the verdict journals, final parameters,
  committed manifests and the manifest restore picks are bit for bit
  the reference's; on a fluid regression (the port's ``Executor`` on
  the CPU against the JAX executor) the journals are equal and the
  final parameters within 1e-5 of the largest, and the port's step is
  one cached executable with a hit at every step after the first,
  while ``apply_update`` replaces the parameters in the scope.
* The trainer's constructor rules, the reference's.
"""

import json
import os
import threading

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid.checkpoint import PodCheckpointManager as JaxPodManager
from paddle_tpu.parallel import coordinator as jcoord
from paddle_tpu.resilience import ResilientTrainer as JaxTrainer
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.checkpoint import PodCheckpointManager
from paddle_tpu_torch.parallel import coordinator as coord
from paddle_tpu_torch.parallel import (CoordinatorServer, PodClient,
                                       StaleGeneration, agree_verdicts)
from paddle_tpu_torch.resilience import FaultInjector, install
from paddle_tpu_torch.resilience.trainer import ResilientTrainer

# limit of the fluid pod's final parameters against the reference's,
# relative to the largest (float32 sums of a 4-wide regression)
FLUID_RTOL = 1e-5
WAIT = 60


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- the agreement rule and the wire format ----------------------------------

@pytest.mark.parametrize("votes,expected,want", [
    ({"a": "continue", "b": "continue"}, ["a", "b"], "continue"),
    ({"a": "continue", "b": "skip"}, ["a", "b"], "skip"),
    ({"a": "skip", "b": "rollback"}, ["a", "b"], "rollback"),
    ({"a": "rollback", "b": "continue", "c": "continue"},
     ["a", "b", "c"], "rollback"),
    ({"a": "continue", "b": "continue"}, ["a", "b", "c"], "skip"),
    ({}, ["a"], "skip"),
    ({"a": "continue", "zombie": "rollback"}, ["a"], "continue"),
])
def test_agree_verdicts_matrix_is_the_references(votes, expected, want):
    assert agree_verdicts(votes, expected) == want
    assert jcoord.agree_verdicts(votes, expected) == want
    for mod in (coord, jcoord):
        with pytest.raises(ValueError, match="unknown verdict"):
            mod.agree_verdicts({"a": "explode"}, ["a"])


def _grad_dicts(seed, hosts=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(hosts):
        out.append({
            "fc_0.w_0": rng.randn(4, 3).astype(np.float32),
            "fc_0.b_0": (rng.randn(3) * 1e-3).astype(np.float32),
            "emb": rng.randn(5, 2).astype(np.float64),
            "half": rng.randn(7).astype(np.float16),
            "count": rng.randint(-9, 9, (2, 2)).astype(np.int32)})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_arrays_and_reduce_mean_bit_for_bit(seed):
    grads = _grad_dicts(seed)
    packed = [coord.pack_arrays(g) for g in grads]
    assert [json.dumps(p, sort_keys=True) for p in packed] == \
        [json.dumps(jcoord.pack_arrays(g), sort_keys=True) for g in grads]
    for g, p in zip(grads, packed):
        back = coord.unpack_arrays(p)
        assert {n: (a.dtype, a.tobytes()) for n, a in back.items()} == \
            {n: (a.dtype, a.tobytes()) for n, a in g.items()}
    ours = coord._reduce_mean(packed)
    ref = jcoord._reduce_mean([jcoord.pack_arrays(g) for g in grads])
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    # the mean accumulates in float64 and casts back once
    want = np.mean(np.stack([g["fc_0.w_0"].astype(np.float64)
                             for g in grads]), axis=0).astype(np.float32)
    assert coord.unpack_arrays(ours)["fc_0.w_0"].tobytes() == \
        want.tobytes()
    assert coord._reduce_mean([]) == jcoord._reduce_mean([]) == {}
    bad = dict(grads[1], extra=np.ones(1, np.float32))
    for mod in (coord, jcoord):
        with pytest.raises(ValueError, match="name sets differ"):
            mod._reduce_mean([mod.pack_arrays(grads[0]),
                              mod.pack_arrays(bad)])


# -- the state machine, one script through both ------------------------------

def _payload(mod, v, n=2):
    return mod.pack_arrays({"w": np.full(n, v, np.float32)})


def _script(mod, kind):
    """One scripted sequence of coordinator calls -> every reply and the
    status after it (clock injected)."""
    clk = FakeClock()
    out = []
    if kind == "rendezvous":
        c = mod.PodCoordinator(world_min=1, world_target=3, world_max=4,
                               clock=clk)
        for h in ("h2", "h0", "h1", "h1", "h3", "h4"):
            out.append(c.join(h))
        out.append([c.join(f"h{i}")["rank"] for i in range(4)])
    elif kind == "heartbeat":
        c = mod.PodCoordinator(world_min=1, world_target=2,
                               heartbeat_timeout=5.0, clock=clk)
        c.join("a")
        gen = c.join("b")["generation"]
        for dt, host in ((3.0, "a"), (3.0, "a"), (0.0, "b")):
            clk.advance(dt)
            out.append(c.heartbeat(host, gen))
        out += [c.join("a"), c.join("b"), c.join("a")]
    elif kind == "quorum":
        c = mod.PodCoordinator(world_min=2, world_target=2,
                               heartbeat_timeout=5.0, clock=clk)
        out += [c.join("a"), c.join("a"), c.join("b")]
        clk.advance(6.0)
        out += [c.heartbeat("a", out[-1]["generation"]), c.join("a"),
                c.join("b"), c.join("a")]
    elif kind == "barrier":
        c = mod.PodCoordinator(world_min=1, world_target=2, clock=clk)
        c.join("a"), c.join("b")
        out += [c.step_sync("a", 1, 1, "continue", _payload(mod, 1.0)),
                c.step_sync("b", 1, 1, "continue", _payload(mod, 3.0)),
                c.step_sync("a", 1, 1, "continue"),
                c.step_sync("a", 1, 2, "continue", _payload(mod, 1.0)),
                c.step_sync("b", 1, 2, "skip"),
                c.step_sync("a", 1, 2, "continue"),
                c.step_sync("a", 1, 3, "skip"),
                c.step_sync("b", 1, 3, "rollback"),
                c.step_sync("a", 1, 4, "continue", _payload(mod, 1.0)),
                c.step_sync("b", 1, 4, "continue", _payload(mod, 1.0, 3)),
                c.step_sync("a", 99, 5, "continue")]
        out += [c.staged("a", 1, 4), c.staged("b", 1, 4),
                c.committed("a", 1, 4), c.committed("a", 1, 2),
                c.committed("a", 7, 6)]
    elif kind == "vote_stall":
        c = mod.PodCoordinator(world_min=1, world_target=3,
                               vote_timeout=10.0, heartbeat_timeout=1e9,
                               clock=clk)
        for h in ("a", "b", "c"):
            c.join(h)
        gen = c.join("a")["generation"]
        out += [c.step_sync("a", gen, 1, "continue", _payload(mod, 1.0)),
                c.step_sync("b", gen, 1, "continue", _payload(mod, 2.0))]
        clk.advance(11.0)
        out += [c.step_sync("a", gen, 1, "continue"),
                c.step_sync("a", gen, 2, "continue"), c.join("a"),
                c.join("b"), c.join("c")]
    out.append(c.status())
    return out


@pytest.mark.parametrize("kind", ["rendezvous", "heartbeat", "quorum",
                                  "barrier", "vote_stall"])
def test_membership_and_barriers_equal_the_references(kind):
    ours, ref = _script(coord, kind), _script(jcoord, kind)
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    if kind == "vote_stall":
        st = ours[-1]      # the evicted host rejoined last: world 3
        assert st["world"] == 3 and st["host_losses"] == 1
        assert ours[4]["world"] == 2
        assert ours[2]["verdict"] == "skip" and "payload" not in ours[2]
        assert ours[3]["status"] == "stale"
    if kind == "barrier":
        assert coord.unpack_arrays(ours[1]["payload"])["w"].tolist() == \
            [2.0, 2.0]
        assert ours[9]["verdict"] == "skip" and \
            "shapes differ" in ours[9]["error"]


def test_coordinator_needs_world_min_and_a_host():
    for mod in (coord, jcoord):
        with pytest.raises(ValueError, match="world_min"):
            mod.PodCoordinator(world_min=0)
        with pytest.raises(ValueError, match="world_max"):
            mod.PodCoordinator(world_min=3, world_max=2)
        with pytest.raises(ValueError, match="host id"):
            mod.PodCoordinator().join("")
        with pytest.raises(ValueError, match="verdict must be"):
            mod.PodCoordinator().step_sync("a", 0, 1, "maybe")


# -- HTTP and the clients ----------------------------------------------------

def test_port_and_reference_clients_share_one_pod(tmp_path):
    srv = CoordinatorServer(world_min=1, world_target=2,
                            vote_timeout=30.0)
    addr = srv.start()
    try:
        a = PodClient(addr, "a", retry=False, poll_interval=0.01)
        b = jcoord.PodClient(addr, "b", retry=False, poll_interval=0.01)
        assert a.ping() and b.ping()
        views = {}
        t = threading.Thread(
            target=lambda: views.__setitem__("a", a.join(deadline=10)))
        t.start()
        views["b"] = b.join(deadline=10)
        t.join(10)
        assert views["a"].world == views["b"].world == 2
        assert {views["a"].rank, views["b"].rank} == {0, 1}
        out = {}

        def step(cl, g):
            out[cl.host] = cl.step_sync(1, "continue", g, deadline=10)

        ga = {"w": np.array([1.0, -2.5], np.float32)}
        gb = {"w": np.array([3.0, 0.5], np.float32)}
        t = threading.Thread(target=step, args=(a, ga))
        t.start()
        step(b, gb)
        t.join(10)
        (va, ra), (vb, rb) = out["a"], out["b"]
        assert va == vb == "continue"
        assert ra["w"].tobytes() == rb["w"].tobytes()
        want = jcoord.unpack_arrays(jcoord._reduce_mean(
            [jcoord.pack_arrays(ga), jcoord.pack_arrays(gb)]))["w"]
        assert ra["w"].tobytes() == want.tobytes()
        # a third host regrows the pod: the old generation is stale
        c = PodClient(addr, "c", retry=False, poll_interval=0.01)
        c.join(deadline=10)
        with pytest.raises(StaleGeneration):
            a.step_sync(2, "continue", ga, deadline=10)
        assert a.resync(deadline=10).world == 3
        assert srv.status()["world"] == 3
    finally:
        srv.stop()


def test_client_retries_through_injected_partition(tmp_path):
    srv = CoordinatorServer(world_min=1, world_target=1)
    addr = srv.start()
    log = str(tmp_path / "chaos.journal")
    prev = install(FaultInjector(spec="net.partition=0.5", seed=3,
                                 log_path=log))
    try:
        cl = PodClient(addr, "solo", poll_interval=0.01)
        assert cl.join(deadline=30).world == 1
        verdict, reduced = cl.step_sync(
            1, "continue", {"w": np.ones(2, np.float32)}, deadline=30)
    finally:
        install(prev)
        srv.stop()
    assert verdict == "continue"
    assert reduced["w"].tobytes() == np.ones(2, np.float32).tobytes()
    draws = [ln.split() for ln in open(log) if ln.startswith("net.")]
    # dropped requests were retried: some draws fired, every one replays
    # from the seed
    assert any(d[3] == "1" for d in draws) and any(d[3] == "0"
                                                   for d in draws)
    for point, index, value, _ in draws:
        assert abs(float(value) - FaultInjector.decision(
            3, point, int(index))) < 1e-9


# -- the pod train loop through both packages --------------------------------

W_TRUE = np.array([1.5, -2.0, 0.5, 3.0], np.float32)
NAN_STEP, MAX_STEPS = 3, 6


def _read_chunk(step, rank, world):
    r = np.random.RandomState(step)
    xs = r.randn(8, 4).astype(np.float32)
    ys = (xs @ W_TRUE[:, None]).astype(np.float32)
    return xs[rank::world], ys[rank::world]


def _numpy_worker(pkg, addr, host, ckpt, results):
    params = {}
    client = pkg["client"](addr, host, retry=False, poll_interval=0.01)

    def train_step(rec, step):
        xs, ys = rec
        g = 2.0 * xs.T @ (xs @ params["w"] - ys) / len(xs)
        if step == NAN_STEP and host == "hb":
            g = g * np.nan
        return True, {"w": g.astype(np.float32)}

    def apply_update(reduced, step):
        params["w"] = (params["w"] - 0.05 * reduced["w"]).astype(
            np.float32)

    trainer = pkg["trainer"](
        ckpt, coordinator=client, read_chunk=_read_chunk,
        apply_update=apply_update, state_get=lambda: dict(params),
        state_set=lambda items: params.update(items),
        save_interval_steps=2, rendezvous_deadline=WAIT,
        step_deadline=WAIT, heartbeat_interval=0.2)
    final = trainer.run(train_step, init_fn=lambda: params.update(
        w=np.zeros((4, 1), np.float32)), max_steps=MAX_STEPS)
    results[host] = (final, params["w"].copy(), trainer.status())


def _fluid_regression(fl):
    """The fc regression of ``tests/test_coordinator_e2e.py``, built in
    the calling thread (program building uses global guards)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 11
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data("x", [4], "float32")
        y = fl.layers.data("y", [1], "float32")
        pred = fl.layers.fc(input=x, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        pairs = fl.append_backward(loss)
    return main, startup, loss, pairs


def _fluid_worker(pkg, addr, host, ckpt, results):
    fl = pkg["fluid"]
    main, startup, loss, pairs = pkg["programs"][host]
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    names = [p.name for p, _ in pairs]
    gvars = [g for _, g in pairs]
    client = pkg["client"](addr, host, retry=False, poll_interval=0.01)

    def train_step(rec, step):
        xs, ys = rec
        out = exe.run(main, feed={"x": xs, "y": ys},
                      fetch_list=[loss] + gvars, scope=scope)
        grads = {n: np.asarray(g) for n, g in zip(names, out[1:])}
        if step == NAN_STEP and host == "hb":
            grads = {k: v * np.nan for k, v in grads.items()}
        return True, grads

    def apply_update(reduced, step):
        for n in names:
            cur = fl.scope_to_numpy(scope, [n])[n] \
                if hasattr(fl, "scope_to_numpy") \
                else np.asarray(scope.find_var(n))
            scope.set_var(n, (cur - 0.05 * reduced[n]).astype(np.float32))

    def init():
        # the two packages' startup draws differ: both start from the
        # same seeded values instead
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(5)
        for n in names:
            shape = np.asarray(scope.find_var(n)).shape
            scope.set_var(n, rng.uniform(-1, 1, shape).astype(np.float32))

    trainer = pkg["trainer"](
        ckpt, coordinator=client, read_chunk=_read_chunk,
        apply_update=apply_update, program=main, scope=scope,
        save_interval_steps=2, rendezvous_deadline=WAIT,
        step_deadline=WAIT, heartbeat_interval=0.2)
    final = trainer.run(train_step, init_fn=init, max_steps=MAX_STEPS)
    state = {n: np.asarray(scope.find_var(n)) for n in names}
    stats = exe.cache_stats() if hasattr(exe, "cache_stats") else None
    results[host] = (final, state, stats)


PORT = {"server": CoordinatorServer, "client": PodClient,
        "trainer": ResilientTrainer, "fluid": fluid,
        "pod": PodCheckpointManager}
REF = {"server": jcoord.CoordinatorServer, "client": jcoord.PodClient,
       "trainer": JaxTrainer, "fluid": jfluid, "pod": JaxPodManager}


def _run_pod(pkg, worker, ckpt):
    if worker is _fluid_worker:
        pkg = dict(pkg, programs={h: _fluid_regression(pkg["fluid"])
                                  for h in ("ha", "hb")})
    srv = pkg["server"](world_min=1, world_target=2, vote_timeout=60.0)
    addr = srv.start()
    results = {}
    try:
        threads = [threading.Thread(target=worker,
                                    args=(pkg, addr, h, ckpt, results))
                   for h in ("ha", "hb")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.stop()
    verdicts = []
    for ln in open(os.path.join(ckpt, "guard.journal")):
        rec = json.loads(ln)
        if rec["event"].startswith("pod-"):
            verdicts.append((rec["host"], rec["generation"], rec["step"],
                             rec["event"], rec.get("world")))
    return results, sorted(verdicts)


def _manifests(pkg, ckpt):
    pm = pkg["pod"](ckpt)
    step, items = pm.restore(0)
    return pm.committed_steps(), step, {
        n: np.asarray(a).tobytes() for n, a in items.items()}


def test_two_host_numpy_pod_is_the_references_bit_for_bit(tmp_path):
    ours, jv = {}, {}
    ours["res"], ours["v"] = _run_pod(PORT, _numpy_worker,
                                      str(tmp_path / "port"))
    jv["res"], jv["v"] = _run_pod(REF, _numpy_worker, str(tmp_path / "ref"))
    assert ours["v"] == jv["v"]
    assert {(s, e) for _, _, s, e, _ in ours["v"]} == {
        (s, "pod-skip" if s == NAN_STEP else "pod-continue")
        for s in range(1, MAX_STEPS + 1)}
    for h in ("ha", "hb"):
        assert ours["res"][h][0] == jv["res"][h][0] == MAX_STEPS
        assert ours["res"][h][1].tobytes() == jv["res"][h][1].tobytes()
        assert ours["res"][h][2]["pod"]["world"] == 2
    assert ours["res"]["ha"][1].tobytes() == ours["res"]["hb"][1].tobytes()
    got = _manifests(PORT, str(tmp_path / "port"))
    assert got == _manifests(REF, str(tmp_path / "ref"))
    assert got[0][-1] == got[1] == MAX_STEPS
    assert got[2]["w"] == ours["res"]["ha"][1].tobytes()
    # the reference's manager restores the port's manifests alike
    assert _manifests(REF, str(tmp_path / "port")) == got


def test_two_host_fluid_pod_matches_the_reference(tmp_path):
    ours, ov = _run_pod(PORT, _fluid_worker, str(tmp_path / "port"))
    ref, rv = _run_pod(REF, _fluid_worker, str(tmp_path / "ref"))
    assert ov == rv
    assert {(s, e) for _, _, s, e, _ in ov if s == NAN_STEP} == \
        {(NAN_STEP, "pod-skip")}
    for h in ("ha", "hb"):
        assert ours[h][0] == ref[h][0] == MAX_STEPS
        for n, v in ours[h][1].items():
            want = ref[h][1][n]
            tol = FLUID_RTOL * float(np.abs(want).max())
            np.testing.assert_allclose(v, want, rtol=0, atol=tol,
                                       err_msg=n)
            assert v.tobytes() == ours["ha"][1][n].tobytes()
        # the startup program and one step signature: the step runs once
        # eagerly, then a hit a step, with the parameters replaced in the
        # scope by every apply_update
        ex = ours[h][2]["executable"]
        assert (ex["size"], ex["misses"], ex["hits"]) == \
            (2, 2, MAX_STEPS - 1), ex
    steps, step, _ = _manifests(PORT, str(tmp_path / "port"))
    assert (steps, step) == _manifests(REF, str(tmp_path / "ref"))[:2]


class _HostDied(BaseException):
    """Ends a pod host's thread the way SIGKILL ends its process."""


def _dying_client(cls, step):
    class Dying(cls):
        def step_sync(self, s, *a, **kw):
            if s == step:
                # no vote, no more heartbeats: a host lost mid-step
                self.stop_heartbeats()
                raise _HostDied(self.host)
            return super().step_sync(s, *a, **kw)
    return Dying


LOSS_STEP, LOSS_MAX = 5, 8


def _loss_worker(pkg, addr, host, ckpt, results):
    params = {}
    cls = pkg["client"]
    if host == "hc":
        cls = _dying_client(cls, LOSS_STEP)
    client = cls(addr, host, retry=False, poll_interval=0.01)

    def train_step(rec, step):
        xs, ys = rec
        g = 2.0 * xs.T @ (xs @ params["w"] - ys) / len(xs)
        if step == 2 and host == "ha":
            g = g * np.nan
        return True, {"w": g.astype(np.float32)}

    def apply_update(reduced, step):
        params["w"] = (params["w"] - 0.05 * reduced["w"]).astype(
            np.float32)

    def read_chunk(step, rank, world):
        r = np.random.RandomState(step)
        xs = r.randn(12, 4).astype(np.float32)
        ys = (xs @ W_TRUE[:, None]).astype(np.float32)
        return xs[rank::world], ys[rank::world]

    trainer = pkg["trainer"](
        ckpt, coordinator=client, read_chunk=read_chunk,
        apply_update=apply_update, state_get=lambda: dict(params),
        state_set=lambda items: params.update(items),
        save_interval_steps=2, rendezvous_deadline=WAIT,
        step_deadline=WAIT, heartbeat_interval=0.1)
    try:
        final = trainer.run(train_step, init_fn=lambda: params.update(
            w=np.zeros((4, 1), np.float32)), max_steps=LOSS_MAX)
    except _HostDied:
        final = None
    results[host] = (final, params["w"].copy())


def _run_loss_pod(pkg, ckpt):
    # eviction by heartbeat silence only (the vote timeout is far off),
    # so both packages take the same path
    srv = pkg["server"](world_min=2, world_target=3, heartbeat_timeout=1.0,
                        vote_timeout=120.0)
    addr = srv.start()
    results = {}
    try:
        threads = [threading.Thread(target=_loss_worker,
                                    args=(pkg, addr, h, ckpt, results))
                   for h in ("ha", "hb", "hc")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        status = srv.status()
    finally:
        srv.stop()
    events = [json.loads(ln) for ln in open(os.path.join(ckpt,
                                                         "guard.journal"))]
    return results, status, sorted(
        (e["host"], e["step"], e["event"], e["generation"], e["world"])
        for e in events if e["event"].startswith("pod-"))


def test_host_loss_in_process_is_the_references(tmp_path):
    """The in-process counterpart of the launcher's 3-host chaos pod: a
    host lost entering step 5's barrier; the survivors re-rendezvous at
    world 2, rewind to step 4's manifest and finish, bit for bit the
    reference's (journals, parameters, manifests)."""
    ours, ost, oj = _run_loss_pod(PORT, str(tmp_path / "port"))
    ref, rst, rj = _run_loss_pod(REF, str(tmp_path / "ref"))
    assert oj == rj
    assert ost == rst and ost["world"] == 2 and ost["host_losses"] == 1
    assert ours["hc"][0] is None and ref["hc"][0] is None
    for h in ("ha", "hb"):
        assert ours[h][0] == ref[h][0] == LOSS_MAX
        assert ours[h][1].tobytes() == ref[h][1].tobytes()
        assert ours[h][1].tobytes() == ours["ha"][1].tobytes()
        events = [(st, ev, w) for host, st, ev, _, w in oj if host == h]
        assert ("pod-resync" in [ev for _, ev, _ in events])
        assert (LOSS_STEP - 1, "pod-resync", 2) in events
        assert (2, "pod-skip", 3) in events
    got = _manifests(PORT, str(tmp_path / "port"))
    assert got == _manifests(REF, str(tmp_path / "ref"))
    assert got[1] == LOSS_MAX


def test_trainer_constructor_rules_are_the_references(tmp_path):
    for cls in (ResilientTrainer, JaxTrainer):
        with pytest.raises(ValueError, match="apply_update"):
            cls(str(tmp_path), coordinator=object())
        with pytest.raises(ValueError, match="queue"):
            cls(str(tmp_path))
        t = cls(str(tmp_path), coordinator=object(),
                apply_update=lambda *a: None)
        assert t.status()["pod"] is None and t.pod is not None
