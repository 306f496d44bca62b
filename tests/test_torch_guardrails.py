"""The port's training guardrails (``resilience/guardrails.py`` and
``Executor.run(..., guard=...)``) against the JAX package, on the CPU.

Both packages build the same programs; the JAX startup program's arrays
initialize both scopes (``scope_from_numpy``), and the same numpy-seeded
batches, clean and poisoned, go through both:

* guarded healthy steps are bitwise the port's own unguarded steps, and
  within ``TOL`` (float32, summation order only) of the reference's
  guarded steps, on the reference tests' fc regression net and on a
  2-layer, d_model 16 Transformer (Adam, dropout on: the state the gate
  keeps is the parameters and both moments);
* ``health_stats()`` and the trainer's guard journal equal the
  reference's over one scripted sequence of good and bad batches under
  each of ``raise``, ``skip`` and ``rollback``, and a poisoned step
  leaves the state bitwise pre-step (``rollback``: the snapshot);
* ``StepTimeout`` and a retried transient, driven by the seeded chaos
  injector, count as the reference counts them;
* a fault after the launch is retried once the state is restored from
  the guard's pre-step copy, and surfaces as ``StepFault`` when it
  cannot be (the port's counterpart of the reference's donated-buffer
  check);
* ``layers.isfinite`` and ``poison_feed`` equal the reference's.
"""

import json

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import TaskQueue as JaxTaskQueue
from paddle_tpu.resilience import FaultInjector as JaxInjector
from paddle_tpu.resilience import GuardPolicy as JaxPolicy
from paddle_tpu.resilience import ResilientTrainer as JaxTrainer
from paddle_tpu.resilience import RetryPolicy as JaxRetry
from paddle_tpu.resilience import install as jax_install
from paddle_tpu.resilience.guardrails import poison_feed as jax_poison
from paddle_tpu_torch import fluid
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import TaskQueue
from paddle_tpu_torch.resilience import (FaultInjector, GuardPolicy,
                                         NonFiniteError,
                                         NonFiniteEscalation,
                                         ResilientTrainer, RetryPolicy,
                                         StepFault, StepTimeout, install)
from paddle_tpu_torch.resilience import guardrails as gr

CPU = fluid.CPUPlace()
# float32 on both sides, summation order only (XLA's fused reductions
# against eager PyTorch)
TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_PREFIX = ("fc_0", "tf")


@pytest.fixture(autouse=True)
def _no_ambient_chaos():
    """Each test owns both packages' process-global injectors."""
    prev, jprev = install(None), jax_install(None)
    yield
    install(prev)
    jax_install(jprev)


def build_net(pkg, seed=7, metric=False):
    """The reference tests' fc regression step -> (main, startup, cost);
    ``metric`` adds a write-only persistable (``last_cost``)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4], "float32")
        y = pkg.layers.data("y", [1], "float32")
        pred = pkg.layers.fc(input=x, size=1)
        cost = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        if metric:
            var = pkg.layers.create_global_var(
                [1], 0.0, "float32", persistable=True, name="last_cost")
            pkg.layers.assign(cost, var)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def clean_feed(seed=0):
    r = np.random.RandomState(seed)
    return {"x": r.rand(8, 4).astype(np.float32),
            "y": r.rand(8, 1).astype(np.float32)}


def bad_feed(value=np.nan, seed=0):
    feed = clean_feed(seed)
    feed["x"][0, 0] = value
    return feed


class Pair:
    """One program in both packages, both scopes from the JAX startup
    program's arrays."""

    def __init__(self, builder=build_net, **kw):
        self.jmain, jstart, self.jcost = builder(jfluid, **kw)
        self.tmain, _, self.tcost = builder(fluid, **kw)
        self.jexe = jfluid.Executor(jfluid.CPUPlace())
        self.jscope = jfluid.Scope()
        with jfluid.scope_guard(self.jscope):
            self.jexe.run(jstart)
        self.init = {n: np.asarray(self.jscope.find_var(n)).copy()
                     for n in self.jscope.vars
                     if self.jscope.find_var(n) is not None}
        self.texe = fluid.Executor(CPU)
        self.tscope = fluid.scope_from_numpy(self.init, CPU)

    def jrun(self, feed, guard=None):
        with jfluid.scope_guard(self.jscope):
            out, = self.jexe.run(self.jmain, feed=feed,
                                 fetch_list=[self.jcost], guard=guard)
        return np.asarray(out)

    def trun(self, feed, guard=None):
        out, = self.texe.run(self.tmain, feed=feed, fetch_list=[self.tcost],
                             scope=self.tscope, guard=guard)
        return np.asarray(out)

    def jstate(self):
        return {n: np.asarray(self.jscope.find_var(n)).copy()
                for n in self.init}

    def tstate(self):
        return fluid.scope_to_numpy(self.tscope, list(self.init))


def bitwise(a, b):
    assert set(a) == set(b)
    for n in a:
        assert np.asarray(a[n]).tobytes() == np.asarray(b[n]).tobytes(), n


def close(got, want):
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


# -- healthy steps: bitwise the unguarded port, close to the reference -------

@pytest.mark.parametrize("policy", [
    ("skip", {}), ("rollback", {"snapshot_every": 2}),
    ("raise", {"check": ("loss", "grads")})])
def test_healthy_guarded_steps_bitwise_unguarded(policy):
    name, kw = policy
    plain, guarded = Pair(), Pair()
    for i in range(3):
        want = plain.trun(clean_feed(i))
        got = guarded.trun(clean_feed(i), GuardPolicy(name, **kw))
        ref = guarded.jrun(clean_feed(i), JaxPolicy(name, **kw))
        assert got.tobytes() == want.tobytes()
        np.testing.assert_allclose(got, ref, **TOL)
        bitwise(guarded.tstate(), plain.tstate())
        close(guarded.tstate(), guarded.jstate())
    assert guarded.texe.health_stats() == guarded.jexe.health_stats()
    assert guarded.texe.health_stats()["guarded_steps"] == 3
    # one cached signature: the guarded step replays like any other
    assert guarded.texe.cache_stats()["executable"]["hits"] == 2


def build_transformer(pkg, seed=7):
    T = JT if pkg is jfluid else TT
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        cost, _, _ = T.transformer(
            64, 64, 32, n_layer=2, n_head=2, d_key=8, d_value=8,
            d_model=16, d_inner_hid=32, dropout_rate=0.1, src_seq_len=16,
            trg_seq_len=16, fused=True, param_prefix="tf",
            materialize_attn_bias=False, fused_vocab_loss=True)
        pkg.optimizer.Adam(1e-3).minimize(cost)
    return main, startup, cost


def transformer_feed(seed, batch=2, bad=False):
    rng = np.random.RandomState(seed)
    pos = np.tile(np.arange(16), (batch, 1))
    feed = {"src_word": rng.randint(2, 64, (batch, 16)), "src_pos": pos,
            "trg_word": rng.randint(2, 64, (batch, 16)), "trg_pos": pos,
            "lbl_word": rng.randint(2, 64, (batch, 16)),
            "lbl_weight": np.ones((batch, 16), np.float32)}
    if bad:
        feed["lbl_weight"][0, 0] = np.nan
    return feed


def test_transformer_guarded_adam_steps_and_skip():
    """Adam with dropout, the causal bias-free path of the flash kernels
    (their plain versions here): every written var (parameters, both
    moments, the beta powers) bitwise the unguarded port's after each
    step, and a poisoned step leaves every var bitwise pre-step.  (The
    port's dropout masks are not XLA's, so this one is held within the
    port; the fc net's tests hold the reference.)"""
    plain = Pair(build_transformer)
    guarded = Pair(build_transformer)
    pol = GuardPolicy("skip")
    for i in range(3):
        want = plain.trun(transformer_feed(i))
        got = guarded.trun(transformer_feed(i), pol)
        assert got.tobytes() == want.tobytes()
        assert np.isfinite(got).all()
        bitwise(guarded.tstate(), plain.tstate())
    pre = guarded.tstate()
    out = guarded.trun(transformer_feed(9, bad=True), pol)
    assert not np.isfinite(out).all()
    bitwise(guarded.tstate(), pre)
    stats = guarded.texe.health_stats()
    assert stats["skips"] == 1 and stats["guarded_steps"] == 4
    # and the gate kept more than the parameters
    moments = [n for n in pre if "moment" in n]
    assert moments and all(n in pre for n in moments)


# -- scripted sequences: counters and journals as the reference's ------------

SCRIPT = ["good", "bad", "good", "inf", "bad", "good"]


def scripted(run, policy_cls, name, kw):
    outcomes = []
    for i, kind in enumerate(SCRIPT):
        feed = (clean_feed(i) if kind == "good"
                else bad_feed(np.nan if kind == "bad" else np.inf, i))
        try:
            run(feed, policy_cls(name, **kw))
            outcomes.append("ok")
        except (NonFiniteError, NonFiniteEscalation) as e:
            outcomes.append(type(e).__name__)
        except Exception as e:       # the reference's own classes
            outcomes.append(type(e).__name__)
    return outcomes


@pytest.mark.parametrize("name,kw", [
    ("raise", {}), ("skip", {"escalate_after": 2}),
    ("rollback", {"snapshot_every": 2})])
def test_health_stats_match_reference_over_a_script(name, kw):
    p = Pair()
    got = scripted(p.trun, GuardPolicy, name, kw)
    want = scripted(p.jrun, JaxPolicy, name, kw)
    assert got == want
    assert p.texe.health_stats() == p.jexe.health_stats()
    close(p.tstate(), p.jstate())
    assert all(np.isfinite(v).all() for v in p.tstate().values())


def test_skip_is_bitwise_pre_step_and_rollback_the_snapshot():
    p = Pair()
    p.trun(clean_feed(0), GuardPolicy("skip"))
    pre = p.tstate()
    out = p.trun(bad_feed(), GuardPolicy("skip"))
    assert not np.isfinite(out).all()
    bitwise(p.tstate(), pre)
    # rollback, snapshot every 3: back to the state before the first of
    # the three steps, past the pre-step state
    q = Pair()
    pol = GuardPolicy("rollback", snapshot_every=3)
    init = q.tstate()
    q.trun(clean_feed(0), pol)
    q.trun(clean_feed(1), pol)
    pre_bad = q.tstate()
    q.trun(bad_feed(), pol)
    bitwise(q.tstate(), init)
    assert any(pre_bad[n].tobytes() != init[n].tobytes() for n in init)
    assert q.texe.health_stats()["rollbacks"] == 1


def test_bad_step_drops_write_only_persistable():
    p = Pair(metric=True)
    p.trun(clean_feed(), GuardPolicy("skip"))
    good = fluid.scope_to_numpy(p.tscope, ["last_cost"])["last_cost"]
    p.trun(bad_feed(), GuardPolicy("skip"))
    after = fluid.scope_to_numpy(p.tscope, ["last_cost"])["last_cost"]
    assert np.isfinite(good).all() and after.tobytes() == good.tobytes()


def guarded_trainer(pkg, tmp, policy, bad_records):
    """The reference tests' NaN-poisoned record stream through a guarded
    ResilientTrainer over an in-process TaskQueue -> (final step, guard
    journal lines, health stats, the scope's arrays)."""
    is_jax = pkg is jfluid
    main, startup, cost = build_net(pkg)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    q = (JaxTaskQueue if is_jax else TaskQueue)(timeout_secs=30)
    q.set_dataset([0, 1])

    def read_chunk(seed):
        r = np.random.RandomState(seed)
        out = []
        for j in range(4):
            xs = r.rand(8, 4).astype(np.float32)
            ys = r.rand(8, 1).astype(np.float32)
            if (seed, j) in bad_records:
                xs[0, 0] = np.nan
            out.append((xs, ys))
        return out

    if is_jax:
        def train_step(rec, step):
            with jfluid.scope_guard(scope):
                exe.run(main, feed={"x": rec[0], "y": rec[1]},
                        fetch_list=[cost], guard=policy)

        def init_fn():
            with jfluid.scope_guard(scope):
                exe.run(startup)
        trainer = JaxTrainer(tmp, q, read_chunk, program=main, scope=scope,
                             save_interval_steps=2, poll_interval=0.02,
                             guard=policy, guard_executor=exe)
    else:
        def train_step(rec, step):
            exe.run(main, feed={"x": rec[0], "y": rec[1]},
                    fetch_list=[cost], scope=scope, guard=policy)

        def init_fn():
            exe.run(startup, scope=scope)
        trainer = ResilientTrainer(tmp, q, read_chunk, program=main,
                                   scope=scope, save_interval_steps=2,
                                   poll_interval=0.02, guard=policy,
                                   guard_executor=exe)
    with jfluid.scope_guard(scope) if is_jax else _null():
        final = trainer.run(train_step, init_fn=init_fn)
    lines = [json.loads(ln) for ln in open(trainer.guard_journal_path())] \
        if __import__("os").path.exists(trainer.guard_journal_path()) else []
    for ln in lines:
        ln.pop("restored_step", None)
    state = {n: np.asarray(scope.find_var(n)) for n in scope.vars
             if scope.find_var(n) is not None} if is_jax else \
        fluid.scope_to_numpy(scope)
    return final, lines, exe.health_stats(), state, q.counts()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("name,kw", [
    ("skip", {}), ("rollback", {"snapshot_every": 2}),
    ("skip", {"escalate_after": 1})])
def test_trainer_guard_journal_matches_reference(tmp_path, name, kw):
    """Startup in each package from the same seed draws different
    initial weights, so the two runs are compared by their accounting:
    final step, journal events, health counters, lease counts — and
    finite parameters."""
    # the second chunk's: a checkpoint exists (the first chunk's end) for
    # the escalation's restore
    bad = {(1, 1), (1, 2)}
    t = guarded_trainer(fluid, str(tmp_path / "t"), GuardPolicy(name, **kw),
                        bad)
    j = guarded_trainer(jfluid, str(tmp_path / "j"), JaxPolicy(name, **kw),
                        bad)
    assert t[0] == j[0] == 8
    assert t[1] == j[1] and t[1]
    assert t[2] == j[2]
    assert t[4] == j[4]
    assert all(np.isfinite(v).all() for v in t[3].values())


def test_raise_policy_stops_the_trainer_like_the_reference(tmp_path):
    bad = {(0, 1)}
    with pytest.raises(NonFiniteError):
        guarded_trainer(fluid, str(tmp_path / "t"), GuardPolicy("raise"),
                        bad)
    with pytest.raises(FloatingPointError):
        guarded_trainer(jfluid, str(tmp_path / "j"), JaxPolicy("raise"),
                        bad)


# -- chaos: the watchdog and a retried transient -----------------------------

def test_chaos_nan_schedule_skips_as_the_reference():
    seed, prob, steps = 3, 0.5, 6
    expected = sum(FaultInjector.decision(seed, "guard.nan", i) < prob
                   for i in range(steps))
    assert 0 < expected < steps
    p = Pair()
    install(FaultInjector(spec=f"guard.nan={prob}", seed=seed))
    jax_install(JaxInjector(spec=f"guard.nan={prob}", seed=seed))
    for i in range(steps):
        p.trun(clean_feed(i), GuardPolicy("skip"))
        p.jrun(clean_feed(i), JaxPolicy("skip"))
    assert p.texe.health_stats() == p.jexe.health_stats()
    assert p.texe.health_stats()["skips"] == expected


def test_transient_fault_is_retried_to_the_clean_result():
    d0 = FaultInjector.decision(0, "guard.fault", 0)
    d1 = FaultInjector.decision(0, "guard.fault", 1)
    assert d0 < d1
    prob = (d0 + d1) / 2
    plain, p = Pair(), Pair()
    want = plain.trun(clean_feed())
    install(FaultInjector(spec=f"guard.fault={prob}", seed=0))
    jax_install(JaxInjector(spec=f"guard.fault={prob}", seed=0))
    retry = dict(max_attempts=3, deadline=None, base_delay=0.001,
                 max_delay=0.002, seed=0)
    got = p.trun(clean_feed(), GuardPolicy("skip",
                                           retry=RetryPolicy(**retry)))
    p.jrun(clean_feed(), JaxPolicy("skip", retry=JaxRetry(**retry)))
    assert got.tobytes() == want.tobytes()
    assert p.texe.health_stats() == p.jexe.health_stats()
    assert p.texe.health_stats()["retries"] == 1


def test_step_timeout_on_an_injected_hang():
    import time

    p = Pair()
    p.trun(clean_feed(), GuardPolicy("skip"))
    p.jrun(clean_feed(), JaxPolicy("skip"))
    install(FaultInjector(spec="guard.hang=1.0", seed=1, hang_seconds=1.0))
    jax_install(JaxInjector(spec="guard.hang=1.0", seed=1,
                            hang_seconds=1.0))
    t0 = time.monotonic()
    with pytest.raises(StepTimeout) as ei:
        p.trun(clean_feed(1), GuardPolicy("skip", step_timeout=0.2))
    assert time.monotonic() - t0 < 0.9
    assert ei.value.retry_safe
    with pytest.raises(TimeoutError):
        p.jrun(clean_feed(1), JaxPolicy("skip", step_timeout=0.2))
    assert p.texe.health_stats() == p.jexe.health_stats()
    assert p.texe.health_stats()["watchdog_fires"] == 1
    time.sleep(1.0)                  # let the abandoned workers wake


def test_fault_after_launch_retries_only_from_a_restored_state(monkeypatch):
    """A transient raised after the step wrote its state: on the CPU the
    guard's pre-step copies are known complete, so the state is restored
    and the retry runs the clean step again (bitwise the clean result);
    where they are not (a replay's, on the card) the fault surfaces as
    StepFault and the scope keeps the rollback snapshot."""
    import paddle_tpu_torch.fluid.executor as ex

    real = ex.run_block_ops
    calls = {"n": 0, "fail_on": {2}}

    def flaky(*a, **k):
        out = real(*a, **k)
        calls["n"] += 1
        if calls["n"] in calls["fail_on"]:
            raise ConnectionError("transport dropped after the launch")
        return out

    plain, p = Pair(), Pair()
    plain.trun(clean_feed(0))
    want = plain.trun(clean_feed(1))
    monkeypatch.setattr(ex, "run_block_ops", flaky)
    retry = RetryPolicy(max_attempts=3, deadline=None, base_delay=0.001,
                        max_delay=0.002, seed=0)
    p.trun(clean_feed(0), GuardPolicy("skip", retry=retry))
    got = p.trun(clean_feed(1), GuardPolicy("skip", retry=retry))
    assert got.tobytes() == want.tobytes()
    bitwise(p.tstate(), plain.tstate())
    assert p.texe.health_stats()["retries"] == 1
    assert gr.state_buffers_live(p.tscope.vars)

    # the other branch: the pre-step copies unknown -> not retryable
    q = Pair()
    q.trun(clean_feed(0), GuardPolicy("rollback", snapshot_every=1))
    snap = q.tstate()
    entry = next(e for e in q.texe._cache.values() if e.guard is not None)
    real_save = entry.guard.save

    def save_unknown(state):
        real_save(state)
        entry.guard.saved = False
    entry.guard.save = save_unknown
    calls.update(n=0, fail_on={1})
    with pytest.raises(StepFault):
        q.trun(clean_feed(1), GuardPolicy("rollback", snapshot_every=1,
                                          retry=retry))
    assert q.texe.health_stats()["retries"] == 0
    bitwise(q.tstate(), snap)


# -- isfinite and the poisoned feed ------------------------------------------

def test_layers_isfinite_matches_reference():
    outs = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [3], "float32")
            n = pkg.layers.data("n", [3], "int32")
            flag = pkg.layers.isfinite([x, n])
        exe = pkg.Executor(pkg.CPUPlace())
        got = []
        for bad in (None, np.inf, -np.inf, np.nan):
            xs = np.ones((2, 3), np.float32)
            if bad is not None:
                xs[1, 2] = bad
            feed = {"x": xs, "n": np.ones((2, 3), np.int32)}
            if pkg is jfluid:
                with jfluid.scope_guard(jfluid.Scope()):
                    v, = exe.run(main, feed=feed, fetch_list=[flag])
            else:
                v, = exe.run(main, feed=feed, fetch_list=[flag],
                             scope=fluid.Scope())
            got.append((np.asarray(v).dtype == np.bool_, bool(v)))
        outs.append(got)
    assert outs[0] == outs[1] == [(True, True)] + [(True, False)] * 3


def test_poison_feed_matches_reference():
    feed = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": np.arange(4, dtype=np.int64), "c": np.ones(2, np.float32)}
    for spec in ("guard.nan=1.0", "guard.inf_grad=1.0", "guard.nan=0.5"):
        for seed in range(3):
            got = gr.poison_feed(dict(feed), FaultInjector(spec=spec,
                                                           seed=seed))
            want = jax_poison(dict(feed), JaxInjector(spec=spec, seed=seed))
            assert sorted(got) == sorted(want)
            for n in want:
                assert np.asarray(got[n]).tobytes() == \
                    np.asarray(want[n]).tobytes(), (spec, seed, n)
    assert feed["b"][0, 0] == 0.0      # the caller's arrays untouched


def test_run_pipeline_threads_guard():
    p = Pair()
    outs = p.texe.run_pipeline(p.tmain, iter([clean_feed(0), bad_feed(),
                                              clean_feed(1)]),
                               fetch_list=[p.tcost], scope=p.tscope,
                               guard=GuardPolicy("skip"))
    flags = [bool(np.isfinite(np.asarray(o[0])).all()) for o in outs]
    assert flags == [True, False, True]
    assert p.texe.health_stats()["skips"] == 1


def test_build_guarded_step_fn_takes_the_reference_parameters():
    """The reference's parameters in the reference's order; the step
    description a traced step function would be built from raises."""
    g = gr.build_guarded_step_fn(state_in=("w", "m"), state_out=("w",),
                                 check_names=("loss",))
    assert (g.gated, g.check_names) == (("w",), ("loss",))
    main = fluid.Program()
    for kw in ({"desc": main.desc}, {"block_idx": 1},
               {"feed_names": ("x",)}, {"fetch_names": ("loss",)},
               {"mode": "test"}):
        with pytest.raises(NotImplementedError):
            gr.build_guarded_step_fn(state_in=("w",), state_out=("w",),
                                     check_names=("loss",), **kw)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
def test_sentinel_multi_tensor_check_matches_isfinite(bad):
    """The guard's sentinel (multi-tensor, by dtype) agrees with
    ``all_finite`` over float32, float64, bf16, a transposed view, an
    empty tensor, an int tensor and a SeqArray, with the bad value in
    each float tensor in turn, and leaves every value's bits as they
    were (-0.0 included)."""
    import torch

    from paddle_tpu_torch.fluid.core.lod import SeqArray
    from paddle_tpu_torch.fluid.ops.misc_ops import all_finite

    def bits(t):
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])

    rng = np.random.RandomState(3)

    def values():
        vs = [torch.tensor(rng.randn(4, 5).astype(np.float32)),
              torch.tensor(rng.randn(7)),
              torch.tensor(rng.randn(3, 2).astype(np.float32)).bfloat16(),
              torch.tensor(rng.randn(5, 3).astype(np.float32)).t(),
              torch.zeros(0), torch.arange(6),
              SeqArray(torch.tensor(rng.randn(2, 3).astype(np.float32)),
                       torch.tensor([3, 1]))]
        vs[0][1, 2] = -0.0
        return vs

    targets = [0, 1, 2, 3, 6] if bad is not None else [None]
    for target in targets:
        vs = values()
        if target is not None:
            t = vs[target]
            t = t.data if isinstance(t, SeqArray) else t
            t[(0,) * t.dim()] = bad
        data = [v.data if isinstance(v, SeqArray) else v for v in vs]
        before = [bits(d) for d in data if d.dtype.is_floating_point]
        got = gr._all_finite(vs)
        assert got.dtype == torch.bool and got.dim() == 0
        assert bool(got) == bool(all_finite(vs)) == (bad is None), target
        after = [bits(d) for d in data if d.dtype.is_floating_point]
        assert all(torch.equal(b, a) for b, a in zip(before, after))
