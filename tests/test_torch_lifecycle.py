"""The port's release lifecycle (``lifecycle/`` and
``tools/lifecycle.py``) against the JAX package, on the CPU.

Each scenario runs once through each package — a ``Gateway`` and a
``ReleaseController`` of its own, the same deterministic slot models
(the reference tests' ``Echo`` family: an ``Echo`` lane repeats its
prompt's first token, so a probe's quality is checkable), the same
submissions — and the two journals hold the same event sequence, with
the same versions, reasons and routing:

* promote after the offline gate, reject on the gate, a canary that
  promotes, rollbacks on the quality probes, on the error rate and on
  the windowed p95, a controller restarted mid-canary that re-arms with
  the journaled fraction and seed, and operator directives through the
  lifecycle CLI;
* ``CanarySlice``'s routing of a seeded slice, and ``fold_state`` of one
  journal, equal the reference's;
* ``CandidatePublisher`` and ``GeneratorPublisher`` artifacts (a
  trained fc net, a 2-layer paged generator) are the reference's
  bytes, and the trainer publishes every N steps and at its end.
"""

import os
import time

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu import lifecycle as jlc
from paddle_tpu.resilience import FaultInjector as JaxInjector
from paddle_tpu.resilience import install as jax_install
from paddle_tpu.serving import ContinuousBatchingScheduler as JaxSched
from paddle_tpu.serving import PagedTransformerGenerator as JaxGenerator
from paddle_tpu.serving.gateway import Gateway as JaxGateway
from paddle_tpu.tools import lifecycle as jax_cli
from paddle_tpu_torch import fluid
from paddle_tpu_torch import lifecycle as tlc
from paddle_tpu_torch.parallel import TaskQueue
from paddle_tpu_torch.resilience import FaultInjector, ResilientTrainer
from paddle_tpu_torch.resilience import install
from paddle_tpu_torch.serving import (ContinuousBatchingScheduler,
                                      PagedTransformerGenerator,
                                      copy_weights)
from paddle_tpu_torch.serving.gateway import Gateway, ModelRegistry
from paddle_tpu_torch.tools import lifecycle as cli

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _inert_injectors():
    prev, jprev = install(FaultInjector()), jax_install(JaxInjector())
    yield
    install(prev)
    jax_install(jprev)


class Echo:
    """Deterministic slot model: every lane repeats its prompt's first
    token (or a constant)."""

    start_id, end_id = 0, 1
    src_len = 64

    def __init__(self, const=None, eval_score=1.0):
        self.n = 0
        self.slot_val = {}
        self.const = const
        self.eval_score = eval_score

    def open_slots(self, n):
        self.n = n

    def admit_slot(self, slot, prompt, **_):
        v = int(np.asarray(prompt).reshape(-1)[0])
        self.slot_val[slot] = v if self.const is None else self.const
        return len(np.asarray(prompt).reshape(-1))

    def clear_slot(self, slot):
        self.slot_val.pop(slot, None)

    def step_slots(self, tokens, pos, src_len):
        return np.array([self.slot_val.get(i, 7777)
                         for i in range(self.n)], np.int64)


class Crashy(Echo):
    def step_slots(self, tokens, pos, src_len):
        raise RuntimeError("degraded candidate: dispatch fault")


class Slow(Echo):
    def __init__(self, delay=0.05, **kw):
        super().__init__(**kw)
        self.delay = delay

    def step_slots(self, tokens, pos, src_len):
        time.sleep(self.delay)
        return super().step_slots(tokens, pos, src_len)


def quality(prompt, tokens):
    return 1.0 if tokens and tokens[0] == int(prompt[0]) else 0.0


PKGS = {"jax": (jlc, JaxGateway, jax_cli),
        "port": (tlc, Gateway, cli)}


def gateway(pkg):
    if pkg == "jax":
        return JaxGateway(n_slots=2, max_new_tokens=4)
    return Gateway(registry=ModelRegistry(place=CPU), n_slots=2,
                   max_new_tokens=4)


def controller(pkg, tmp, gw, **over):
    lc = PKGS[pkg][0]
    cfg_kw = dict(n_slots=2, canary_fraction=0.5, canary_requests=4,
                  probe_prompts=[[5], [6], [7]], p95_floor_s=0.5, seed=3)
    cfg_kw.update(over.pop("cfg", {}))
    kw = dict(journal_path=os.path.join(tmp, "rc.journal"),
              eval_fn=lambda inst: getattr(inst, "eval_score", 1.0),
              quality_fn=quality)
    kw.update(over)
    return lc.ReleaseController(gw, lc.ReleaseConfig("m", **cfg_kw), **kw)


def drive(rc, gw, rounds=20, per_round=4, base=20):
    """Traffic until the canary's verdict -> (verdict, every request)."""
    reqs = []
    for i in range(rounds):
        reqs += [gw.submit("m", [base + i * per_round + k], max_new=4)
                 for k in range(per_round)]
        gw.run_until_idle()
        out = rc.step()
        if out != "canary":
            return out, reqs
    raise AssertionError("no verdict reached")


KEEP = ("event", "version", "reason", "to", "from", "canary", "fraction",
        "seed", "score", "action", "ok", "operator")


def journal(pkg, path):
    """The journal's entries, the fields both packages write alike
    (times and sequence numbers dropped)."""
    lc = PKGS[pkg][0]
    out = []
    for e in lc.ReleaseJournal(path).replay():
        rec = {k: e[k] for k in KEEP if k in e}
        if e.get("event") == "rollback" and "detail" in e:
            rec["detail"] = sorted(e["detail"])
        out.append(rec)
    return out


def scenario(pkg, tmp, kind):
    """One scripted pipeline -> (its journal, a summary)."""
    os.makedirs(tmp, exist_ok=True)
    gw = gateway(pkg)
    summary = {}
    if kind == "gate":
        rc = controller(pkg, tmp, gw, root=None)
        rc.offer("1", Echo(eval_score=0.9))
        summary["first"] = rc.step()
        rc.offer("2", Echo(eval_score=0.5))
        summary["second"] = rc.step()
        rc.offer("2", Echo(eval_score=0.95))
        summary["again"] = rc.step()
        summary["models"] = gw.sched.models()
    elif kind in ("promote", "quality", "error_rate", "p95"):
        over = {}
        cand = {"promote": Echo(), "quality": Echo(const=9999),
                "error_rate": Crashy(), "p95": Slow(0.05)}[kind]
        if kind == "p95":
            over = dict(cfg=dict(canary_fraction=1.0, canary_requests=2,
                                 p95_floor_s=0.05, probe_prompts=[]))
        rc = controller(pkg, tmp, gw, **over)
        rc.offer("1", Echo())
        rc.step()
        rc.offer("2", cand)
        summary["armed"] = rc.step()
        summary["canary"] = rc.status()["canary"]["fraction"]
        verdict, reqs = drive(rc, gw, per_round=2 if kind == "p95" else 4)
        summary["verdict"] = verdict
        summary["resolve"] = gw.registry.resolve("m")
        summary["lost"] = sum(r.error is not None for r in reqs
                              if r.group != "m@2")
        summary["groups"] = [r.group for r in reqs]
        summary["models"] = gw.sched.models()
        summary["bad"] = sorted(rc.state.bad)
    elif kind == "resume":
        rc1 = controller(pkg, tmp, gw)
        rc1.offer("1", Echo())
        rc1.step()
        rc1.offer("2", Echo())
        summary["armed"] = rc1.step()
        del rc1, gw                          # "crash" mid-canary
        gw = gateway(pkg)
        loader = {"1": Echo(), "2": Echo()}
        rc2 = controller(pkg, tmp, gw, loader=lambda v: loader[v])
        summary["journal_canary"] = dict(rc2.state.canary)
        summary["resume"] = rc2.resume()
        summary["rearmed"] = (rc2._canary.fraction, rc2._canary.seed)
        summary["resolve_before"] = gw.registry.resolve("m")
        summary["verdict"] = drive(rc2, gw)[0]
    elif kind == "directives":
        tool = PKGS[pkg][2]
        root = os.path.join(tmp, "store")
        for v in ("1", "2"):
            os.makedirs(os.path.join(root, "m", v))
        jpath = os.path.join(tmp, "rc.journal")
        loader = {"1": Echo(), "2": Echo(const=222)}
        rc = controller(pkg, tmp, gw, root=root, loader=lambda v: loader[v])
        rc.offer("1", loader["1"])
        steps = [rc.step()]
        args = ["--journal", jpath, "--model", "m", "--root", root]
        codes = [tool.main(["promote", "2"] + args)]
        steps.append(rc.step())
        codes.append(tool.main(["rollback", "1"] + args))
        loader["1"] = Echo()
        steps.append(rc.step())
        codes.append(tool.main(["promote", "9"] + args))
        codes.append(tool.main(["status"] + args))
        summary.update(steps=steps, codes=codes,
                       resolve=gw.registry.resolve("m"),
                       last_good=rc.state.last_good)
        io = jfluid.io if pkg == "jax" else fluid.io
        summary["current"] = io.current_model_version(root, "m")
    return journal(pkg, os.path.join(tmp, "rc.journal")), summary


@pytest.mark.parametrize("kind", ["gate", "promote", "quality",
                                  "error_rate", "p95", "resume",
                                  "directives"])
def test_controller_journal_matches_reference(kind, tmp_path, capsys):
    got = scenario("port", str(tmp_path / "port"), kind)
    want = scenario("jax", str(tmp_path / "jax"), kind)
    capsys.readouterr()
    assert got[0] == want[0]
    assert got[1] == want[1]
    events = [e["event"] for e in got[0]]
    expect = {
        "gate": ["candidate", "promoted", "candidate", "rejected"],
        "promote": ["candidate", "promoted", "candidate", "canary-start",
                    "promoted"],
        "quality": ["candidate", "promoted", "candidate", "canary-start",
                    "rollback"],
        "resume": ["candidate", "promoted", "candidate", "canary-start",
                   "resume", "promoted"],
        "directives": ["candidate", "promoted", "directive", "promoted",
                       "directive-done", "directive", "rollback",
                       "directive-done"]}
    if kind in expect:
        assert events == expect[kind]
    if kind in ("quality", "error_rate", "p95"):
        rb = [e for e in got[0] if e["event"] == "rollback"]
        assert rb and rb[0]["reason"] == kind
        assert got[1]["resolve"] == "m@1" and got[1]["lost"] == 0
    if kind == "resume":
        assert got[1]["rearmed"] == (0.5, 3)
        assert got[1]["resolve_before"] == "m@1"


def test_canary_slice_routes_the_references_slice():
    groups = {}
    for name, sched_cls, lc in (("port", ContinuousBatchingScheduler, tlc),
                                ("jax", JaxSched, jlc)):
        sched = sched_cls(max_new_tokens=4)
        sched.add_model("m@1", Echo(), 2)
        sched.add_model("m@2", Echo(const=555), 2)
        sched.resolve = lambda alias: "m@1" if alias == "m" else alias
        slc = lc.CanarySlice("m", "m@1", "m@2", 0.25, seed=9)
        sched.admission_policy = slc.admission_policy
        pinned = sched.submit([50], max_new_tokens=2, model="m@1")
        reqs = [sched.submit([40 + i], max_new_tokens=2, model="m")
                for i in range(16)]
        sched.run_until_idle()
        groups[name] = ([r.group for r in reqs], [r.tokens for r in reqs],
                        pinned.group, slc.stats())
    assert groups["port"] == groups["jax"]
    want = ["m@2" if FaultInjector.decision(9, "canary.m", i) < 0.25
            else "m@1" for i in range(16)]
    assert groups["port"][0] == want and "m@2" in want
    with pytest.raises(ValueError):
        tlc.CanarySlice("m", "a", "b", 1.5)


def test_fold_state_matches_reference(tmp_path):
    states = []
    for name, lc in (("port", tlc), ("jax", jlc)):
        path = str(tmp_path / f"{name}.journal")
        j = lc.ReleaseJournal(path)
        j.append("init", model="m", last_good="0")
        j.append("candidate", version="1")
        j.append("promoted", version="1", score=0.9)
        j.append("candidate", version="2")
        j.append("canary-start", version="2", fraction=0.25, seed=7,
                 score=0.91)
        j.append("directive", action="rollback", version=None)
        j.append("candidate", version="3")
        j.append("rejected", version="3", reason="eval_below_min")
        with open(path, "a") as f:
            f.write('{"event":"promoted","version":"2"')   # torn tail
        st = lc.ReleaseJournal(path).state()
        d = st.to_dict()
        for x in d["pending_directives"]:
            x.pop("t", None)
        states.append(d)
        # each package folds the other's journal alike
        other = str(tmp_path / (("jax" if name == "port" else "port")
                                + ".journal"))
        if os.path.exists(other):
            assert lc.fold_state(lc.ReleaseJournal(other).replay()) \
                .to_dict()["canary"] == d["canary"]
    assert states[0] == states[1]
    assert states[0]["canary"] == {"version": "2", "fraction": 0.25,
                                   "seed": 7, "score": 0.91}
    assert states[0]["bad"] == ["3"] and states[0]["last_good"] == "1"


def _mlp(pkg, seed=0):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        y = pkg.layers.fc(input=h, size=4)
    return main, startup, y


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, n))}


def test_published_artifacts_are_the_references_bytes(tmp_path):
    # an engine artifact of one fc net's weights from both packages
    jmain, jstart, jy = _mlp(jfluid)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()
             if v is not None}
    tmain, _, ty = _mlp(fluid)
    tscope = fluid.scope_from_numpy(state, CPU)
    roots = {k: str(tmp_path / k) for k in ("port", "jax")}
    tlc.CandidatePublisher(roots["port"], "m", ["x"], [ty],
                           fluid.Executor(CPU), main_program=tmain,
                           scope=tscope, int8=True).publish(4)
    jlc.CandidatePublisher(roots["jax"], "m", ["x"], [jy], jexe,
                           main_program=jmain, scope=jscope,
                           int8=True).publish(4)
    a, b = (_files(os.path.join(roots[k], "m", "4")) for k in roots)
    assert a == b and "gateway.json" in a and "__model__" in a

    # a paged-generator artifact of one set of weights
    cfg = dict(src_vocab_size=24, trg_vocab_size=24, n_layer=2, n_head=2,
               d_key=4, d_value=4, d_model=16, d_inner_hid=32,
               max_length=64, src_len=8, max_out_len=8, page_size=4,
               chunk_size=4, num_pages=64, param_prefix="gwa")
    jgen = JaxGenerator(executor=jfluid.Executor(jfluid.CPUPlace()), **cfg)
    jgen.init_params(seed=3)
    pgen = PagedTransformerGenerator(place=CPU, **cfg)
    copy_weights(jgen.scope, pgen.scope, prefix="gwa")
    src, jsrc = pgen.scope, jgen.scope
    groots = {k: str(tmp_path / f"g{k}") for k in ("port", "jax")}
    assert tlc.GeneratorPublisher(groots["port"], "tb", cfg, place=CPU) \
        .publish(7, scope=src) == "7"
    assert jlc.GeneratorPublisher(groots["jax"], "tb", cfg) \
        .publish(7, scope=jsrc) == "7"
    a, b = (_files(os.path.join(groots[k], "tb", "7")) for k in groots)
    assert a == b and "gateway.json" in a
    with pytest.raises(ValueError):
        tlc.GeneratorPublisher(str(tmp_path / "x"), "tb", cfg,
                               place=CPU).publish(1)


def test_trainer_publishes_every_n_steps_and_at_the_end(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        yv = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, yv))
        fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    exe, scope = fluid.Executor(CPU), fluid.Scope()
    root = str(tmp_path / "store")
    pub = tlc.CandidatePublisher(root, "mlp", ["x"], [pred], exe,
                                 main_program=main, scope=scope)
    queue = TaskQueue(timeout_secs=5.0, failure_max=3)
    queue.set_dataset([0, 1, 2])

    def read_chunk(seed):
        r = np.random.RandomState(seed)
        return [(r.randn(4, 4).astype(np.float32),
                 r.randn(4, 1).astype(np.float32)) for _ in range(3)]

    trainer = ResilientTrainer(str(tmp_path / "ckpt"), queue, read_chunk,
                               program=main, scope=scope,
                               save_interval_steps=3, publisher=pub,
                               publish_every_steps=4)
    final = trainer.run(
        lambda rec, step: exe.run(main, feed={"x": rec[0], "y": rec[1]},
                                  fetch_list=[loss], scope=scope),
        init_fn=lambda: exe.run(startup, scope=scope))
    assert final == 9
    assert fluid.io.list_model_versions(root, "mlp") == ["4", "8", "9"]
    assert trainer.status()["last_published_version"] == "9"
    reg = ModelRegistry(root=root, place=CPU)
    reg.load("mlp", "9")
    out, = reg.instance("mlp@9").infer({"x": np.ones((2, 4), np.float32)})
    assert np.asarray(out).shape == (2, 1)
