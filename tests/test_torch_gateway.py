"""The port's serving gateway against the JAX package's, on the CPU, at
the reference tests' sizes (``tests/test_gateway.py``: V=24, 2 layers,
2 heads, d_key=4, d_model=16, src 8, 8 new tokens, page 4, chunk 4, 64
pages).

One JAX generator is seeded; the port's takes its weights through
``copy_weights``.  Each package saves its generator as a versioned
artifact and serves it from there through its own ``ModelRegistry`` and
``Gateway`` (the artifact's ``compiled/`` cache mounted).  Checked:

* ``gateway.json`` and every weight file equal the reference's byte for
  byte, and each package loads the other's artifact;
* token streams through both gateways, blocking and streamed, are equal;
* the router's admission order, bucket debits and refusals under a
  scripted clock equal the reference's;
* the registry's HBM estimates and its refusals at the same budgets
  equal the reference's, with and without a mounted cache (and under
  ``PADDLE_TPU_AOT_DISABLE``), and a generator's own estimate switches
  on its executor's cache as the reference's does;
* ``RequestJournal`` files: each package's ``pending()`` reads the
  other's, and ``recover()`` replays exactly the unfinished requests;
* the port alone: a hot swap with requests in flight loses none and adds
  no executable miss after ``_warm``; a cancelled stream frees its pages;
  the HTTP front end answers generate (blocking and chunked), models and
  its error codes; the CLI; ``serve --supervise`` re-executes the serve
  command under ``resilience.run_supervised``; a ``mesh_axes`` manifest
  (A15) raises ``NotImplementedError``.

Every HTTP call and wait takes its own timeout.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid
from paddle_tpu.serving import PagedTransformerGenerator as JaxGenerator
from paddle_tpu.serving.gateway import Gateway as JaxGateway
from paddle_tpu.serving.gateway import ModelRegistry as JaxRegistry
from paddle_tpu.serving.gateway import RequestJournal as JaxJournal
from paddle_tpu.serving.gateway import TenantConfig as JaxTenant
from paddle_tpu.serving.gateway import TenantRouter as JaxRouter
from paddle_tpu.serving.gateway import RateLimited as JaxRateLimited
from paddle_tpu.tools import gateway as jax_gateway_cli
from paddle_tpu_torch import fluid
from paddle_tpu_torch.serving import (PagedTransformerGenerator,
                                      RequestCancelled, copy_weights)
from paddle_tpu_torch.serving.gateway import (Gateway, GatewayServer,
                                              HBMBudgetError, ModelRegistry,
                                              RateLimited, RequestJournal,
                                              TenantConfig, TenantRouter)
from paddle_tpu_torch.tools import gateway as gateway_cli

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 8, 8, 4, 4
KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
          d_inner_hid=DI, max_length=64, src_len=SRC, max_out_len=OUT,
          page_size=PS, chunk_size=CHUNK, num_pages=64)
WAIT = 60.0


def _prompts(seed=0, n=4, lo=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, V, rng.randint(lo, SRC + 1)) for _ in range(n)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"jax": (root, generator), "port": (root, generator)}: one seeded
    JAX generator, the port's over its weights, each saved as ``m/1``
    and ``m/2`` (same weights, as the reference's hot-swap test) under a
    root of its own."""
    jgen = JaxGenerator(V, V, param_prefix="gwa",
                        executor=jfluid.Executor(jfluid.CPUPlace()), **KW)
    jgen.init_params(seed=3)
    pgen = PagedTransformerGenerator(V, V, param_prefix="gwa",
                                     place=fluid.CPUPlace(), **KW)
    copy_weights(jgen.scope, pgen.scope, prefix="gwa")
    out = {}
    for name, reg, gen in (("jax", JaxRegistry, jgen),
                           ("port", ModelRegistry, pgen)):
        root = str(tmp_path_factory.mktemp(f"store_{name}"))
        for version in ("1", "2"):
            reg.save_generator_artifact(gen, root, "m", version)
        out[name] = (root, gen)
    return out


def _files(d):
    return sorted(n for n in os.listdir(d)
                  if os.path.isfile(os.path.join(d, n)))


def test_generator_artifact_bytes_match_reference(stores):
    jdir = os.path.join(stores["jax"][0], "m", "1")
    pdir = os.path.join(stores["port"][0], "m", "1")
    assert _files(jdir) == _files(pdir) and "gateway.json" in _files(pdir)
    for n in _files(jdir):
        with open(os.path.join(jdir, n), "rb") as a, \
                open(os.path.join(pdir, n), "rb") as b:
            assert a.read() == b.read(), n


def test_each_registry_loads_the_others_artifact(stores):
    """The port serves the JAX package's artifact and the reverse, with
    the same greedy tokens."""
    p = _prompts(seed=5, n=1)[0]
    lens = np.array([len(p)], np.int32)
    jreg = JaxRegistry()
    jreg.load("m", "1", dirname=os.path.join(stores["port"][0], "m", "1"))
    preg = ModelRegistry(place=fluid.CPUPlace())
    preg.load("m", "1", dirname=os.path.join(stores["jax"][0], "m", "1"))
    want = jreg.instance("m").greedy(p.reshape(1, -1), lens, max_new=4,
                                     stop_at_end=False)
    got = preg.instance("m").greedy(p.reshape(1, -1), lens, max_new=4,
                                    stop_at_end=False)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))


def _serve_both(stores, tmp_path):
    """Both gateways with m/1 loaded from their artifacts (each
    registry mounts the artifact's compiled/ cache), serving."""
    jgw = JaxGateway(registry=JaxRegistry(root=stores["jax"][0]),
                     n_slots=2, max_new_tokens=OUT)
    pgw = Gateway(registry=ModelRegistry(root=stores["port"][0],
                                         place=fluid.CPUPlace()),
                  n_slots=2, max_new_tokens=OUT, check_invariants=True)
    for gw in (jgw, pgw):
        gw.load_model("m", "1")
        gw.serve()
    return jgw, pgw


def test_token_streams_match_reference_blocking_and_streamed(stores,
                                                             tmp_path):
    jgw, pgw = _serve_both(stores, tmp_path)
    try:
        prompts = _prompts(seed=1, n=4)
        for i, p in enumerate(prompts):
            if i % 2 == 0:
                want = jgw.generate("m", p, max_new=6, timeout=WAIT)
                got = pgw.generate("m", p, max_new=6, timeout=WAIT)
                assert got["tokens"] == want["tokens"], i
                assert got["version"] == want["version"] == "1"
            else:
                with jgw.submit_stream("m", p, max_new=6,
                                       timeout=WAIT) as s:
                    want = list(s)
                with pgw.submit_stream("m", p, max_new=6,
                                       timeout=WAIT) as s:
                    got = list(s)
                assert got == want and len(got) >= 1, i
        pst = pgw.registry.instance("m").exe.cache_stats()
        assert pst["persistent"]["misses"] + pst["persistent"]["hits"] >= 1
    finally:
        jgw.shutdown(timeout=WAIT)
        pgw.shutdown(timeout=WAIT)


def _router_trace(router_cls, tenant_cls, limited_cls):
    """Debits, refusals and bucket levels of a scripted submit sequence
    under a scripted clock."""
    clock = [0.0]
    router = router_cls(
        tenants=[tenant_cls("fast", slo="latency", rate=10.0, burst=20.0),
                 tenant_cls("bulk", slo="batch", weight=2.0, rate=4.0,
                            burst=8.0)],
        now_fn=lambda: clock[0])
    out = []
    for t, tenant, cost in ((0.0, "fast", 15.0), (0.0, "fast", 10.0),
                            (0.5, "fast", 10.0), (1.0, "fast", 10.0),
                            (1.0, "bulk", 8.0), (1.2, "bulk", 1.0),
                            (2.0, "bulk", 2.0), (2.0, "other", 1e9)):
        clock[0] = t
        try:
            router.check_submit(tenant, cost)
            out.append((t, tenant, "ok"))
        except limited_cls:
            out.append((t, tenant, "refused"))
    st = router.stats()["tenants"]
    levels = {n: (round(s.get("bucket_tokens", -1.0), 9)
                  if s.get("bucket_tokens") is not None else None,
                  s["rejected"], s["slo"], s["weight"])
              for n, s in st.items()}
    return out, levels


def test_router_debits_and_refusals_match_reference():
    assert _router_trace(TenantRouter, TenantConfig, RateLimited) == \
        _router_trace(JaxRouter, JaxTenant, JaxRateLimited)


class EchoModel:
    """Every lane repeats its prompt's first token (the reference test's
    slot model): admission order is the only thing that varies."""

    start_id, end_id = 0, 1
    src_len = 64

    def __init__(self):
        self.n = 0
        self.slot_val = {}

    def open_slots(self, n):
        self.n = n

    def admit_slot(self, slot, prompt):
        self.slot_val[slot] = int(np.asarray(prompt).reshape(-1)[0])
        return len(np.asarray(prompt).reshape(-1))

    def clear_slot(self, slot):
        self.slot_val.pop(slot, None)

    def step_slots(self, tokens, pos, src_len):
        return np.array([self.slot_val.get(i, 7777)
                         for i in range(self.n)], np.int64)


def _admission_order(sched_cls, router_cls, tenant_cls):
    router = router_cls(
        tenants=[tenant_cls("fast", slo="latency"),
                 tenant_cls("heavy", slo="batch", weight=2.0),
                 tenant_cls("light", slo="batch", weight=1.0)],
        reserve_latency_slots=1, now_fn=lambda: 0.0)
    sched = sched_cls(EchoModel(), n_slots=2, max_new_tokens=2,
                      admission_policy=router.admission_policy)
    router.bind(lambda: sched.n_slots, sched.queued_requests)
    reqs = [sched.submit([300 + i], tenant="heavy", max_new_tokens=2)
            for i in range(6)]
    reqs += [sched.submit([400 + i], tenant="light", max_new_tokens=2)
             for i in range(6)]
    order = []              # indices into reqs (rids are process-wide)
    steps = 0
    while sched.step_once():
        steps += 1
        if steps == 2:
            reqs.append(sched.submit([9], tenant="fast", max_new_tokens=2))
        for i, r in enumerate(reqs):
            if r.admitted is not None and i not in order:
                order.append(i)
        assert steps < 200
    return order, [r.tokens for r in reqs], router.stats()["tenants"]


def test_router_admission_order_matches_reference():
    from paddle_tpu.serving import ContinuousBatchingScheduler as JaxSched
    from paddle_tpu_torch.serving import ContinuousBatchingScheduler

    got = _admission_order(ContinuousBatchingScheduler, TenantRouter,
                           TenantConfig)
    want = _admission_order(JaxSched, JaxRouter, JaxTenant)
    assert got[0] == want[0] and got[1] == want[1]
    for t in ("fast", "heavy", "light"):
        assert got[2][t]["admitted"] == want[2][t]["admitted"]


def _config(stores, pkg):
    with open(os.path.join(stores[pkg][0], "m", "1", "gateway.json")) as f:
        return json.load(f)["config"]


@pytest.mark.parametrize("mounted", [True, False])
def test_hbm_estimates_and_refusals_match_reference(stores, mounted,
                                                    monkeypatch):
    """The registry's static estimate (mounted: an artifact load, priced
    without donation; else with it) equals the reference's, component
    by component; a budget one byte under it refuses with 0 bytes used,
    at it admits, in both packages."""
    cfg = _config(stores, "port")
    assert cfg == _config(stores, "jax")
    if not mounted:
        monkeypatch.setenv("PADDLE_TPU_AOT_DISABLE", "1")
    dirs = {p: os.path.join(stores[p][0], "m", "1") for p in stores}
    est = {}
    for pkg, reg in (("jax", JaxRegistry), ("port", ModelRegistry)):
        est[pkg] = reg._estimate_cost_detail("generator", dirs[pkg], cfg)
    assert est["port"] == est["jax"]
    cost = est["port"][0]
    for pkg, reg_cls in (("jax", JaxRegistry), ("port", ModelRegistry)):
        kw = {} if pkg == "jax" else {"place": fluid.CPUPlace()}
        reg = reg_cls(root=stores[pkg][0], hbm_budget_bytes=cost - 1, **kw)
        with pytest.raises(Exception) as e:
            reg.load("m", "1")
        assert type(e.value).__name__ == "HBMBudgetError"
        assert reg.hbm_used() == 0 and reg.entries() == []
    # at the estimate: the reference's charge passes (its load would
    # build a JAX generator), the port's load is admitted
    JaxRegistry(hbm_budget_bytes=cost)._charge(cost, "m@1")
    reg = ModelRegistry(root=stores["port"][0], hbm_budget_bytes=cost,
                        place=fluid.CPUPlace())
    with pytest.raises(HBMBudgetError):
        ModelRegistry(hbm_budget_bytes=cost - 1)._charge(cost, "m@1")
    assert reg.load("m", "1") == "m@1" and reg.hbm_used() == cost


def test_mounted_estimate_exceeds_unmounted_by_the_pool(stores,
                                                        monkeypatch):
    """A generator whose executor mounts a cache is priced without
    donation, as the reference's: the estimate grows by at least the
    pool's bytes, and both packages' generators price alike."""
    cfg = _config(stores, "port")
    d = os.path.join(stores["port"][0], "m", "1")
    mounted, _ = ModelRegistry._estimate_cost_detail("generator", d, cfg)
    bare, _ = ModelRegistry._estimate_cost_detail("generator", None, cfg)
    gen = stores["port"][1]
    assert mounted - bare >= gen.page_bytes * gen.num_pages
    reg = ModelRegistry(root=stores["port"][0], place=fluid.CPUPlace())
    inst = reg.instance(reg.load("m", "2"))
    assert inst.exe._aot_cache() is not None
    assert inst.static_hbm_estimate().peak_bytes == mounted
    jreg = JaxRegistry(root=stores["jax"][0])
    jinst = jreg.instance(jreg.load("m", "2"))
    assert jinst.static_hbm_estimate().peak_bytes == mounted
    assert gen.static_hbm_estimate().peak_bytes == bare


def test_mesh_manifest_is_refused_naming_a15(stores, tmp_path):
    reg = ModelRegistry(root=stores["port"][0], place=fluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="A15"):
        reg.load("m", "1", mesh_axes={"model": 2})
    assert reg.entries() == [] and reg.hbm_used() == 0


def test_journals_cross_read_between_packages(tmp_path):
    """A journal either package writes is the other's ``pending()``:
    submits, done records, decode options, tags and sessions."""
    for writer, reader in ((JaxJournal, RequestJournal),
                           (RequestJournal, JaxJournal)):
        path = str(tmp_path / f"{writer.__module__}.journal")
        w = writer(path, fsync=True)
        for i in range(4):
            w.record_submit(f"j{i}", "acme", "m", [2 + i, 3], 4,
                            decode={"draft": False} if i == 1 else None,
                            tag="t1" if i == 2 else None,
                            session="s" if i == 3 else None)
        w.record_done("j0", ok=True)
        w.record_done("j2", ok=False, error="Boom")
        w.flush()
        want = w.pending()
        got = reader(path).pending()
        strip = [{k: v for k, v in e.items() if k != "ts"} for e in want]
        assert [{k: v for k, v in e.items() if k != "ts"}
                for e in got] == strip
        assert [e["jid"] for e in got] == ["j1", "j3"]


def test_journal_recover_replays_the_unfinished(stores, direct, tmp_path):
    """A journaled gateway shut down without draining after 2 of 6
    requests finish: a new gateway on the same journal replays exactly
    the 4 unfinished ones, once each, with the tokens a direct run
    gives."""
    path = str(tmp_path / "gw.journal")
    root = stores["port"][0]
    prompts = _prompts(seed=3, n=6)
    gw1 = Gateway(registry=ModelRegistry(root=root, place=fluid.CPUPlace()),
                  n_slots=2, max_new_tokens=OUT, journal_path=path)
    gw1.load_model("m", "1")
    first = [gw1.submit("m", p, max_new=4) for p in prompts[:2]]
    gw1.run_until_idle()
    assert all(r.error is None for r in first)
    for p in prompts[2:]:
        gw1.submit("m", p, max_new=4)
    gw1.shutdown(drain=False, timeout=WAIT)
    assert len(gw1.journal.pending()) == 4
    gw2 = Gateway(registry=ModelRegistry(root=root, place=fluid.CPUPlace()),
                  n_slots=2, max_new_tokens=OUT, journal_path=path)
    gw2.load_model("m", "1")
    recovered = gw2.recover()
    assert [list(r.src) for r in recovered] == \
        [list(p) for p in prompts[2:]]
    gw2.run_until_idle()
    for r, p in zip(recovered, prompts[2:]):
        assert r.error is None
        assert r.tokens == _direct(direct, p, 4)
    assert gw2.journal.pending() == []


def _direct(gen, p, max_new):
    """Greedy tokens of ``p`` as the scheduler retires them (at the first
    end id).  ``gen`` is an instance no gateway serves: ``greedy``
    reopens its lanes."""
    p = np.asarray(p)
    toks = [int(t) for t in gen.greedy(p.reshape(1, -1),
                                       np.array([len(p)], np.int32),
                                       max_new=max_new,
                                       stop_at_end=False)[0]]
    return toks[:toks.index(1) + 1] if 1 in toks else toks


@pytest.fixture(scope="module")
def direct(stores):
    """The port's m/1 loaded on its own, for golden tokens."""
    reg = ModelRegistry(root=stores["port"][0], place=fluid.CPUPlace())
    return reg.instance(reg.load("m", "1"))


def test_hot_swap_loses_nothing_and_adds_no_miss(stores, direct):
    root = stores["port"][0]
    prompts = _prompts(seed=2, n=6)
    golden = [_direct(direct, p, 4) for p in prompts]
    gw = Gateway(registry=ModelRegistry(root=root, place=fluid.CPUPlace()),
                 n_slots=2, max_new_tokens=OUT, check_invariants=True)
    gw.load_model("m", "1")
    gw.serve()
    try:
        reqs = [gw.submit("m", p, max_new=4) for p in prompts[:4]]
        gw.swap_model("m", "2")
        v2 = gw.registry.instance("m@2")
        miss0 = v2.exe.cache_stats()["executable"]["misses"]
        reqs += [gw.submit("m", p, max_new=4) for p in prompts[4:]]
        for r in reqs:
            assert r.wait(WAIT), "request lost across the hot swap"
            assert r.error is None
        assert [r.tokens for r in reqs] == golden
        assert v2.exe.cache_stats()["executable"]["misses"] == miss0
    finally:
        gw.shutdown(drain=True, timeout=WAIT)
    assert [e["key"] for e in gw.registry.entries()] == ["m@2"]
    assert all(r.group == "m@2" for r in reqs[4:])


def test_cancelled_stream_frees_its_pages(stores):
    gw = Gateway(registry=ModelRegistry(root=stores["port"][0],
                                        place=fluid.CPUPlace()),
                 n_slots=2, max_new_tokens=OUT, check_invariants=True)
    gw.load_model("m", "1")
    gen = gw.registry.instance("m")
    gw.serve()
    try:
        s = gw.submit_stream("m", _prompts(seed=4, n=1)[0], max_new=OUT,
                             timeout=WAIT)
        next(s)
        s.close()
        assert s.request.wait(WAIT)
        assert isinstance(s.request.error, RequestCancelled)
    finally:
        gw.shutdown(drain=True, timeout=WAIT)
    gen.alloc.check_invariants()
    assert gen.alloc.in_use() == 0


def _post(addr, route, body):
    req = urllib.request.Request(
        f"http://{addr}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=WAIT)


def test_http_front_end_and_cli(stores, direct, capsys):
    router = TenantRouter(tenants=[
        TenantConfig("limited", slo="batch", rate=0.001, burst=6.0)])
    gw = Gateway(registry=ModelRegistry(root=stores["port"][0],
                                        place=fluid.CPUPlace()),
                 router=router, n_slots=2, max_new_tokens=OUT)
    gw.load_model("m", "1")
    srv = GatewayServer(gw)
    addr = srv.start()
    try:
        p = [int(t) for t in _prompts(seed=6, n=1)[0]]
        blocking = json.loads(_post(addr, "/v1/generate",
                                    {"model": "m", "prompt": p,
                                     "max_new": 4}).read())
        assert blocking["tokens"] == _direct(direct, p, 4)
        lines = [json.loads(ln) for ln in _post(
            addr, "/v1/generate", {"model": "m", "prompt": p,
                                   "max_new": 4, "stream": True}
        ).read().decode().splitlines()]
        assert [ln["token"] for ln in lines if "token" in ln] == \
            blocking["tokens"]
        assert lines[-1]["done"]
        got = json.loads(urllib.request.urlopen(
            f"http://{addr}/v1/models", timeout=WAIT).read())
        assert got["aliases"] == {"m": "1"}
        for body, code in (({"model": "nope", "prompt": [2]}, 404),
                           ({"model": "m", "prompt": []}, 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(addr, "/v1/generate", body)
            assert e.value.code == code
        _post(addr, "/v1/generate", {"model": "m", "prompt": p[:2],
                                     "max_new": 2,
                                     "tenant": "limited"}).read()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(addr, "/v1/generate", {"model": "m", "prompt": p,
                                         "max_new": OUT,
                                         "tenant": "limited"})
        assert e.value.code == 429
        capsys.readouterr()
        assert gateway_cli.main(["models", addr]) == 0
        assert json.loads(capsys.readouterr().out)["aliases"] == {"m": "1"}
        assert gateway_cli.main(["generate", addr, "m", "--prompt",
                                 " ".join(map(str, p)), "--max-new",
                                 "4"]) == 0
        assert json.loads(capsys.readouterr().out)["tokens"] == \
            blocking["tokens"]
    finally:
        srv.stop()
    assert gateway_cli.main(["status", "127.0.0.1:1",
                             "--timeout", "5"]) == 2


def test_serve_supervise_is_refused_naming_a13(tmp_path):
    argv = ["serve", "--root", str(tmp_path), "--model", "m=1",
            "--supervise", "2", "--exit-on-wedge", "30"]
    assert gateway_cli._strip_supervise(argv) == \
        jax_gateway_cli._strip_supervise(argv)
    assert gateway_cli._strip_supervise(["serve", "--supervise=3"]) == \
        ["serve"]
    # the supervised service is ported: serve --supervise re-executes
    # this serve command, less --supervise, under run_supervised
    import paddle_tpu_torch.resilience as resilience

    calls = []

    def fake_run_supervised(child, max_restarts, log_dir):
        calls.append((child, max_restarts, log_dir))
        return 0

    monkeypatch = pytest.MonkeyPatch()
    try:
        monkeypatch.setattr(resilience, "run_supervised",
                            fake_run_supervised)
        assert gateway_cli.main(argv + ["--log-dir",
                                        str(tmp_path / "logs")]) == 0
    finally:
        monkeypatch.undo()
    assert calls == [(["-m", "paddle_tpu_torch.tools.gateway"]
                      + gateway_cli._strip_supervise(argv)
                      + ["--log-dir", str(tmp_path / "logs")], 2,
                      str(tmp_path / "logs"))]
