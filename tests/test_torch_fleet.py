"""The serving fleet against the JAX package's.

* ``affinity_key`` and ``chunk_hashes`` bit for bit the reference's on
  seeded tokens.
* ``FleetRouter``'s decisions and migration records against the
  reference's router, each over in-process gateway replicas of its own
  package serving the reference tests' ``EchoModel`` (every lane repeats
  its prompt's first token): affinity and its fallback, least-loaded and
  seeded-random placement, the seeded health backoff of a killed
  replica, and the settlement of a dead or drained replica's journal
  tail (delivered / claimed / replayed / failed, and the tail left
  pending while every target drains), record for record.
* The reference's in-process scenarios on the port alone: failover on a
  torn response, a replica killed with requests in flight and a drain
  with a queued tail (every request answered exactly once, every jid one
  done record), the HTTP front door, the CLI, and affinity against
  random routing on real paged generators (CPU).
* ``slow``, as the reference marks its own: two supervised ``gateway
  serve --cpu`` replica processes under ``FleetSupervisor``, one
  SIGKILLed with requests in flight and the other drained; the
  in-process kill and drain above are its tier-1 counterparts.
"""

import hashlib
import itertools
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import gateway as jgateway
from paddle_tpu.serving import paging as jpaging
from paddle_tpu_torch import fluid
from paddle_tpu_torch.serving import PagedTransformerGenerator
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving import gateway
from paddle_tpu_torch.serving import paging
from paddle_tpu_torch.serving.fleet import (FleetRouter, FleetRouterServer,
                                            FleetSupervisor, ReplicaSpec)
from paddle_tpu_torch.serving.gateway import (Gateway, GatewayServer,
                                              ModelRegistry, RequestJournal)

V, NL, NH, DK, DM, DI = 24, 2, 2, 4, 16, 32
SRC, OUT, PS, CHUNK = 8, 8, 4, 4
GEN_KW = dict(n_layer=NL, n_head=NH, d_key=DK, d_value=DK, d_model=DM,
              d_inner_hid=DI, max_length=64, src_len=SRC,
              max_out_len=OUT, page_size=PS, chunk_size=CHUNK,
              num_pages=64)
PORT = {"fleet": fleet, "gateway": gateway}
REF = {"fleet": jfleet, "gateway": jgateway}
# a child process's wall limit (its replicas import torch and load a
# model on the CPU)
CHILD_WAIT = 240.0


class EchoModel:
    """Deterministic slot model: every lane repeats its prompt's first
    token — a migrated response contaminated by another request's lane
    is immediately visible."""

    start_id, end_id = 0, 1
    src_len = 64

    def __init__(self, delay=0.0):
        self.n = 0
        self.delay = delay
        self.slot_val = {}

    def open_slots(self, n):
        self.n = n

    def admit_slot(self, slot, prompt):
        self.slot_val[slot] = int(np.asarray(prompt).reshape(-1)[0])
        return len(np.asarray(prompt).reshape(-1))

    def clear_slot(self, slot):
        self.slot_val.pop(slot, None)

    def step_slots(self, tokens, pos, src_len):
        if self.delay:
            time.sleep(self.delay)
        return np.array([self.slot_val.get(i, 7777)
                         for i in range(self.n)], np.int64)


def _mk_replica(pkg, tmp, name, delay=0.0, slots=2, max_new=4):
    """One in-process gateway replica of ``pkg`` whose accepted
    connections are tracked, so ``_hard_kill`` can reset them the way a
    real SIGKILL does at the TCP level."""
    gw_mod = pkg["gateway"]
    jp = os.path.join(str(tmp), f"{name}.journal")
    gw = gw_mod.Gateway(n_slots=slots, max_new_tokens=max_new,
                        journal_path=jp)
    gw.load_model("m", "1", instance=EchoModel(delay))
    srv = gw_mod.GatewayServer(gw, port=0)
    conns = []
    base = srv._httpd.RequestHandlerClass

    class Tracked(base):
        def setup(self):
            conns.append(self.request)
            base.setup(self)

    srv._httpd.RequestHandlerClass = Tracked
    srv.start()
    spec = pkg["fleet"].ReplicaSpec(name, srv.address, journal_path=jp)
    return gw, srv, spec, conns


def _hard_kill(gw, srv, conns):
    """In-process SIGKILL: the scheduler dies mid-flight (no further
    done records), the listener closes, established sockets reset."""
    srv._httpd.shutdown()
    srv._httpd.server_close()
    gw.sched.shutdown(drain=False)
    for c in list(conns):
        for fn in (lambda: c.shutdown(socket.SHUT_RDWR), c.close):
            try:
                fn()
            except OSError:
                pass


def _fleet(pkg, tmp, n=2, delay=0.0, slots=2, **kw):
    reps = [_mk_replica(pkg, tmp, f"r{i}", delay=delay, slots=slots)
            for i in range(n)]
    kw.setdefault("page_size", PS)
    kw.setdefault("probe_interval", 0.05)
    kw.setdefault("settle_timeout", 5.0)
    kw.setdefault("seed", 0)
    router = pkg["fleet"].FleetRouter([spec for _, _, spec, _ in reps],
                                      **kw)
    return reps, router


def _teardown(reps, router):
    router.stop()
    for gw, srv, _, _ in reps:
        try:
            srv.stop(drain=False)
        except Exception:
            pass


def _journal_lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _dones(path):
    """{jid: [(ok, error), ...]} of a journal's done records."""
    out = {}
    for ln in _journal_lines(path):
        if ln["op"] == "done":
            out.setdefault(ln["jid"], []).append((ln.get("ok"),
                                                  ln.get("error")))
    return out


def _get(addr, route, timeout=10):
    with urllib.request.urlopen(f"http://{addr}{route}",
                                timeout=timeout) as r:
        return json.loads(r.read().decode())


def _post(addr, route, body, timeout=60):
    req = urllib.request.Request(
        f"http://{addr}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _stats(router):
    """``router.stats()`` less the per-run addresses and paths."""
    st = router.stats()
    for r in st["replicas"]:
        r.pop("address"), r.pop("journal")
    return st


# -- the affinity key --------------------------------------------------------

@pytest.mark.parametrize("seed,page", [(0, 4), (1, 8), (2, 16), (3, 1)])
def test_affinity_key_and_chunk_hashes_are_the_references(seed, page):
    rng = np.random.RandomState(seed)
    for n in (0, page - 1, page, 2 * page + 3, 5 * page):
        toks = rng.randint(0, 32768, n)
        assert paging.chunk_hashes(toks, page) == \
            jpaging.chunk_hashes(toks, page)
        for depth in (0, 1, 2, 3, 99):
            got = paging.affinity_key(list(toks), page, depth)
            assert got == jpaging.affinity_key(list(toks), page, depth)
            if n < page:
                assert got is None
    prompt = list(range(2, 2 + 3 * page))
    assert paging.affinity_key(prompt, page, 2) == \
        paging.chunk_hashes(np.array(prompt[:2 * page]), page)[-1]


# -- routing decisions through both packages ---------------------------------

def _decisions(pkg, tmp):
    """One scripted sequence of routing calls -> the decision log."""
    log = []
    reps, router = _fleet(pkg, tmp / "aff", n=3)
    try:
        router.start()
        rng = np.random.RandomState(7)
        for _ in range(12):
            head = [int(t) for t in rng.randint(2, 90, PS)]
            tail = [int(t) for t in rng.randint(2, 90, rng.randint(0, 9))]
            prompt = (head * int(rng.randint(1, 3)) + tail)
            log.append(("affinity", prompt[:3],
                        router.generate("m", prompt, max_new=2)["replica"]))
        for p in ([3, 4], [5], [6, 7, 8]):
            log.append(("short", p, router.generate("m", p,
                                                    max_new=2)["replica"]))
        owner = router.generate("m", [5] * PS, max_new=2)["replica"]
        for bystander in ("r0", "r1", "r2"):
            out = router.proxy({"model": "m", "prompt": [5] * PS,
                                "max_new": 2}, exclude=(bystander,))
            log.append(("exclude", bystander, owner, out["replica"]))
        log.append(("stats", _stats(router)))
    finally:
        _teardown(reps, router)
    reps, router = _fleet(pkg, tmp / "ll", n=3, routing="least_loaded")
    try:
        router.health_check_once()
        held = [router._route([3] * PS, ()) for _ in range(5)]
        log.append(("least_loaded", [r.spec.name for r in held]))
        with router._lock:
            for r in held:
                r.in_flight -= 1
    finally:
        _teardown(reps, router)
    for seed in (7, 11):
        reps, router = _fleet(pkg, tmp / f"rnd{seed}", n=3,
                              routing="random", seed=seed)
        try:
            router.health_check_once()
            seq = []
            for _ in range(16):
                rep = router._route([3], ())
                seq.append(rep.spec.name)
                with router._lock:
                    rep.in_flight -= 1
            log.append(("random", seed, seq))
        finally:
            _teardown(reps, router)
    return log


def test_routing_decisions_are_the_references(tmp_path):
    (tmp_path / "p").mkdir(), (tmp_path / "j").mkdir()
    ours = _decisions(PORT, tmp_path / "p")
    assert ours == _decisions(REF, tmp_path / "j")
    by_key = {}
    for kind, *rest in ours:
        if kind == "affinity":
            by_key.setdefault(tuple(rest[0]), set()).add(rest[1])
    assert all(len(v) == 1 for v in by_key.values())
    assert {r[2] for r in ours if r[0] == "short"} == {"r0"}
    assert all(o == got for k, b, o, got in
               (r for r in ours if r[0] == "exclude") if b != o)
    assert len(set(next(r for r in ours if r[0] == "random")[2])) == 3


def _backoff(pkg, tmp):
    reps, router = _fleet(pkg, tmp, n=2)
    try:
        router.health_check_once()
        gw1, srv1, _, c1 = reps[1]
        _hard_kill(gw1, srv1, c1)
        router.health_check_once()
        r1 = router._by_name("r1")
        out = [r1.state, r1.fails, _stats(router)["ready"]]
        out.append(list(itertools.islice(r1.delays, 8)))
        for _ in range(4):
            out.append(router.generate("m", [3] * PS,
                                       max_new=2)["replica"])
        return out
    finally:
        _teardown(reps, router)


def test_health_backoff_is_the_references(tmp_path):
    (tmp_path / "p").mkdir(), (tmp_path / "j").mkdir()
    ours = _backoff(PORT, tmp_path / "p")
    assert ours == _backoff(REF, tmp_path / "j")
    assert ours[:3] == ["down", 1, 1] and set(ours[4:]) == {"r0"}
    salt = int(hashlib.sha1(b"r1").hexdigest()[:8], 16) % 997
    from paddle_tpu_torch.resilience.retry import RetryPolicy
    want = RetryPolicy(max_attempts=None, deadline=60.0, base_delay=0.05,
                       max_delay=2.0, seed=salt).delays()
    # the schedule's first delay went to the probe that marked it down
    assert ours[3] == list(itertools.islice(want, 1, 9))


# -- migration records through both packages ---------------------------------

def _migration(pkg, tmp, kind):
    """A replica's journal seeded with a tail, the replica killed (or
    drained), the tail settled -> (stats, done records by jid, the
    prompts replayed onto the survivor)."""
    Journal = pkg["gateway"].RequestJournal
    reps, router = _fleet(pkg, tmp, n=2, max_failovers=0)
    (gw0, srv0, spec0, c0), (gw1, srv1, spec1, c1) = reps
    src, dst, dst_spec = ((spec1, gw0, spec0) if kind != "drain"
                          else (spec0, gw1, spec1))
    try:
        router.health_check_once()
        seed = Journal(src.journal_path, compact_bytes=None)
        seed.record_submit("x-1", "default", "m", [11, 3], 2)
        seed.record_submit("x-2", "default", "m", [12, 3], 2,
                           tag="fleet-0-77")
        seed.record_submit("x-3", "default", "m", [13, 3], 2)
        seed.record_submit("x-4", "default", "m", [14, 3], 2,
                           decode={"draft": True}, tag="fleet-0-999")
        seed.record_submit("x-5", "default", "m", [15, 3, 3], 3)
        seed.record_done("x-5")
        seed.flush()
        rep = router._by_name(src.name)
        with router._lock:
            rep.remember_delivered("x-1")
            router._claim_locked("fleet-0-77")
        stats = []
        if kind == "kill":
            _hard_kill(gw1, srv1, c1)
            router.health_check_once()
            stats.append(rep.state)
        elif kind == "drain":
            stats.append(router.drain("r0")["draining"])
            deadline = time.monotonic() + 10
            while not rep.migrated and time.monotonic() < deadline:
                router.health_check_once()
                time.sleep(0.02)
            stats.append(rep.state)
        elif kind == "targets_drain":
            _hard_kill(gw1, srv1, c1)
            with router._lock:
                router._mark_down_locked(rep, time.monotonic())
            gw0._draining = True
            stats.append(router._migrate(rep))
            stats.append(sorted(e["jid"] for e in
                                Journal(src.journal_path).pending()))
            stats.append(rep.migrated)
            gw0._draining = False
            with router._lock:
                router._set_state_locked(router._by_name("r0"), "ready")
        deadline = time.monotonic() + 10
        jr = Journal(src.journal_path)
        while jr.pending() and time.monotonic() < deadline:
            if not rep.migrated:
                stats.append(router._migrate(rep))
            time.sleep(0.02)
        dst.journal.flush()
        replayed = [ln["prompt"] for ln in
                    _journal_lines(dst_spec.journal_path)
                    if ln["op"] == "submit"]
        return (stats, rep.migrations, _stats(router)["migrated_entries"],
                _dones(src.journal_path), replayed)
    finally:
        _teardown(reps, router)


@pytest.mark.parametrize("kind", ["kill", "drain", "targets_drain"])
def test_migration_records_are_the_references(tmp_path, kind):
    (tmp_path / "p").mkdir(), (tmp_path / "j").mkdir()
    ours = _migration(PORT, tmp_path / "p", kind)
    assert ours == _migration(REF, tmp_path / "j", kind)
    stats, migrations, entries, dones, replayed = ours
    assert all(len(v) == 1 for v in dones.values())
    assert dones["x-1"] == [(True, "migrated:delivered")]
    assert dones["x-2"] == [(True, "migrated:claimed")]
    assert dones["x-3"] == [(True, "migrated")]
    # the EchoModel is not speculative-aware: a replay that carried its
    # decode options is refused by the target and closed as failed
    assert dones["x-4"] == [(False, "migrate_failed")]
    assert [13, 3] in replayed and [11, 3] not in replayed
    assert migrations == 1
    if kind == "targets_drain":
        # the first pass closed what needs no target and stopped at the
        # first replay (every target draining); only the pass that
        # finishes counts its entries
        assert stats[0] == {"replayed": 0, "claimed": 1, "delivered": 1,
                            "failed": 0}
        assert stats[1] == ["x-3", "x-4"] and not stats[2]
        assert entries == 2
    else:
        assert entries == 4


# -- the reference's in-process scenarios, on the port -----------------------

class _FlakyReplica:
    """A fake replica whose /readyz is healthy but whose /v1/generate
    response is damaged in flight (a SIGKILL between the status line and
    the full body): a short body against its Content-Length, or a body
    that is not JSON."""

    def __init__(self):
        self.mode = "truncate"
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = json.dumps({"ready": True,
                                   "draining": False}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length")
                                    or 0))
                payload = (b'{"jid": "f-1", "tokens": [1, 2'
                           if outer.mode == "truncate"
                           else b"% not json at all %")
                self.send_response(200)
                self.send_header("Content-Length", str(
                    len(payload) + (16 if outer.mode == "truncate"
                                    else 0)))
                self.end_headers()
                self.wfile.write(payload)
                self.close_connection = True

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        h, p = self.httpd.server_address[:2]
        self.address = f"{h}:{p}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_proxy_failover_on_torn_response_no_inflight_leak(tmp_path):
    gw, srv, good, _ = _mk_replica(PORT, tmp_path, "r0")
    flaky = _FlakyReplica()
    router = FleetRouter([ReplicaSpec("a-bad", flaky.address), good],
                         page_size=PS, routing="least_loaded",
                         probe_interval=0.05, seed=0)
    try:
        router.health_check_once()
        bad = router._by_name("a-bad")
        for mode in ("truncate", "garbage"):
            flaky.mode = mode
            with router._lock:
                router._set_state_locked(bad, "ready")
            out = router.generate("m", [90, 3], max_new=2)
            assert out["replica"] == "r0" and out["tokens"][0] == 90
            with router._lock:
                assert bad.in_flight == 0 and bad.state == "down", mode
                assert router._by_name("r0").in_flight == 0
    finally:
        router.stop()
        flaky.stop()
        srv.stop(drain=False)


def _clients(router, base, n):
    results, errs = [], []

    def client(i):
        try:
            results.append(router.generate("m", [base + i, 3, 3, 3],
                                           max_new=4))
        except Exception as e:          # pragma: no cover - fails below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n)]
    for t in threads:
        t.start()
    return threads, results, errs


def _settled(path):
    jr = RequestJournal(path)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and jr.pending():
        time.sleep(0.05)
    return jr.pending()


def test_kill_failover_migrates_exactly_once(tmp_path):
    reps, router = _fleet(PORT, tmp_path, n=2, delay=0.01)
    (gw0, srv0, spec0, c0), (gw1, srv1, spec1, c1) = reps
    try:
        router.start()
        threads, results, errs = _clients(router, 50, 8)
        time.sleep(0.02)
        _hard_kill(gw1, srv1, c1)
        for t in threads:
            t.join(60)
        assert not errs
        # zero lost: every client answered, with ITS OWN echo
        assert sorted(r["tokens"][0] for r in results) == \
            list(range(50, 58))
        assert _settled(spec1.journal_path) == []
        # zero duplicated: one done record a jid
        assert all(len(v) == 1 for v in
                   _dones(spec1.journal_path).values())
        assert router.stats()["migrated_entries"] >= 1
        assert router._by_name("r1").migrations == 1
    finally:
        _teardown(reps, router)


def test_drain_migrates_queued_tail_without_duplicates(tmp_path):
    reps, router = _fleet(PORT, tmp_path, n=2, delay=0.02, slots=1,
                          routing="least_loaded")
    (gw0, srv0, spec0, c0), (gw1, srv1, spec1, c1) = reps
    try:
        router.start()
        threads, results, errs = _clients(router, 70, 6)
        time.sleep(0.03)
        router.drain("r0")
        for t in threads:
            t.join(60)
        assert not errs
        assert sorted(r["tokens"][0] for r in results) == \
            list(range(70, 76))
        assert _settled(spec0.journal_path) == []
        assert all(len(v) == 1 for v in
                   _dones(spec0.journal_path).values())
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(spec0.address, "/v1/generate",
                  {"model": "m", "prompt": [3], "max_new": 2})
        assert ei.value.code == 503
        assert router.generate("m", [80, 3], max_new=2)["replica"] == "r1"
    finally:
        _teardown(reps, router)


def test_router_server_routes_and_errors(tmp_path):
    reps, router = _fleet(PORT, tmp_path, n=2)
    fs = FleetRouterServer(router, port=0)
    addr = fs.start()
    try:
        assert _get(addr, "/healthz")["ok"] is True
        assert _get(addr, "/readyz")["ready"] is True
        st = _get(addr, "/statusz")
        assert st["ready"] == 2 and st["routing"] == "affinity"
        assert _get(addr, "/v1/models")["aliases"] == {"m": "1"}
        out = _post(addr, "/v1/generate", {"model": "m",
                                           "prompt": [9, 9, 9, 9, 5],
                                           "max_new": 4})
        assert out["tokens"] == [9] * 4 and out["replica"] in ("r0", "r1")
        for body, code in (({"model": "m", "prompt": [3],
                             "stream": True}, 400),
                           ({"model": "nope", "prompt": [3]}, 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(addr, "/v1/generate", body)
            assert ei.value.code == code
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(addr, "/v1/fleet", {"action": "drain",
                                      "replica": "nope"})
        assert ei.value.code == 404
        assert _post(addr, "/v1/fleet", {"action": "drain",
                                         "replica": "r1"})["draining"]
        assert _post(addr, "/v1/fleet", {"action": "restore",
                                         "replica": "r1"}) == \
            {"restoring": "r1"}
        _post(addr, "/v1/fleet", {"action": "drain", "replica": "r0"})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and _get(addr, "/statusz")["ready"]:
            time.sleep(0.05)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(addr, "/v1/generate", {"model": "m", "prompt": [3]})
        assert ei.value.code == 503 and ei.value.headers["Retry-After"]
        assert json.loads(ei.value.read().decode())["reason"] == \
            "no_ready_replica"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(addr, "/readyz")
        assert ei.value.code == 503
    finally:
        fs.stop()
        for gw, srv, _, _ in reps:
            srv.stop(drain=False)


def test_fleet_cli_status_and_verbs(tmp_path, capsys):
    from paddle_tpu_torch.tools.fleet import main as cli
    reps, router = _fleet(PORT, tmp_path, n=2)
    fs = FleetRouterServer(router, port=0)
    addr = fs.start()
    try:
        assert cli(["status", addr]) == 0
        assert json.loads(capsys.readouterr().out)["ready"] == 2
        assert cli(["generate", addr, "m", "--prompt", "9 9 9 9",
                    "--max-new", "3"]) == 0
        assert json.loads(capsys.readouterr().out)["tokens"] == [9] * 3
        assert cli(["drain", addr, "r1"]) == 0
        assert json.loads(capsys.readouterr().out)["draining"] is True
        assert cli(["restore", addr, "r1"]) == 0
        capsys.readouterr()
        assert cli(["drain", addr, "nope"]) == 1
        capsys.readouterr()
    finally:
        fs.stop()
        for gw, srv, _, _ in reps:
            srv.stop(drain=False)
    assert cli(["status", "127.0.0.1:1"]) == 2


def test_affinity_beats_random_prefix_hit_rate(tmp_path):
    """Shared-prompt traffic through affinity routing reuses prefix pages
    better than seeded random routing, on the port's paged generators
    (the CPU)."""
    def run(arm, routing):
        reps, gens = [], []
        for i in range(2):
            g = PagedTransformerGenerator(V, V, param_prefix=f"fl{arm}{i}",
                                          place=fluid.CPUPlace(), **GEN_KW)
            g.init_params(seed=3)
            gens.append(g)
            jp = os.path.join(str(tmp_path), f"{arm}{i}.journal")
            gw = Gateway(n_slots=2, max_new_tokens=2, journal_path=jp)
            gw.load_model("m", "1", instance=g)
            srv = GatewayServer(gw, port=0)
            srv.start()
            reps.append((gw, srv, ReplicaSpec(f"{arm}{i}", srv.address, jp),
                         []))
        router = FleetRouter([r[2] for r in reps], page_size=PS,
                             affinity_depth=2, routing=routing,
                             probe_interval=0.05, seed=0)
        try:
            router.health_check_once()
            rng = np.random.RandomState(11)
            shared = [[int(t) for t in rng.randint(2, V, PS)]
                      for _ in range(4)]
            for _ in range(4):
                for p in shared:
                    tail = [int(t) for t in rng.randint(2, V, 3)]
                    router.generate("m", p + tail, max_new=2)
            st = [g.alloc.stats() for g in gens]
            return (sum(s["prefix_hits"] for s in st)
                    / max(1, sum(s["prefix_lookups"] for s in st)))
        finally:
            _teardown(reps, router)

    aff, rnd = run("aff", "affinity"), run("rnd", "random")
    assert aff > rnd, (aff, rnd)


# -- supervised replica processes (slow, as the reference's) -----------------

@pytest.mark.slow
def test_supervised_replicas_kill_and_drain_exactly_once(tmp_path):
    """Two ``gateway serve --cpu`` processes under ``FleetSupervisor``
    behind the router: one SIGKILLed with requests in flight (every
    request answered once, with the direct greedy decode's tokens; the
    victim's journal settled, one done record a jid; the respawn back in
    rotation), then the other drained (its tail settled)."""
    root = str(tmp_path / "store")
    target = PagedTransformerGenerator(V, V, param_prefix="flt",
                                       place=fluid.CPUPlace(), **GEN_KW)
    target.init_params(seed=3)
    ModelRegistry.save_generator_artifact(target, root, "nmt", "1")
    sup = FleetSupervisor(root=root, models=["nmt=1"], n=2,
                          journal_dir=str(tmp_path / "journals"), slots=4,
                          max_new=OUT, max_restarts=3,
                          log_dir=str(tmp_path / "logs"),
                          extra_args=["--cpu"])
    sup.start(wait_ready=CHILD_WAIT)
    router = FleetRouter(sup.replica_specs(), page_size=PS,
                         probe_interval=0.1, settle_timeout=20.0,
                         request_timeout=CHILD_WAIT, seed=0)
    router.start()
    try:
        assert router.stats()["ready"] == 2
        rng = np.random.RandomState(4)
        prompts = [list(map(int, rng.randint(2, V, PS + 2)))
                   for _ in range(16)]
        expected = []
        for p in prompts:
            toks = [int(t) for t in target.greedy(
                np.array(p).reshape(1, -1), np.array([len(p)], np.int32),
                max_new=OUT, stop_at_end=False)[0]]
            expected.append(toks[:toks.index(1) + 1] if 1 in toks
                            else toks)
        results, errs = {}, []

        def client(i):
            try:
                results[i] = router.generate("nmt", prompts[i],
                                             max_new=OUT)
            except Exception as e:      # pragma: no cover - fails below
                errs.append((i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        time.sleep(0.1)
        sup.kill("replica-0")
        for t in threads:
            t.join(CHILD_WAIT)
        assert not errs, errs
        assert {i: r["tokens"] for i, r in results.items()} == \
            dict(enumerate(expected))
        specs = {s.name: s for s in sup.replica_specs()}
        assert _settled(specs["replica-0"].journal_path) == []
        assert all(len(v) == 1 for v in
                   _dones(specs["replica-0"].journal_path).values())
        deadline = time.monotonic() + CHILD_WAIT
        while time.monotonic() < deadline \
                and router._by_name("replica-0").state == "ready":
            time.sleep(0.05)
        while time.monotonic() < deadline:
            router.health_check_once()
            if router._by_name("replica-0").state == "ready":
                break
            time.sleep(0.5)
        assert router._by_name("replica-0").state == "ready"
        assert sup.status()["replica-0"]["restarts"] >= 1
        router.drain("replica-1")
        out = router.generate("nmt", prompts[0], max_new=OUT)
        assert out["replica"] == "replica-0"
        assert out["tokens"] == expected[0]
        assert _settled(specs["replica-1"].journal_path) == []
    finally:
        router.stop()
        sup.stop()
