"""The port's observability and concurrency layer against the JAX
package's, on the CPU: ``observability/{metrics,tracing,server}.py``,
``tools/obs.py``, ``utils/sync.py`` and ``utils/journal.py``.

* Metrics: the same series (labels that need escaping, gauges with
  ``set_function``, histograms, collector samples, process labels)
  render the reference's exposition text byte for byte; the JSON
  snapshot and ``bucket_percentile`` / a histogram's ``percentile``
  equal the reference's; ``remove_matching`` and ``get`` behave as the
  reference's.
* The HTTP server: ``/metrics``, ``/healthz``, ``/statusz`` (a broken
  source isolated), ``/trace`` and a 404 on port 0; ``tools/obs``'s
  subcommands and exit codes.
* Sync: the rank table is the reference's; with checking on, the same
  acquisition orders raise ``LockOrderError`` / ``DeadlockCycleError``
  in both packages; the registry's status and metrics name the locks.
* Journal files: a torn tail is sealed before the next append, as the
  reference's, and the two packages read each other's files.

Every HTTP call takes its own timeout.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.utils import journal as jjournal
from paddle_tpu.utils import sync as jsync
from paddle_tpu_torch.observability import metrics, tracing
from paddle_tpu_torch.observability.server import ObservabilityServer
from paddle_tpu_torch.tools import obs
from paddle_tpu_torch.utils import journal, sync

WAIT = 30.0


def _fill(m):
    """One registry of package ``m`` with every kind of series."""
    reg = m.MetricsRegistry()
    c = reg.counter("req_total", "requests", labels=("event", "model"))
    c.labels(event="ok", model="a").inc(3)
    c.labels(event='we"ird\nname\\', model="b").inc()
    g = reg.gauge("depth", "queue depth")
    g.set(2.5)
    reg.gauge("lazy", "sampled at scrape").set_function(lambda: 41 + 1)
    reg.gauge("broken", "raises").set_function(lambda: 1 / 0)
    h = reg.histogram("lat_seconds", "latency", labels=("tenant",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.labels(tenant="t").observe(v)
    reg.histogram("other_seconds", "h").observe(0.2)

    def collect():
        yield m.Sample("coll_total", "counter", (("k", "x"),), 4.0, "c")
        yield m.Sample("coll_total", "counter", (("k", "x"),), 1.5, "c")
        yield m.Sample("coll_gauge", "gauge", (), 7.0, "g")
    reg.register_collector(collect)
    return reg, collect


def test_exposition_is_the_references_byte_for_byte():
    ours, _c1 = _fill(metrics)
    ref, _c2 = _fill(jmetrics)
    assert ours.render_prometheus() == ref.render_prometheus()
    try:
        metrics.set_process_labels(host="host-3")
        jmetrics.set_process_labels(host="host-3")
        text = ours.render_prometheus()
        assert text == ref.render_prometheus()
        assert 'depth{host="host-3"} 2.5' in text
        assert metrics.process_labels() == jmetrics.process_labels()
    finally:
        metrics.set_process_labels()
        jmetrics.set_process_labels()

    def strip(snap):
        # the monotonic stamps differ; NaN compares through its JSON
        for m in snap["metrics"]:
            for smp in m["samples"]:
                smp.pop("updated_at", None)
        return json.dumps(snap["metrics"], sort_keys=True)

    assert strip(ours.snapshot()) == strip(ref.snapshot())


def test_percentiles_remove_matching_and_get():
    rng = np.random.RandomState(0)
    for _ in range(20):
        buckets = tuple(sorted(rng.uniform(0.01, 10, 4)))
        cum = list(np.cumsum(rng.randint(0, 5, 5)))
        for q in (1, 50, 95, 99.9):
            assert metrics.bucket_percentile(buckets, cum, q) == \
                jmetrics.bucket_percentile(buckets, cum, q)
    assert metrics.bucket_percentile((1.0,), [0, 0], 50) is None
    reg = metrics.MetricsRegistry()
    h = reg.histogram("p_seconds", "p", labels=("model", "version"),
                      buckets=(0.1, 1.0, 10.0))
    for v in [0.05] * 90 + [5.0] * 10:
        h.labels(model="m", version="1").observe(v)
    h.labels(model="m", version="2").observe(0.5)
    child = h.labels(model="m", version="1")
    assert child.percentile(50) <= 0.1 and 1.0 <= child.percentile(99) <= 10
    assert reg.get("p_seconds") is h and reg.get("nope") is None
    assert h.remove_matching(version="1") == 1
    assert "version=\"1\"" not in reg.render_prometheus()
    with pytest.raises(ValueError):
        h.remove_matching(tenant="x")


def _get(addr, route):
    with urllib.request.urlopen(f"http://{addr}{route}",
                                timeout=WAIT) as r:
        return r.read()


def test_server_endpoints_and_obs_cli(tmp_path, capsys):
    reg, _c = _fill(metrics)
    tr = tracing.Tracer()
    with tr.span("step", k=1):
        pass
    tr.instant("cli/mark")
    srv = ObservabilityServer(registry=reg, tracer=tr)
    srv.attach("demo", lambda: {"x": 1, (2, 3): np.int64(4)})
    srv.attach("broken", lambda: 1 / 0)
    srv.attach("sync", sync.registry())
    addr = srv.start()
    try:
        assert _get(addr, "/metrics").decode() == reg.render_prometheus()
        health = json.loads(_get(addr, "/healthz"))
        assert health["ok"] is True and health["uptime_s"] >= 0
        status = json.loads(_get(addr, "/statusz"))
        assert status["sources"] == ["broken", "demo", "sync"]
        assert status["demo"] == {"x": 1, "(2, 3)": 4}
        assert "ZeroDivisionError" in status["broken"]["error"]
        assert "locks" in status["sync"]
        trace = json.loads(_get(addr, "/trace"))
        assert [e["name"] for e in trace["traceEvents"]] == ["step",
                                                             "cli/mark"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(addr, "/nope")
        assert e.value.code == 404
        capsys.readouterr()
        assert obs.main(["healthz", addr]) == 0
        assert '"ok": true' in capsys.readouterr().out
        assert obs.main(["metrics", addr, "--grep", "req_total"]) == 0
        out = capsys.readouterr().out
        assert out.strip() and all("req_total" in ln
                                   for ln in out.splitlines() if ln)
        assert obs.main(["statusz", addr]) == 0
        assert json.loads(capsys.readouterr().out)["demo"]["x"] == 1
        dump = tmp_path / "t.json"
        assert obs.main(["trace", addr, "-o", str(dump)]) == 0
        assert len(json.loads(dump.read_text())["traceEvents"]) == 2
    finally:
        srv.stop()
    with pytest.raises(RuntimeError):
        srv.start()
    assert obs.main(["healthz", "127.0.0.1:1", "--timeout", "0.2"]) == 2


def test_rank_table_is_the_references():
    assert sync.RANK_TABLE == jsync.RANK_TABLE
    ranks = {n: getattr(sync, n) for n in dir(sync) if n.startswith("RANK_")
             and n != "RANK_TABLE"}
    assert ranks == {n: getattr(jsync, n) for n in dir(jsync)
                     if n.startswith("RANK_") and n != "RANK_TABLE"}


def _orders(s):
    """The outcome of each scripted acquisition order under package
    ``s``'s checking registry."""
    out = []
    s.registry().reset()
    s.enable_checking()
    try:
        lo = s.OrderedLock("gateway.router", s.RANK_ROUTER)
        hi = s.OrderedLock("metrics.family", s.RANK_METRICS_FAMILY)
        a = s.OrderedLock("journal.a", s.RANK_JOURNAL_FILE)
        b = s.OrderedLock("journal.b", s.RANK_JOURNAL_FILE)
        r = s.OrderedRLock("gateway.registry", s.RANK_MODEL_REGISTRY)
        cases = [(lo, hi), (hi, lo), (a, b), (b, a), (r, r), (lo, lo)]
        for first, second in cases:
            try:
                with first:
                    with second:
                        pass
                out.append("ok")
            except s.DeadlockCycleError:
                out.append("cycle")
            except s.LockOrderError:
                out.append("order")
        cond = s.OrderedCondition(lo)
        with cond:
            cond.wait(0.001)
        st = s.registry().status()
        out.append((st["violations"], sorted(st["locks"]), st["edges"]))
        return out
    finally:
        s.disable_checking()
        s.registry().reset()


def test_lock_order_errors_on_the_same_orders():
    got = _orders(sync)
    assert got == _orders(jsync)
    assert got[:6] == ["ok", "order", "ok", "cycle", "ok", "order"]
    text = metrics.registry().render_prometheus()
    assert "paddle_sync_order_violations_total" in text


def test_unchecked_locks_stay_exclusive_under_threads():
    lock = sync.OrderedLock("pipeline.loader", sync.RANK_LOADER)
    total = [0]

    def work():
        for _ in range(2000):
            with lock:
                total[0] += 1

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    assert total[0] == 16000


def test_journal_file_seals_a_torn_tail_as_the_reference(tmp_path):
    for name, mod in (("port", journal), ("jax", jjournal)):
        path = tmp_path / f"{name}.jsonl"
        path.write_text('{"a":1}\n{"torn":')
        f = mod.JournalFile(str(path), fsync=True, name="gateway.journal")
        f.append({"b": 2})
        f.compact(lambda lines: [ln for ln in lines if "torn" not in ln])
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes() == b'{"a":1}\n{"b":2}\n'
    assert journal.JournalFile(str(tmp_path / "jax.jsonl")).read_lines() \
        == jjournal.JournalFile(str(tmp_path / "port.jsonl")).read_lines()
    assert journal.terminate_torn_tail(str(tmp_path / "none")) is False
