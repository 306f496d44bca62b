"""Process-global metrics registry — the port's copy of
``paddle_tpu/observability/metrics.py``: Counter / Gauge / Histogram with
label sets, Prometheus text exposition, and a JSON snapshot.

Two registration styles, as in the reference:

* **instruments** — ``registry().counter(name, help, labels=(...))``
  returns a family; ``family.labels(k=v, ...)`` (or the family itself
  when it has no labels) returns the child you ``inc()`` / ``set()`` /
  ``observe()``.  Children take a per-child lock, so concurrent writers
  (the scheduler thread, the gateway's HTTP workers) never lose
  increments.
* **collectors** — ``registry().register_collector(fn, owner=obj)``
  for surfaces that keep their own counters (the executor's ``_stats``
  dicts, ``PageAllocator._stats``, the compile cache): ``fn`` yields
  ``Sample`` tuples at scrape time, so the hot path pays nothing.
  Owners are held weakly (bound methods via ``WeakMethod``): a
  collected executor stops contributing.  Samples from different
  collectors that agree on (name, labels) SUM.

Timestamps are monotonic (``time.monotonic``), never wall-clock.

**Process-level labels**: ``PADDLE_TPU_METRICS_HOST=<id>`` (or
``host-<PADDLE_TPU_HOST_ID>``) stamps ``host="<id>"`` onto every exposed
sample at exposition time only; series that declare their own ``host``
label win.  Unset, exposition is unchanged.  ``set_process_labels()`` is
the in-process override.  Exposition text equals the reference's byte
for byte for the same series.  Host-only: nothing here touches the
device.
"""

from __future__ import annotations

import math
import os
import time
import weakref
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, \
    Sequence, Tuple

from ..utils import sync as _sync
from ..utils.sync import (RANK_METRICS_CHILD, RANK_METRICS_FAMILY,
                          RANK_METRICS_REGISTRY, OrderedLock, OrderedRLock)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Sample",
           "registry", "bucket_percentile", "DEFAULT_BUCKETS",
           "set_process_labels", "process_labels"]


def _labels_from_env() -> Tuple[Tuple[str, str], ...]:
    host = os.environ.get("PADDLE_TPU_METRICS_HOST")
    if not host:
        hid = os.environ.get("PADDLE_TPU_HOST_ID")
        if hid:
            host = f"host-{hid}"
    return ((("host", host),) if host else ())


# stamped onto every exposed sample; () = exposition unchanged
_process_labels: Tuple[Tuple[str, str], ...] = _labels_from_env()


def set_process_labels(**labels) -> None:
    """Replace the process-level exposition labels (e.g.
    ``set_process_labels(host="host-3")``; no arguments clears them).
    Applied at scrape/snapshot time to every sample that does not
    already carry the label key."""
    global _process_labels
    _process_labels = tuple(sorted((_check_name(k), str(v))
                                   for k, v in labels.items()))


def process_labels() -> Tuple[Tuple[str, str], ...]:
    return _process_labels


def _stamp(pairs):
    """Process labels + the sample's own pairs (own keys win)."""
    if not _process_labels:
        return pairs
    have = {k for k, _ in pairs}
    extra = [kv for kv in _process_labels if kv[0] not in have]
    return extra + list(pairs) if extra else pairs

# latency-shaped default buckets (seconds): sub-ms dispatch overheads up
# through multi-second queue waits
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_OK = None


def _check_name(name: str) -> str:
    """Prometheus metric/label name rule: [a-zA-Z_:][a-zA-Z0-9_:]*
    (labels without the colon).  Checked at creation, not at scrape —
    a bad name must fail where it was coined."""
    import re

    global _NAME_OK
    if _NAME_OK is None:
        _NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    if not _NAME_OK.match(name):
        raise ValueError(f"invalid metric/label name {name!r}")
    return name


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n") \
                 .replace('"', r'\"')


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if math.isnan(f):
        # a broken set_function gauge reports NaN by design — one bad
        # lazy gauge must render as NaN, not 500 the whole scrape
        return "NaN"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Sample(NamedTuple):
    """One exposition sample a collector contributes: ``kind`` is
    'counter' or 'gauge' (histograms are instrument-only — a collector
    of pre-binned data can emit the _bucket/_sum/_count series itself
    as counters if it must)."""

    name: str
    kind: str
    labels: Tuple[Tuple[str, str], ...]
    value: float
    help: str = ""


class _Child:
    __slots__ = ("_lock", "_value", "updated_at")

    def __init__(self):
        # children share ONE registry node ("metrics.child"): they are
        # leaves of the rank order, and per-child names would explode
        # the sync accounting with thousands of single-writer entries
        self._lock = OrderedLock("metrics.child", RANK_METRICS_CHILD)
        self._value = 0.0
        self.updated_at = time.monotonic()


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount
            self.updated_at = time.monotonic()

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_fn",)

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(value)
            self.updated_at = time.monotonic()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self.updated_at = time.monotonic()

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Lazy gauge: ``fn()`` is called at scrape time (e.g. queue
        depth — sampling it per mutation would be the overhead the
        collector style exists to avoid)."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._value


def bucket_percentile(buckets: Sequence[float], cum: Sequence[int],
                      q: float) -> Optional[float]:
    """Bucket-interpolated percentile over CUMULATIVE counts (the last
    entry is the +Inf total).  Exposed as a module function so a reader
    that differences two cumulative snapshots — the release
    controller's canary window — can price the percentile of just that
    window; ``_HistogramChild.percentile`` is the whole-history view of
    the same math.  Returns None when the window is empty."""
    buckets = tuple(buckets)
    cum = list(cum)
    count = cum[-1] if cum else 0
    if count == 0:
        return None
    rank = q / 100.0 * count
    edges = buckets + (buckets[-1] if buckets else 0.0,)
    prev = 0
    for i, c in enumerate(cum):
        if c >= rank:
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[min(i, len(buckets) - 1)] if buckets else 0.0
            if c == prev:
                return hi
            return lo + (hi - lo) * (rank - prev) / (c - prev)
        prev = c
    return edges[-1]


class _HistogramChild(_Child):
    __slots__ = ("_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        super().__init__()
        self._buckets = tuple(buckets)
        self._counts = [0] * (len(self._buckets) + 1)   # +Inf last
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            for i, b in enumerate(self._buckets):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += v
            self._count += 1
            self.updated_at = time.monotonic()

    def snapshot(self):
        """-> (cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
            return cum, self._sum, self._count

    @property
    def buckets(self) -> Tuple[float, ...]:
        """The bucket edges (without +Inf) — for readers that window a
        cumulative snapshot through ``bucket_percentile``."""
        return self._buckets

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated percentile (None when empty) — good
        enough for statusz rollups; exact percentiles stay with the
        surfaces that keep raw values."""
        cum, _, _ = self.snapshot()
        return bucket_percentile(self._buckets, cum, q)


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class _Family:
    """One named metric family; children are keyed by label values."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        self.name = _check_name(name)
        self.kind = kind
        self.help = help
        self.label_names = tuple(_check_name(ln) for ln in label_names)
        self._buckets = tuple(buckets) if buckets is not None else None
        self._lock = OrderedLock("metrics.family", RANK_METRICS_FAMILY)
        self._children: Dict[tuple, _Child] = {}

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            extra = set(labels) - set(self.label_names)
            missing = set(self.label_names) - set(labels)
            raise ValueError(
                f"{self.name}: label mismatch — extra {sorted(extra)}, "
                f"missing {sorted(missing)} "
                f"(declared: {list(self.label_names)})")
        vals = tuple(str(labels[ln]) for ln in self.label_names)
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = (_HistogramChild(self._buckets)
                         if self.kind == "histogram"
                         else _CHILD_TYPES[self.kind]())
                self._children[vals] = child
            return child

    # label-free convenience: family IS the child when it has no labels
    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} has labels "
                             f"{self.label_names}; use .labels(...)")
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._solo().inc(amount)

    def set(self, value: float):
        self._solo().set(value)

    def set_function(self, fn):
        self._solo().set_function(fn)

    def observe(self, value: float):
        self._solo().observe(value)

    def percentile(self, q: float):
        return self._solo().percentile(q)

    @property
    def value(self):
        return self._solo().value

    def children(self) -> List[Tuple[tuple, _Child]]:
        with self._lock:
            return list(self._children.items())

    def remove_matching(self, **labels) -> int:
        """Drop every child whose label values match all the given
        pairs; returns how many were removed.  The escape valve for
        series whose label space grows without bound by design — the
        gateway drops a model VERSION's children when the version
        unloads, so a continual-publish loop cannot leak one histogram
        per candidate it ever canaried."""
        for k in labels:
            if k not in self.label_names:
                raise ValueError(f"{self.name} has no label {k!r} "
                                 f"(declared: {list(self.label_names)})")
        want = {self.label_names.index(k): str(v)
                for k, v in labels.items()}
        with self._lock:
            doomed = [vals for vals in self._children
                      if all(vals[i] == v for i, v in want.items())]
            for vals in doomed:
                del self._children[vals]
            return len(doomed)


Counter = Gauge = Histogram = _Family      # public aliases for isinstance


class MetricsRegistry:
    """Thread-safe instrument + collector registry; one per process via
    ``registry()``, private instances for tests."""

    def __init__(self):
        self._lock = OrderedRLock("metrics.registry",
                                  RANK_METRICS_REGISTRY)
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], Optional[Callable]]] = []
        self.created_at = time.monotonic()

    # -- instruments ---------------------------------------------------------
    def _family(self, name, kind, help, labels, buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help, labels, buckets)
                self._families[name] = fam
                return fam
            if fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind} with labels "
                    f"{tuple(labels)}; existing is {fam.kind} with "
                    f"{fam.label_names}")
            if kind == "histogram" and buckets is not None \
                    and fam._buckets != tuple(buckets):
                # silently handing back the first caller's bins would
                # park the second caller's observations in foreign
                # buckets with no error — as loud as a kind conflict
                raise ValueError(
                    f"histogram {name!r} re-registered with buckets "
                    f"{tuple(buckets)}; existing has {fam._buckets}")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labels,
                            buckets=tuple(buckets))

    def get(self, name: str) -> Optional[_Family]:
        """Read access to an existing instrument family (None when
        absent) — for consumers like the release controller that WATCH
        series other surfaces write, without re-declaring kind/labels
        (and without ever creating the family as a side effect)."""
        with self._lock:
            return self._families.get(name)

    # -- collectors ----------------------------------------------------------
    def register_collector(self, fn: Callable[[], Iterable[Sample]],
                           owner=None) -> None:
        """Register a scrape-time sample source.  Bound methods are held
        via ``WeakMethod`` (the instrument must not keep its owner
        alive); a plain function with ``owner=`` is gated on the owner's
        liveness.  Dead collectors are pruned at the next collect."""
        if hasattr(fn, "__self__"):
            ref = weakref.WeakMethod(fn)

            def getter():
                return ref()
        elif owner is not None:
            oref = weakref.ref(owner)

            def getter():
                return fn if oref() is not None else None
        else:
            def getter():
                return fn
        with self._lock:
            self._collectors.append(getter)

    def _collected_samples(self) -> Dict[tuple, Sample]:
        """Collector output, accumulated: samples agreeing on
        (name, labels) sum — N executors = one series."""
        with self._lock:
            getters = list(self._collectors)
        out: Dict[tuple, Sample] = {}
        dead = []
        for g in getters:
            fn = g()
            if fn is None:
                dead.append(g)
                continue
            try:
                samples = list(fn())
            except Exception:
                continue        # a broken source must not kill the scrape
            for s in samples:
                key = (s.name, s.labels)
                prev = out.get(key)
                out[key] = s if prev is None else prev._replace(
                    value=prev.value + s.value)
        if dead:
            with self._lock:
                self._collectors = [g for g in self._collectors
                                    if g not in dead]
        return out

    # -- exposition ----------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []

        def labelstr(pairs: Sequence[Tuple[str, str]]) -> str:
            if not pairs:
                return ""
            inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
            return "{" + inner + "}"

        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for vals, child in sorted(fam.children()):
                pairs = _stamp(list(zip(fam.label_names, vals)))
                if fam.kind == "histogram":
                    cum, total, count = child.snapshot()
                    edges = [_fmt_value(b) for b in child._buckets] \
                        + ["+Inf"]
                    for edge, c in zip(edges, cum):
                        lines.append(
                            f"{name}_bucket"
                            f"{labelstr(pairs + [('le', edge)])} {c}")
                    lines.append(f"{name}_sum{labelstr(pairs)} "
                                 f"{_fmt_value(total)}")
                    lines.append(f"{name}_count{labelstr(pairs)} {count}")
                else:
                    lines.append(f"{name}{labelstr(pairs)} "
                                 f"{_fmt_value(child.value)}")
        # collector samples, grouped by family name for TYPE/HELP lines
        grouped: Dict[str, List[Sample]] = {}
        for s in self._collected_samples().values():
            grouped.setdefault(s.name, []).append(s)
        for name in sorted(grouped):
            samples = grouped[name]
            lines.append(f"# HELP {name} {samples[0].help}")
            lines.append(f"# TYPE {name} {samples[0].kind}")
            for s in sorted(samples, key=lambda s: s.labels):
                lines.append(f"{name}{labelstr(_stamp(s.labels))} "
                             f"{_fmt_value(s.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """JSON-able snapshot of every series (instruments + collector
        samples) with monotonic timestamps."""
        out: List[Dict[str, object]] = []
        with self._lock:
            families = sorted(self._families.items())
        for name, fam in families:
            samples = []
            for vals, child in sorted(fam.children()):
                entry: Dict[str, object] = {
                    "labels": dict(_stamp(list(zip(fam.label_names,
                                                   vals)))),
                    "updated_at": child.updated_at,
                }
                if fam.kind == "histogram":
                    cum, total, count = child.snapshot()
                    # string bucket edges: float('inf') is not a JSON key
                    entry.update(sum=total, count=count,
                                 buckets=dict(zip(
                                     [*(_fmt_value(b)
                                        for b in child._buckets), "+Inf"],
                                     cum)))
                else:
                    entry["value"] = child.value
                samples.append(entry)
            out.append({"name": name, "type": fam.kind, "help": fam.help,
                        "samples": samples})
        coll: Dict[str, Dict[str, object]] = {}
        for s in self._collected_samples().values():
            fam_entry = coll.setdefault(
                s.name, {"name": s.name, "type": s.kind, "help": s.help,
                         "samples": []})
            fam_entry["samples"].append(
                {"labels": dict(_stamp(s.labels)), "value": s.value})
        out.extend(coll[k] for k in sorted(coll))
        return {"monotonic_now": time.monotonic(), "metrics": out}


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumented surface shares."""
    return _registry


# The sync layer's paddle_sync_* accounting registers its collector
# HERE (this module already imports utils.sync; sync cannot import
# metrics at module load without a cycle).  Registration is guarded
# inside SyncRegistry, so a later enable_checking() never duplicates
# it — and PADDLE_TPU_SYNC_CHECK=1 exports its series without anyone
# calling enable_checking() explicitly.
_sync.registry()._register_collector()
