"""Process-global metrics registry — the port's copy of the parts of
``paddle_tpu/observability/metrics.py`` that the serving path uses.

Two registration styles, as in the reference:

* **instruments** — ``registry().counter(name, help, labels=(...))``
  returns a get-or-create family; ``family.labels(event="hits")``
  returns the child you ``inc()`` or ``observe()``.  Children
  take a per-child lock, so the scheduler thread and request submitters
  never lose increments.
* **collectors** — ``registry().register_collector(fn)`` for surfaces
  that keep their own counters (``PageAllocator._stats``, the
  scheduler's lane groups): ``fn`` yields ``Sample`` tuples at scrape
  time, so the hot path pays nothing.  Samples from different
  collectors that agree on (name, labels) sum.

``snapshot()`` reads every series back as JSON.  The reference's
gauges, Prometheus text exposition, process-level host label and HTTP
server are not ported yet.  Host-only: nothing here touches the device.
"""

from __future__ import annotations

import math
import re
import time
import weakref
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, \
    Sequence, Tuple

from ..utils.sync import (RANK_METRICS_CHILD, RANK_METRICS_FAMILY,
                          RANK_METRICS_REGISTRY, OrderedLock, OrderedRLock)

__all__ = ["Counter", "Histogram", "MetricsRegistry", "Sample",
           "registry", "DEFAULT_BUCKETS"]

# latency-shaped default buckets (seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name: str) -> str:
    """Prometheus metric/label name rule, checked where a name is coined."""
    if not _NAME_OK.match(name):
        raise ValueError(f"invalid metric/label name {name!r}")
    return name


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Sample(NamedTuple):
    """One exposition sample a collector contributes ('counter' or
    'gauge')."""

    name: str
    kind: str
    labels: Tuple[Tuple[str, str], ...]
    value: float
    help: str = ""


class _Child:
    __slots__ = ("_lock", "_value", "updated_at")

    def __init__(self):
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
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} do not match the "
                f"declared {list(self.label_names)}")
        vals = tuple(str(labels[ln]) for ln in self.label_names)
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = (_HistogramChild(self._buckets)
                         if self.kind == "histogram" else _CounterChild())
                self._children[vals] = child
            return child

    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} has labels "
                             f"{self.label_names}; use .labels(...)")
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._solo().inc(amount)

    def observe(self, value: float):
        self._solo().observe(value)

    @property
    def value(self):
        return self._solo().value

    def children(self) -> List[Tuple[tuple, _Child]]:
        with self._lock:
            return list(self._children.items())


Counter = Histogram = _Family      # public aliases for isinstance


class MetricsRegistry:
    """Thread-safe instrument + collector registry; one per process via
    ``registry()``, private instances for tests."""

    def __init__(self):
        self._lock = OrderedRLock("metrics.registry",
                                  RANK_METRICS_REGISTRY)
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[[], Optional[Callable]]] = []
        self.created_at = time.monotonic()

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
                raise ValueError(
                    f"histogram {name!r} re-registered with buckets "
                    f"{tuple(buckets)}; existing has {fam._buckets}")
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labels,
                            buckets=tuple(buckets))

    def register_collector(self, fn: Callable[[], Iterable[Sample]],
                           owner=None) -> None:
        """Register a scrape-time sample source.  Bound methods are held
        weakly; a plain function with ``owner=`` lives as long as the
        owner.  Dead collectors are pruned at the next collect."""
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
                pairs = list(zip(fam.label_names, vals))
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
        grouped: Dict[str, List[Sample]] = {}
        for s in self._collected_samples().values():
            grouped.setdefault(s.name, []).append(s)
        for name in sorted(grouped):
            samples = grouped[name]
            lines.append(f"# HELP {name} {samples[0].help}")
            lines.append(f"# TYPE {name} {samples[0].kind}")
            for s in sorted(samples, key=lambda s: s.labels):
                lines.append(f"{name}{labelstr(s.labels)} "
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
                    "labels": dict(zip(fam.label_names, vals)),
                    "updated_at": child.updated_at,
                }
                if fam.kind == "histogram":
                    cum, total, count = child.snapshot()
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
                {"labels": dict(s.labels), "value": s.value})
        out.extend(coll[k] for k in sorted(coll))
        return {"monotonic_now": time.monotonic(), "metrics": out}


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumented surface shares."""
    return _registry
