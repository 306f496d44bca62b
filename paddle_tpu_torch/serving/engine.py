"""InferenceEngine: shape-bucketed inference over a pruned program — the
port of ``paddle_tpu/serving/engine.py``.

The reference's deployment path (`paddle/capi`, inference/io.h) loads a
merged model once and forwards arbitrary-shaped requests.  Here, as in
the JAX package, every distinct (batch, seq) signature is an executable
of its own (on the card, a step captured in a CUDA graph, or a
host-driven decode run eagerly), so the engine makes the shape set
finite:

* requests are padded up into a small set of batch buckets (and, for
  SeqArray feeds, time buckets) by replicating the last row, so mixed
  traffic reuses a handful of cached steps;
* outputs are sliced back to the true batch on the device, so bucketing
  is invisible to the caller (``return_numpy=False`` returns the card's
  tensors);
* weights live in the scope as device tensors (``place_weights``,
  ``load_inference_model(to_device=True)``);
* ``cache_stats()`` exposes bucket hit/miss and padding counters next to
  the executor's executable-cache counters.

``quantize="int8"`` runs the post-training int8 rewrite
(``fluid.transforms.quantize_program``) on a clone of the program and a
private host copy of its persistables: a caller's card tensors may be a
captured graph's buffers and are never quantized in place.  Not ported
(they raise, naming their queue item): ``static_hbm_estimate`` (the cost
model, ROADMAP A14) and ``preresolve(stop_on_compile=True)`` (it reads
the persistent compile cache's misses, A10(b)).
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import fluid
from ..fluid.core.lod import NestedSeqArray, SeqArray
from ..fluid.executor import _to_numpy
from ..fluid.framework import Variable

__all__ = ["InferenceEngine"]

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad the batch axis to ``n`` rows by replicating the last row —
    replicated real data can never produce NaN paths a zero row might."""
    if a.shape[0] == n:
        return a
    pad = np.repeat(a[-1:], n - a.shape[0], axis=0)
    return np.concatenate([a, pad], axis=0)


def _pad_time(a: np.ndarray, t: int) -> np.ndarray:
    if a.shape[1] == t:
        return a
    width = [(0, 0)] * a.ndim
    width[1] = (0, t - a.shape[1])
    return np.pad(a, width)


def _slice_rows(v, n: int):
    """Row-slice without a copy to the host: a card tensor slices on the
    card, so the padded bucket rows never cross to the host."""
    if isinstance(v, SeqArray):
        return SeqArray(v.data[:n], v.lengths[:n])
    if isinstance(v, NestedSeqArray):
        return NestedSeqArray(v.data[:n], v.outer_lengths[:n],
                              v.inner_lengths[:n])
    return v[:n]


def _host_copy(val):
    """A scope value as a host copy of its own: a card tensor copied to
    the CPU, a CPU tensor or a numpy array cloned."""
    if isinstance(val, SeqArray):
        return SeqArray(_host_copy(val.data), _host_copy(val.lengths))
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().clone()
    return np.array(np.asarray(val))


class InferenceEngine:
    """Bucketed, executable-cached inference over one pruned program.

    Construct either from a ``save_inference_model`` directory
    (``InferenceEngine(dirname=...)``) or from an in-memory pruned
    program (``InferenceEngine(program=..., feed_names=...,
    fetch_vars=..., scope=...)`` — e.g. ``fluid.io.prune_program`` output
    sharing a trained scope).
    """

    def __init__(self, program=None, feed_names: Optional[Sequence] = None,
                 fetch_vars: Optional[Sequence] = None, *,
                 dirname: Optional[str] = None, scope=None, place=None,
                 executor=None,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 time_bucket: int = 8, mode: str = "infer",
                 quantize: str = "off"):
        if quantize not in ("off", "int8"):
            raise ValueError(f"quantize={quantize!r}: 'off' or 'int8'")
        owns_scope = scope is None
        self.scope = scope or fluid.Scope()
        self.exe = executor or fluid.Executor(place or fluid.CUDAPlace(0))
        if dirname is not None:
            if program is not None:
                raise ValueError("pass program=... or dirname=..., not both")
            # when quantizing, the float weights are only calibration
            # input on the host: _quantize_int8 places the int8 copies
            program, feed_names, fetch_vars = fluid.io.load_inference_model(
                dirname, self.exe, scope=self.scope,
                to_device=(quantize != "int8"))
        if program is None:
            raise ValueError("InferenceEngine needs a program or a dirname")
        self._quant_stats = None
        if quantize == "int8":
            program = self._quantize_int8(program, clone_scope=not owns_scope)
        self.quantize = quantize
        self.program = program
        self.feed_names = list(feed_names or [])
        self.fetch_list = [f if isinstance(f, Variable) else str(f)
                           for f in (fetch_vars or [])]
        self.mode = mode
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.time_bucket = max(1, int(time_bucket))
        self._stats = {"bucket_hits": 0, "bucket_misses": 0}
        self._buckets: Dict[tuple, int] = {}
        # padding counters: the rows / tokens the caller asked for vs
        # what the bucket dispatched
        self._padding = {"true_rows": 0, "padded_rows": 0,
                         "true_tokens": 0, "padded_tokens": 0}
        self._warming = False
        # telemetry: the counter dicts above stay the source of truth; a
        # weak scrape-time collector exports them labeled
        from ..observability.metrics import registry as _obs_registry

        _obs_registry().register_collector(self._collect_metrics)

    def _collect_metrics(self):
        from ..observability.metrics import Sample

        for ev in ("bucket_hits", "bucket_misses"):
            yield Sample("paddle_engine_bucket_events_total", "counter",
                         (("event", ev.split("_", 1)[1]),),
                         float(self._stats[ev]),
                         "Shape-bucket reuse vs first-dispatch events")
        yield Sample("paddle_engine_buckets", "gauge", (),
                     float(len(self._buckets)),
                     "Distinct shape buckets registered")
        for k, v in self._padding.items():
            kind, what = k.split("_", 1)    # true/padded x rows/tokens
            yield Sample(f"paddle_engine_padding_{what}_total",
                         "counter", (("kind", kind),), float(v),
                         "Requested vs dispatched rows/tokens (padding "
                         "honesty counters)")

    # -- post-training quantization --------------------------------------------
    def _quantize_int8(self, program, clone_scope=True):
        """Clone the program and the persistable slice of the scope, then
        run the per-channel int8 rewrite over the private copies: a
        trained scope shared with the caller keeps its float weights.
        The copies are host copies (a card tensor of the caller's scope
        may be a captured graph's buffer, which the rewrite must never
        touch).  ``clone_scope=False`` skips the copy when the engine
        made the scope itself (a dirname load with no caller scope)."""
        from ..fluid.transforms.quantize import quantize_program

        program = program.clone(for_test=True)
        if clone_scope:
            private = fluid.Scope()
            for v in program.list_vars():
                if v.persistable:
                    val = self.scope.find_var(v.name)
                    if val is not None:
                        private.set_var(v.name, _host_copy(val))
            self.scope = private
        self._quant_stats = quantize_program(program, self.scope)
        # the int8 weights and scales are host values: place them (and
        # the float rest) so the first request does not pay the upload
        fluid.io.device_put_persistables(self.scope, program,
                                         device=self.exe.device)
        return program

    # -- bucketing -----------------------------------------------------------
    def _batch_bucket(self, b: int) -> int:
        i = bisect.bisect_left(self.batch_buckets, b)
        if i < len(self.batch_buckets):
            return self.batch_buckets[i]
        # beyond the largest configured bucket: next multiple of it, so
        # giant batches still land on a finite shape set
        top = self.batch_buckets[-1]
        return ((b + top - 1) // top) * top

    def _time_pad(self, t: int) -> int:
        tb = self.time_bucket
        return ((t + tb - 1) // tb) * tb

    def _pad_feed(self, feed: Dict[str, Any]):
        """Pad every feed entry to (batch bucket, time bucket); returns
        (padded_feed, true_batch, signature_key)."""
        true_b = None
        for v in feed.values():
            b = (v.data.shape[0] if isinstance(v, (SeqArray, NestedSeqArray))
                 else np.asarray(v).shape[0])
            if true_b is None:
                true_b = b
            elif b != true_b:
                raise ValueError(
                    f"InferenceEngine: mixed feed batch sizes {true_b} vs "
                    f"{b}; all feeds must share the batch dimension")
        if true_b is None:
            raise ValueError("InferenceEngine: empty feed")
        nb = self._batch_bucket(true_b)
        padded = {}
        key: List[tuple] = [("batch", nb)]
        pad_tokens = [0, 0]      # [true, padded] across SeqArray feeds
        for name in sorted(feed):
            v = feed[name]
            if isinstance(v, SeqArray):
                data = np.asarray(v.data)
                lengths = np.asarray(v.lengths, np.int32)
                t = self._time_pad(data.shape[1])
                pad_tokens[0] += int(np.minimum(lengths, t).sum())
                pad_tokens[1] += nb * t
                data = _pad_rows(_pad_time(data, t), nb)
                lengths = _pad_rows(lengths, nb)
                padded[name] = SeqArray(data, lengths)
                key.append((name, "seq", data.shape, str(data.dtype)))
            elif isinstance(v, NestedSeqArray):
                # batch-pad all three components in step (np.asarray on a
                # NestedSeqArray would silently DROP the outer/inner
                # lengths); the nested time extents stay as given
                data = _pad_rows(np.asarray(v.data), nb)
                outer = _pad_rows(np.asarray(v.outer_lengths, np.int32), nb)
                inner = _pad_rows(np.asarray(v.inner_lengths, np.int32), nb)
                padded[name] = NestedSeqArray(data, outer, inner)
                key.append((name, "nested", data.shape, str(data.dtype)))
            else:
                a = np.asarray(v)
                a = _pad_rows(a, nb)
                padded[name] = a
                key.append((name, a.shape, str(a.dtype)))
        return padded, true_b, tuple(key), pad_tokens

    def bucket_key(self, feed: Dict[str, Any]) -> tuple:
        """The bucket signature this feed lands on (host-side padding
        math only, no dispatch) — lets callers enumerate the distinct
        buckets of a traffic sample for targeted warmup."""
        _, _, key, _ = self._pad_feed(feed)
        return key

    # -- execution -----------------------------------------------------------
    def infer(self, feed: Dict[str, Any],
              fetch_list: Optional[Sequence] = None,
              return_numpy: bool = True) -> List[Any]:
        """Run one request batch through the bucketed executable; outputs
        are sliced back to the true batch size."""
        padded, true_b, key, pad_tokens = self._pad_feed(feed)
        warming = self._warming
        if not warming:
            if key in self._buckets:
                self._stats["bucket_hits"] += 1
            else:
                self._stats["bucket_misses"] += 1
            nb = key[0][1]
            self._padding["true_rows"] += true_b
            self._padding["padded_rows"] += nb
            self._padding["true_tokens"] += pad_tokens[0]
            self._padding["padded_tokens"] += pad_tokens[1]
        # warm-up registers the key (count 0) without counting a request:
        # sum(buckets.values()) == bucket_hits + bucket_misses always
        self._buckets[key] = self._buckets.get(key, 0) + (0 if warming
                                                          else 1)
        with fluid.scope_guard(self.scope):
            outs = self.exe.run(self.program, feed=padded,
                                fetch_list=fetch_list or self.fetch_list,
                                return_numpy=False, mode=self.mode)
        outs = [_slice_rows(o, true_b) for o in outs]
        if not return_numpy:
            return outs
        return [_to_numpy(o) for o in outs]

    def warmup(self, sample_feeds: Sequence[Dict[str, Any]]) -> None:
        """Compile the buckets the given sample feeds land on (and upload
        the weights device-side via the first dispatch) so serving traffic
        starts at steady state.  Warm-up dispatches register their bucket
        keys but count as neither hits nor misses."""
        self._warming = True
        try:
            for feed in sample_feeds:
                self.infer(feed)
        finally:
            self._warming = False

    def place_weights(self) -> int:
        """Explicitly device_put every host-resident scope value; returns
        the number uploaded.  The first dispatch does this implicitly —
        call it from setup when you want the upload off the request
        path.  Restricted to THIS program's persistables — a scope
        shared with training may hold unrelated host values."""
        return fluid.io.device_put_persistables(self.scope, self.program,
                                                device=self.exe.device)

    # -- static cost surface --------------------------------------------------
    def static_hbm_estimate(self, batch: Optional[int] = None):
        """The reference's static peak-HBM plan of the served program:
        not ported (it needs the cost model, ROADMAP A14)."""
        raise NotImplementedError(
            "InferenceEngine.static_hbm_estimate needs analysis/cost.py, "
            "not ported to paddle_tpu_torch (ROADMAP Queue A14)")

    def bucket_set(self, max_time: Optional[int] = None):
        """Enumerate the closed set of step signatures this engine can
        dispatch (each a cached step of the executor).  Ragged (SeqArray) feeds need ``max_time`` to close the time
        axis: the time buckets are the multiples of ``time_bucket`` up
        to it."""
        from ..fluid.analysis.dataflow import ProgramView
        from ..fluid.analysis.recompile import enumerate_buckets

        time_buckets = ()
        if max_time is not None:
            # top bucket rounds UP, matching _time_pad: a request of
            # max_time tokens must land on an enumerated signature
            time_buckets = tuple(range(self.time_bucket,
                                       self._time_pad(int(max_time)) + 1,
                                       self.time_bucket))
        return enumerate_buckets(ProgramView(self.program.desc),
                                 batch_buckets=self.batch_buckets,
                                 time_buckets=time_buckets)

    # -- pre-resolution ---------------------------------------------------------
    def aot_bucket_feeds(self, max_time: Optional[int] = None):
        """One synthetic zero feed per enumerated signature — each lands
        exactly on its bucket (batch == bucket, time already a
        time_bucket multiple), so dispatching them resolves the engine's
        whole closed set of steps.  Raises on an open bucket set (ragged
        feeds with no ``max_time``, dynamic inner dims)."""
        feeds = []
        for entry in self.bucket_set(max_time=max_time):
            if not entry["closed"]:
                raise ValueError(
                    "aot_bucket_feeds: the bucket set is OPEN "
                    f"(entry {entry['batch']}x{entry['time']}); pass "
                    "max_time= for ragged feeds, and keep value-shaped "
                    "axes out of the served program")
            feed = {}
            for name, spec in entry["feeds"].items():
                shape = [int(d) for d in spec["shape"]]
                if spec["lod_level"] > 0:
                    feed[name] = SeqArray(
                        np.zeros(shape, spec["dtype"]),
                        np.full(shape[0], shape[1], np.int32))
                else:
                    feed[name] = np.zeros(shape, spec["dtype"])
            feeds.append(feed)
        return feeds

    def preresolve(self, max_time: Optional[int] = None,
                   stop_on_compile: bool = False) -> int:
        """Dispatch every signature in the closed bucket set once (via
        ``warmup`` — registers buckets without skewing hit counters), so
        each step is cached (captured, on the card) before traffic.
        Returns the number of signatures resolved.
        ``stop_on_compile=True`` (stop at the first miss of the
        reference's persistent compile cache) raises."""
        if stop_on_compile:
            raise NotImplementedError(
                "InferenceEngine.preresolve(stop_on_compile=True) reads the "
                "persistent compile cache's misses, not ported to "
                "paddle_tpu_torch (ROADMAP Queue A10(b))")
        feeds = self.aot_bucket_feeds(max_time=max_time)
        self.warmup(feeds)
        return len(feeds)

    def cache_stats(self) -> Dict[str, Any]:
        """{'bucket_hits', 'bucket_misses', 'buckets': {key: count},
        'padding': true-vs-padded row/token counters, 'executable':
        executor executable-cache counters}.  In steady state
        bucket_misses and the executable miss count both stop moving.
        The padding block is the cost of that: every padded row / token
        is compute and memory spent on data nobody asked for."""
        out: Dict[str, Any] = dict(self._stats)
        out["buckets"] = dict(self._buckets)
        pad = dict(self._padding)
        pad["padded_row_fraction"] = round(
            1.0 - pad["true_rows"] / pad["padded_rows"], 4) \
            if pad["padded_rows"] else 0.0
        pad["padded_token_fraction"] = round(
            1.0 - pad["true_tokens"] / pad["padded_tokens"], 4) \
            if pad["padded_tokens"] else 0.0
        out["padding"] = pad
        out["quant"] = dict(self._quant_stats.to_dict(),
                            mode=self.quantize) \
            if self._quant_stats is not None else {"mode": self.quantize}
        out["executable"] = self.exe.cache_stats()["executable"]
        return out
