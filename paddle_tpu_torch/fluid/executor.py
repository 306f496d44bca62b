"""Places, Scope and Executor — the port of ``paddle_tpu/fluid/executor.py``.

``Executor.run(program, feed, fetch_list)`` runs one step of a block.
As in the reference, where the whole block is one jitted executable
cached per signature, a step is cached per signature ``(program
fingerprint, mode, feed shapes and dtypes, fetch names, state shapes and
dtypes)`` in an LRU of ``CACHE_CAPACITY`` entries, beside the structure
cache (the block's plan per program, feed names and fetch names); both
count hits, misses and evictions (``cache_stats()``).

On the card, the first ``run()`` at a signature (a miss) runs the step
eagerly through ``lowering.run_block_ops`` and then captures it in a
CUDA graph (``torch.cuda.CUDAGraph``): the port's counterpart of
``jax.jit`` for a fixed signature.  Every later ``run()`` at that
signature (a hit) copies the feeds and the step's seeds into the
graph's static buffers and replays it: one launch of the whole step in
place of one Python dispatch per op.  What the graph reads and writes
lives at fixed addresses:

* feeds, in static buffers the host copies into (pinned memory,
  asynchronous: no host sync);
* the step's random seeds, one int32 buffer (``lowering.step_seeds``);
* state: the scope's vars become the entry's own buffers after the
  capture.  A tensor in the scope becomes the buffer itself, as the
  reference donates its state buffers to the step: a serving pool sized
  to fill the card is held once, at one address, by every signature
  that steps it, and a caller who keeps a reference to a scope tensor
  sees every step's writes to it.  A SeqArray (and a value the step
  writes out of place) is copied into a buffer of the entry's own.  An
  op that updates in place (Adam, SGD, Momentum, the paged KV writes)
  writes the buffers; an op that writes out of place is followed by a
  copy back into the buffer.  A value written out of place that shares
  memory with a state or feed buffer (an ``assign`` of one persistable
  to another, as ModelAverage's apply and restore programs make) is
  copied first, so the var keeps its value when that buffer moves on.
  A var replaced in the scope (``set_var``,
  ``scope_from_numpy``) is copied in before the next replay; a scope
  that takes over a buffer from another first gives that one its own
  copy, so two scopes run through one executor keep their own state.
  A host value in the scope (a numpy array, as ``copy_weights``
  writes) is uploaded to the device at the step that reads it.  The
  eager first step's intermediates are dropped before the capture, so
  the peak holds one step's activations.  A first step that changes a
  state var's shape or dtype (the bf16 recipe's moving statistics,
  filled in bf16 by the startup program and float32 after the first
  ``batch_norm``) is neither captured nor cached: the scope has left its
  signature, and the next step misses and captures at the new one;
* fetches are the graph's outputs, copied out after each replay.

The launch counters of the kernels (``kernels.launch_counts``) count
what the capture recorded at every replay.  A step that syncs with the
host cannot be captured: the eager step runs under
``torch.cuda.set_sync_debug_mode("error")``, so a sync raises there,
naming its op.  A program that holds an op drawing on the host
(``host_rng``: ``uniform_random``, ``gaussian_random``, which startup
programs hold) runs eagerly at its first call and raises at its second
on the card: a replay would repeat the first draw.

Control flow (``ops/control_flow_ops.py``).  A captured CUDA graph
holds a fixed sequence of launches, so it cannot hold a trip count the
data decides.  A step whose loops all have static trip counts (a
``while`` with ``max_iters``, ``recurrent`` and ``dynamic_recurrent``
over the padded time axis, ``conditional_block`` as a device select)
is captured like any other: a training step with a ``DynamicRNN`` is
one graph replay after its first run.  A step holding a ``while``
without ``max_iters`` (a beam-search decode loop) runs eagerly on the
card at every call, its entry cached like any other (a hit a call after
the first, as the reference's executor counts it): the host drives the
loop and reads the condition once per iteration, the only host sync the
sync guard lets through (``control_flow_ops.read_condition``; a read
under capture raises).  Such a step never runs on the CPU in the card's
place.  Replaying the loop's body as a captured graph of its own per
signature is the lever to measure next.  Nothing else on the card runs
eagerly in a graph's place.

``Executor(CPUPlace())`` runs on the CPU, as the tests do, with the same
caches, buffers and copies, and the step run eagerly where the card
replays its graph.  ``Executor()`` and ``Executor(CUDAPlace(i))`` run on
the card and raise without one.  ``run_steps`` runs k steps at one
signature (on the card: the feeds staged on the device first, k
replays, one sync); ``run_pipeline`` runs a loader's feeds with fetches
drained every ``fetch_every`` steps.  ``scope_from_numpy`` /
``scope_to_numpy`` carry named arrays (a JAX scope, a checkpoint) in and
out of a Scope.  Feeds may be bfloat16 (``ml_dtypes`` arrays, as the
reference takes them); a fetched bfloat16 value comes back as an
``ml_dtypes`` bfloat16 array holding the same bits, as the reference's
does, where ``ml_dtypes`` imports, and as float32 (the same values)
where it does not (``ml_dtypes`` is not a dependency of the port).
Checkpoints never go through the fetch: ``io.py`` writes a scope's
tensors by their bits.

The persistent tier (``fluid/compile_cache.py``): ``Executor(
compile_cache=...)`` (None: the process default, ``PADDLE_TPU_AOT_CACHE``;
False: none) is consulted at each new signature.  A stored record of the
signature's plan, checked against the plan derived here, and the kernel
libraries it names, restored and loaded without ``nvcc``, make a hit; a
signature without a sound record, or a step that had to build a
library, is a miss, and its record and libraries are stored.  Either way
the step still runs eagerly once and is captured: a CUDA graph cannot
be stored.  ``cache_stats()["persistent"]`` counts hits, misses, stores,
the bytes the hits read and their load ms.

Guarded steps (``run(..., guard=GuardPolicy(...))``,
``resilience/guardrails.py``): a guarded signature is an entry of its
own whose body saves a pre-step copy of every state entry the step
writes, runs the ops, computes the finiteness sentinel over the loss,
the gradients and the updated parameters, and writes ``torch.where(flag,
new, pre)`` back in place; on the card all of it is the one captured
graph, and the host reads the flag once after the replay (under the
policy's watchdog thread, on the caller's stream, when it has a
``step_timeout``).  A bad step publishes no write-only persistable;
skip, rollback (a device snapshot every ``snapshot_every`` steps),
raise and escalation follow the reference, counted in
``health_stats()`` and the ``paddle_guardrail_events_total`` series.

Host IO ops (``save``, ``load``, ``save_combine``, ``load_combine``)
run on the host outside the step, as in the reference: those before the
block's first other op before it, those after its last op after it
(``BlockPlan.pre_host`` / ``post_host``); a block of host ops alone
captures nothing.  A loaded value replaces the scope's var
(``set_var``), so the next replay copies it into the graph's buffer.  A
program holding ``print`` runs eagerly at every step on the card and is
never captured: a CUDA graph cannot print, and the reference prints at
every step (``jax.debug.print``).  Each step runs inside
``profiler.record_event(f"executor_step/{mode}")``, host clock only.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import _build, add_launches, launch_counts, libraries_of
from ..utils.sync import RANK_LOADER, OrderedLock
from .core.lod import NestedSeqArray, SeqArray
from .core.selected_rows import SelectedRows
from .core.types import runtime_dtype, torch_dtype
from .framework import Program, Variable, default_main_program
from .lowering import (HOST_OPS, MARKER_OPS, BlockPlan, run_block_ops,
                       seed_tensor, step_seeds)
from .profiler import record_event

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "CPUPlace",
           "CUDAPlace", "scope_from_numpy", "scope_to_numpy", "CAPTURE_LOCK"]

# held while a step is captured in a CUDA graph: a thread that issues
# work on the card beside the executor (the DataLoader's prefetch) takes
# it, so no allocation or copy of another thread lands in a capture.
# The outermost rank: a capture runs the step's ops, which may load a
# kernel library (native.build) or record a profiler event, and no
# caller holds an ordered lock around a step's device work
CAPTURE_LOCK = OrderedLock("executor.capture", RANK_LOADER)


class CUDAPlace:
    """Device tag for one CUDA card (reference platform::CUDAPlace)."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    @property
    def device(self) -> str:
        return f"cuda:{self.device_id}"

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


class CPUPlace:
    def __init__(self):
        self.device_id = 0

    @property
    def device(self) -> str:
        return "cpu"

    def __repr__(self):
        return "CPUPlace()"


class Scope:
    """name -> tensor map with parent chaining (reference scope.h:38),
    plus the RNG state of the steps run in it."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self._rng_seed: Optional[int] = None
        self._rng_step: int = 0

    def var(self, name: str) -> str:
        self.vars.setdefault(name, None)
        return name

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return True
            s = s.parent
        return False

    def set_var(self, name: str, value) -> None:
        self.vars[name] = value

    def next_rng_bits(self, seed: Optional[int]) -> Tuple[int, int]:
        """(seed, step) of the next step: ``seed`` is the program's
        random_seed, else one drawn from the clock at the first step."""
        if self._rng_seed is None or (seed is not None
                                      and seed != self._rng_seed):
            self._rng_seed = (seed if seed is not None
                              else (time.time_ns() & 0x7FFFFFFF))
        self._rng_step += 1
        return self._rng_seed, self._rng_step


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old


def _place_device(place) -> torch.device:
    if place is None:
        return resolve_device(None)
    if isinstance(place, (CUDAPlace, CPUPlace)):
        return resolve_device(place.device)
    raise TypeError(f"Executor place must be CUDAPlace or CPUPlace, got "
                    f"{place!r}")


def _host_tensor(v) -> torch.Tensor:
    """A host value as a CPU tensor (a copy).  numpy has no bfloat16 of
    its own: an array of the ``ml_dtypes`` bfloat16 type (what a JAX
    program feeds) crosses as its 16-bit pattern, without importing
    ``ml_dtypes``."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(a)


def _on_host(v, device: torch.device) -> bool:
    """Whether a scope value is a host value to upload for a step on
    ``device``: a numpy array (a SeqArray or NestedSeqArray of them), or
    a CPU tensor when the step runs on the card."""
    parts = (_tensors(v) if isinstance(v, (torch.Tensor, SeqArray,
                                           NestedSeqArray)) else [v])
    return any(not isinstance(t, torch.Tensor)
               or (t.device.type == "cpu" and device.type != "cpu")
               for t in parts)


def _to_device(v, device: torch.device):
    """One host value as a device tensor; int64 and float64 narrow to
    int32 and float32 as in the reference's runtime.  Arrays are copied:
    the optimizer ops update scope tensors in place, and a read-only
    array (a JAX buffer) must not be written through.  A SeqArray
    (NestedSeqArray) moves as its data and its int32 lengths."""
    if isinstance(v, (SeqArray, NestedSeqArray)):
        return _like(v, [_to_device(t, device) for t in _tensors(v)])
    t = v if isinstance(v, torch.Tensor) else _host_tensor(v)
    return t.to(device=device, dtype=torch_dtype(runtime_dtype(t.dtype)))


def _bf16_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU bfloat16 tensor as numpy: an ``ml_dtypes`` bfloat16 array of
    the same bits (what the reference returns) where ``ml_dtypes``
    imports, else float32 holding the same values (numpy has no
    bfloat16 of its own)."""
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _to_numpy(t):
    """A scope value on the host: a numpy array of its own (a CPU
    tensor's is copied: the next step updates the tensor in place), or a
    SeqArray (NestedSeqArray) of numpy fields.  A bfloat16 value comes
    back by ``_bf16_numpy``."""
    if isinstance(t, (SeqArray, NestedSeqArray)):
        return _like(t, [_to_numpy(x) for x in _tensors(t)])
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    return _bf16_numpy(t) if t.dtype == torch.bfloat16 else t.numpy()


def scope_from_numpy(arrays: Mapping[str, Any], place=None,
                     scope: Optional[Scope] = None) -> Scope:
    """Put ``{name: array}`` into ``scope`` (a new Scope by default) as
    tensors on ``place``'s device (``None``: the card)."""
    device = _place_device(place)
    scope = Scope() if scope is None else scope
    for name, arr in arrays.items():
        scope.set_var(name, _to_device(np.asarray(arr), device))
    return scope


def scope_to_numpy(scope: Scope, names: Optional[Sequence[str]] = None
                   ) -> Dict[str, np.ndarray]:
    """The tensors of ``scope`` (all, or ``names``) as numpy arrays."""
    names = [n for n, v in scope.vars.items() if v is not None] \
        if names is None else names
    return {n: _to_numpy(scope.find_var(n)) for n in names}


def _feed_value(v):
    """One feed entry as a tensor of the runtime dtype (int64 and float64
    narrow to int32 and float32, as in the reference's runtime): a host
    value as a CPU tensor (a copy: the step must not write through a
    caller's array), a tensor where it lies.  A SeqArray
    (NestedSeqArray) keeps its structure, with int32 lengths."""
    if isinstance(v, (SeqArray, NestedSeqArray)):
        return _like(v, [_feed_value(t) for t in _tensors(v)])
    t = v if isinstance(v, torch.Tensor) else _host_tensor(v)
    return t.to(dtype=torch_dtype(runtime_dtype(t.dtype)))


def _sig_of(v) -> tuple:
    """Shape and dtype of a feed or state value (never its contents)."""
    if isinstance(v, SeqArray):
        return ("seq",) + tuple(v.data.shape) + (str(v.data.dtype),)
    if isinstance(v, NestedSeqArray):
        return ("nested",) + tuple(v.data.shape) + (str(v.data.dtype),)
    return tuple(v.shape) + (str(v.dtype),)


def _tensors(v) -> List[torch.Tensor]:
    """A value's tensors: a SeqArray's data and lengths, a
    NestedSeqArray's data and both lengths, a SelectedRows' (a sparse gradient) rows and values,
    else the tensor itself."""
    if isinstance(v, SeqArray):
        return [v.data, v.lengths]
    if isinstance(v, NestedSeqArray):
        return [v.data, v.outer_lengths, v.inner_lengths]
    if isinstance(v, SelectedRows):
        return [v.rows, v.values]
    return [v]


def _nbytes(values) -> int:
    """Bytes of every tensor the values hold."""
    return sum(t.numel() * t.element_size() for v in values
               for t in _tensors(v) if isinstance(t, torch.Tensor))


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or [])]


def _like(v, parts):
    """``parts`` (one per entry of ``_tensors(v)``) in ``v``'s structure."""
    if isinstance(v, (SeqArray, NestedSeqArray)):
        return type(v)(*parts)
    if isinstance(v, SelectedRows):
        return SelectedRows(*parts, v.height)
    return parts[0]


def _empty_like(v, device):
    return _like(v, [torch.empty(t.shape, dtype=t.dtype, device=device)
                     for t in _tensors(v)])


def _clone(v):
    return _like(v, [t.clone() for t in _tensors(v)])


def _owner_of(scope: Scope, name: str) -> Scope:
    """The scope in ``scope``'s parent chain that holds ``name``."""
    s: Optional[Scope] = scope
    while s is not None and name not in s.vars:
        s = s.parent
    return s if s is not None else scope


def _copy_into(dst, src) -> None:
    """``dst`` (a static buffer) takes ``src``'s values.  A host tensor
    goes through pinned memory, asynchronously: the host does not wait
    for the card, and the pinned block is not reused before the copy
    has read it (PyTorch's host allocator records the copy)."""
    for d, x in zip(_tensors(dst), _tensors(src)):
        if d.is_cuda and not x.is_cuda:
            x = x.pin_memory()
        d.copy_(x, non_blocking=True)


def _storages(values) -> set:
    """The addresses of the storages behind ``values``' tensors."""
    return {t.untyped_storage().data_ptr() for v in values
            for t in _tensors(v) if isinstance(t, torch.Tensor)}


def _own_outputs(plan: BlockPlan, env: Dict[str, Any], state, feeds
                 ) -> None:
    """Each state var the step writes out of place gets memory of its
    own where its value shares a state or feed buffer (an ``assign`` of
    one persistable to another returns its input, a ``reshape`` a view
    of it): the reference's values are immutable, and here the buffer
    is written after the step (a state var's copy-back, the next feed)
    or by the next step in place, which would change the var too."""
    held = None
    for n in plan.state_out:
        v = env[n]
        if v is state.get(n):
            continue
        if held is None:
            held = _storages(list(state.values()) + list(feeds.values()))
        if _storages([v]) & held:
            env[n] = _clone(v)


def _fetch_numpy(values) -> List[Any]:
    """Fetched values as numpy arrays of their own (SeqArrays and
    NestedSeqArrays of them), copied from the card through pinned
    memory, asynchronously, with one wait for all of them.  A fetched
    SelectedRows comes back as the reference's ``np.asarray`` gives it:
    a 0-d object array holding the SelectedRows (of numpy arrays
    here)."""
    host = []
    wait = None
    for v in values:
        outs = []
        for t in _tensors(v):
            t = t.detach()
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                wait = torch.cuda.current_stream(t.device)
                t = h
            else:
                t = t.clone()
            outs.append(t)
        host.append(outs)
    if wait is not None:
        wait.synchronize()
    out = [_like(v, [_bf16_numpy(t) if t.dtype == torch.bfloat16
                     else t.numpy() for t in o])
           for v, o in zip(values, host)]
    for i, v in enumerate(out):
        if isinstance(v, SelectedRows):
            out[i] = np.empty((), dtype=object)
            out[i][()] = v
    return out


class _Entry:
    """One signature's executable: its plan, its static buffers (feeds,
    the seed buffer, state), the CUDA graph captured over them (None on
    the CPU, or where a host-drawing op forbids one), and what the step
    produces (fetches; ``out`` the state vars it writes, by name)."""

    __slots__ = ("plan", "fetch_names", "mode", "feeds", "seeds",
                 "seeds_host", "state", "graph", "fetches", "out",
                 "launches", "guard")

    def __init__(self, plan: BlockPlan, fetch_names: List[str], mode: str):
        self.plan = plan
        self.fetch_names = fetch_names
        self.mode = mode
        self.feeds: Dict[str, Any] = {}
        self.seeds: Optional[torch.Tensor] = None
        self.seeds_host: List[int] = []
        self.state: Dict[str, Any] = {}
        self.graph = None
        self.fetches: List[Any] = []
        self.out: Dict[str, Any] = {}
        self.launches: Dict[tuple, int] = {}
        # a guarded signature's GuardedStep (resilience/guardrails.py):
        # its pre-step copies and health flag, run in the body
        self.guard = None


class Executor:
    """Executor with the reference's executable cache.  API mirrors
    fluid.Executor: ``run(program, feed, fetch_list, scope)`` -> list of
    numpy arrays."""

    # bound on the cached step signatures (each with its CUDA graph and
    # buffers on the card); LRU eviction, as in the reference
    CACHE_CAPACITY = 64

    def __init__(self, place: Union[CUDAPlace, CPUPlace, None] = None,
                 compile_cache=None):
        self.device = _place_device(place)
        # persistent tier (fluid/compile_cache.py): None = the process
        # default (PADDLE_TPU_AOT_CACHE / set_default_cache), False =
        # disabled, a CompileCache = exactly it (the gateway registry
        # mounts a per-version artifact cache)
        self._compile_cache = compile_cache
        self.place = place if place is not None else CUDAPlace(
            self.device.index or 0)
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # (program fp, feed names, fetch names) -> BlockPlan
        self._cls_cache: "OrderedDict[tuple, BlockPlan]" = OrderedDict()
        self._stats = {
            "executable": {"hits": 0, "misses": 0, "evictions": 0},
            "structure": {"hits": 0, "misses": 0, "evictions": 0},
            # the persistent tier's view from THIS executor: hits =
            # signatures whose record and kernel libraries loaded from
            # disk, misses = signatures resolved without them while a
            # cache was attached (a record not on disk, or a library
            # nvcc had to build: the "compiles"), stores = records
            # published back, bytes/load_ms = what the hits cost to read
            "persistent": {"hits": 0, "misses": 0, "stores": 0,
                           "bytes": 0, "load_ms": 0.0},
            # pre-flight analysis (validate=...): "runs" = analyses
            # performed, "cached" = steps that skipped re-analysis
            # because the (fingerprint, level) was already validated
            "validate": {"runs": 0, "cached": 0}}
        # the same counters by analysis level, and the (program
        # fingerprint, level) pairs already analyzed clean: the analyzer
        # runs once per program structure, not per step
        self._validate_by_level: Dict[str, Dict[str, int]] = {}
        self._validated: set = set()
        self._stream = None             # the capture stream, made once
        # every state buffer of this executor's entries (by id, weakly),
        # and the scope each one was last published to
        self._buffers: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
            weakref.WeakValueDictionary()
        self._holders: Dict[int, "weakref.ref[Scope]"] = {}
        # guardrail counters (health_stats()) and the per-(program,
        # scope) guard contexts: the rollback snapshot and the
        # consecutive-bad-step counter.  Keyed by program fingerprint
        # with the owning scope held weakly — a snapshot of program A's
        # state must never be republished into program B's scope
        self._health = {"guarded_steps": 0, "nonfinite_steps": 0,
                        "skips": 0, "rollbacks": 0, "escalations": 0,
                        "watchdog_fires": 0, "retries": 0}
        self._guard_ctxs: "OrderedDict[tuple, dict]" = OrderedDict()
        # (prog fp, fetch names, policy.check) -> sentinel check names
        self._guard_names: Dict[tuple, tuple] = {}
        # the counter dicts above stay the hot path's source of truth;
        # the metrics registry reads them at scrape time (this bound
        # method held weakly: a collected executor stops contributing)
        from ..observability.metrics import registry as _obs_registry

        _obs_registry().register_collector(self._collect_metrics)

    def _collect_metrics(self):
        """Scrape-time view of cache_stats() as the reference's labeled
        series; samples from every live executor sum into one rollup."""
        from ..observability.metrics import Sample

        for cache in ("executable", "structure"):
            st = self._stats[cache]
            for ev in ("hits", "misses", "evictions"):
                yield Sample(
                    "paddle_executor_cache_events_total", "counter",
                    (("cache", cache), ("event", ev)), float(st[ev]),
                    "Compiled-step / structure-classification cache events")
        for ev in ("hits", "misses", "stores"):
            yield Sample(
                "paddle_executor_cache_events_total", "counter",
                (("cache", "persistent"), ("event", ev)),
                float(self._stats["persistent"][ev]),
                "Compiled-step / structure-classification cache events")
        for cache, size in (("executable", len(self._cache)),
                            ("structure", len(self._cls_cache)),
                            ("validated", len(self._validated))):
            yield Sample("paddle_executor_cache_size", "gauge",
                         (("cache", cache),), float(size),
                         "Live entries per executor-side cache")
        for ev in ("runs", "cached"):
            yield Sample("paddle_executor_validate_total", "counter",
                         (("event", ev),),
                         float(self._stats["validate"][ev]),
                         "Static-analysis pre-flight runs vs fingerprint "
                         "cache hits")
        for ev, v in self._health.items():
            yield Sample("paddle_guardrail_events_total", "counter",
                         (("event", ev),), float(v),
                         "Guardrail sentinel/recovery counters "
                         "(health_stats)")

    def health_stats(self) -> Dict[str, int]:
        """Guardrail counters (see resilience/guardrails.py):
        guarded_steps (dispatches run under a GuardPolicy),
        nonfinite_steps (health flag came back False), skips /
        rollbacks / escalations (recovery actions taken),
        watchdog_fires (dispatch deadline expiries), retries
        (transient-fault re-dispatches).  Deltas over a training window
        are the divergence telemetry the reference never had."""
        return dict(self._health)

    # -- caches ---------------------------------------------------------------
    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Counters of the executable cache (step signatures, each a
        captured CUDA graph on the card), the structure cache (the
        block's plan per program, feed names and fetch names) and the
        persistent compile cache: ``{'executable': {hits, misses,
        evictions, size}, 'structure': {...}, 'persistent': {hits,
        misses, stores, bytes, load_ms[, cache]}, 'validate': {runs,
        cached, size, by_level}}``, the reference's blocks of the same
        names.  A hot training loop converges to pure hits."""
        out = {k: dict(v) for k, v in self._stats.items()}
        out["executable"]["size"] = len(self._cache)
        out["structure"]["size"] = len(self._cls_cache)
        out["persistent"]["load_ms"] = round(
            out["persistent"]["load_ms"], 3)
        aot = self._aot_cache()
        if aot is not None:
            # the attached directory's own view (shared with any other
            # executor mounting the same dir) rides along for /statusz
            out["persistent"]["cache"] = aot.stats()
        out["validate"]["size"] = len(self._validated)
        out["validate"]["by_level"] = {
            lv: dict(c) for lv, c in self._validate_by_level.items()}
        return out

    # -- static-analysis pre-flight -------------------------------------------
    @staticmethod
    def _validate_level(validate: Optional[str]) -> str:
        """The effective pre-flight level: the explicit argument, else the
        ``PADDLE_TPU_VALIDATE`` env flag (the reference's name), else
        off.  Any analysis level is accepted."""
        from .analysis import check_level

        level = (validate if validate is not None
                 else os.environ.get("PADDLE_TPU_VALIDATE", "off"))
        if level != "off":
            try:
                check_level(level)
            except ValueError:
                raise ValueError(f"validate must be 'off' or an analysis "
                                 f"level, got {level!r}") from None
        return level

    def _preflight(self, program: Program, level: str,
                   fetch_names: Sequence[str]) -> None:
        """Run the static analyzer once per (program fingerprint, level);
        raise ProgramValidationError on error-severity findings.  Later
        steps of the same program are fingerprint-cache hits."""
        key = (self._program_key(program), level)
        by_level = self._validate_by_level.setdefault(
            level, {"runs": 0, "cached": 0})
        if key in self._validated:
            self._stats["validate"]["cached"] += 1
            by_level["cached"] += 1
            return
        self._stats["validate"]["runs"] += 1
        by_level["runs"] += 1
        from .analysis import ProgramValidationError, analyze_program

        diag = analyze_program(program, level=level, fetch=fetch_names)
        if diag.has_errors:
            raise ProgramValidationError(diag,
                                         context=f"validate={level!r}")
        self._validated.add(key)

    # -- the persistent tier ----------------------------------------------------
    def set_compile_cache(self, cache) -> None:
        """Attach (or with False, disable; with None, defer to the
        process default) the persistent compile cache this executor
        consults at each new signature."""
        self._compile_cache = cache

    def _aot_cache(self):
        if self._compile_cache is False:
            return None
        if self._compile_cache is not None:
            return self._compile_cache
        from . import compile_cache as _cc

        return _cc.default_cache()

    def _persistent_key(self, aot, key) -> str:
        return aot.entry_key((key, ("device", self.device.type)))

    def _persistent_load(self, aot, key, plan: BlockPlan
                         ) -> Optional[Dict[str, Any]]:
        """The stored record of signature ``key`` when it is sound and
        matches ``plan``, with every kernel library it names loaded from
        disk (restored from the cache where not built yet); else None."""
        from .compile_cache import plan_record

        read0 = aot._stats["bytes_read"]
        t0 = time.perf_counter()
        record = aot.load(self._persistent_key(aot, key))
        if record is None or record.get("plan") != plan_record(plan) \
                or not aot.load_libraries(record.get("libraries", [])):
            return None
        pstats = self._stats["persistent"]
        pstats["bytes"] += aot._stats["bytes_read"] - read0
        pstats["load_ms"] += (time.perf_counter() - t0) * 1e3
        return record

    def _persistent_settle(self, aot, key, plan: BlockPlan, mode: str,
                           record, launched, builds: int) -> None:
        """After a new signature's first step: a hit when its record
        loaded and the step built no library that record lacks; else a
        miss (a compile), and the record and the libraries the step
        launched are stored."""
        from .compile_cache import _canon, plan_record

        libs = libraries_of(launched)
        pstats = self._stats["persistent"]
        if record is not None and builds == 0 \
                and set(libs) <= set(record.get("libraries", [])):
            pstats["hits"] += 1
            return
        pstats["misses"] += 1
        aot.store_libraries(libs)
        if aot.store(self._persistent_key(aot, key),
                     {"signature": _canon(key), "mode": mode,
                      "device": self.device.type,
                      "plan": plan_record(plan),
                      "libraries": list(libs)}):
            pstats["stores"] += 1

    def graphs(self) -> List[Any]:
        """The CUDA graphs of the cached steps, least recently used
        first (none on the CPU); ``raw_cuda_graph()`` gives each one's
        nodes."""
        return [e.graph for e in self._cache.values()
                if e.graph is not None]

    def close(self) -> None:
        """Drop the cached steps (and their graphs) and plans; the
        counters keep their history."""
        self._cache.clear()
        self._cls_cache.clear()

    @staticmethod
    def _program_key(program: Program) -> str:
        """Content key: the desc's fingerprint, recomputed only when the
        program's mutation version changes."""
        cached = getattr(program, "_fp_cache", None)
        if cached is not None and cached[0] == program.version:
            return cached[1]
        fp = program.desc.fingerprint()
        program._fp_cache = (program.version, fp)
        return fp

    def _plan(self, prog_fp: str, program: Program, feed_names,
              fetch_names) -> BlockPlan:
        key = (prog_fp, tuple(sorted(feed_names)), tuple(fetch_names))
        plan = self._cls_cache.get(key)
        if plan is not None:
            self._cls_cache.move_to_end(key)
            self._stats["structure"]["hits"] += 1
            return plan
        self._stats["structure"]["misses"] += 1
        plan = BlockPlan(program.desc.global_block(), feed_names,
                         fetch_names, program=program.desc)
        self._cls_cache[key] = plan
        while len(self._cls_cache) > self.CACHE_CAPACITY:
            self._cls_cache.popitem(last=False)
            self._stats["structure"]["evictions"] += 1
        return plan

    def _lookup(self, key) -> Optional[_Entry]:
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            self._stats["executable"]["hits"] += 1
        else:
            self._stats["executable"]["misses"] += 1
        return entry

    def _store(self, key, entry: _Entry) -> None:
        self._cache[key] = entry
        evicted = False
        while len(self._cache) > self.CACHE_CAPACITY:
            self._cache.popitem(last=False)
            self._stats["executable"]["evictions"] += 1
            evicted = True
        if evicted:
            self._holders = {i: h for i, h in self._holders.items()
                             if i in self._buffers}

    def _state_of(self, plan: BlockPlan, scope: Scope) -> Dict[str, Any]:
        state = {}
        for n in plan.state_in:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"Executor: variable {n!r} is read by the program but "
                    f"absent from the scope — did you run the startup "
                    f"program?")
            if _on_host(v, self.device):
                # a host value (as the reference's jit takes numpy state;
                # a loaded checkpoint's values): uploaded once, and the
                # scope that holds it keeps the device tensor
                v = _to_device(v, self.device)
                _owner_of(scope, n).set_var(n, v)
            dev = (v.data.device
                   if isinstance(v, (SeqArray, NestedSeqArray))
                   else v.device)
            if dev != self.device:
                raise ValueError(f"Executor: scope variable {n!r} is on "
                                 f"{dev}, the executor runs on "
                                 f"{self.device}")
            state[n] = v
        return state

    def _prepare(self, program, feed, fetch_list, scope, mode):
        """-> (the signature, the plan, the state values, the fetch
        names)."""
        fetch_names = _fetch_names(fetch_list)
        prog_fp = self._program_key(program)
        plan = self._plan(prog_fp, program, list(feed), fetch_names)
        for op in plan.pre_host:
            _run_host_op(op, scope)
        state = self._state_of(plan, scope)
        key = (prog_fp, mode,
               tuple((n, _sig_of(v)) for n, v in sorted(feed.items())),
               tuple(fetch_names),
               tuple((n, _sig_of(v)) for n, v in sorted(state.items())))
        return key, plan, state, fetch_names

    # -- one step ---------------------------------------------------------------
    def _capture_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _body(self, entry: _Entry) -> None:
        """The step over the entry's buffers: what the graph captures,
        and what the CPU runs in its place.  Out-of-place state results
        are copied back into the state buffers."""
        plan = entry.plan
        env = dict(entry.state)
        env.update(entry.feeds)
        guard = entry.guard
        with torch.no_grad():
            if guard is not None:
                guard.save(entry.state)
            run_block_ops(plan, env, entry.seeds_host, entry.seeds,
                          self.device, entry.mode)
            _own_outputs(plan, env, entry.state, entry.feeds)
            if guard is not None:
                guard.gate(env)
            for n in plan.state_out:
                if n in entry.state and env[n] is not entry.state[n]:
                    for d, x in zip(_tensors(entry.state[n]),
                                    _tensors(env[n])):
                        d.copy_(x)
        entry.out = {n: entry.state.get(n, env[n]) for n in plan.state_out}
        entry.fetches = [env[n] for n in entry.fetch_names]

    def _first_step(self, plan, fetch_names, mode, feed, state, seeds,
                    scope, guard=None
                    ) -> Tuple[Optional[_Entry], List[Any], bool]:
        """A miss: run the step eagerly on the scope's tensors, then give
        the entry its buffers and, on the card, capture the graph.
        Returns the entry (None for a step that moved its own state to
        another signature), the eager step's fetches and its health
        (True unguarded).  With ``guard`` (a GuardedStep) the step saves
        its pre-step copies first and gates its state after the ops, as
        every replay of the captured body does; a step whose flag comes
        back False publishes no write-only persistable."""
        from ..resilience import guardrails as gr

        entry = _Entry(plan, fetch_names, mode)
        dev = self.device
        entry.feeds = {n: _empty_like(v, dev) for n, v in feed.items()}
        entry.seeds = torch.empty(len(plan.salts), dtype=torch.int32,
                                  device=dev)
        self._load(entry, feed, seeds)
        env = dict(state)
        env.update(entry.feeds)
        # a host sync would break the capture: raise at it, naming its op
        # (a host draw copies to the card, and is never captured)
        no_sync = (_sync_errors() if dev.type == "cuda"
                   and not plan.host_rng_ops else contextlib.nullcontext())
        if guard is not None:
            guard.save(state)
            gr.mark_launched(state)
        with torch.no_grad(), no_sync:
            run_block_ops(plan, env, seeds, entry.seeds, dev, mode)
            _own_outputs(plan, env, state, entry.feeds)
            if guard is not None:
                guard.gate(env)
        healthy = True
        if guard is not None:
            healthy = guard.read()
            gr.mark_launched(state, False)
        for n in plan.state_out:
            if healthy or n in state:
                scope.set_var(n, env[n])
        # a fed value is the feed buffer, which the next step overwrites,
        # and a state value the buffer the next step updates
        fetches = [_clone(env[n]) if n in feed or n in state else env[n]
                   for n in fetch_names]
        if any(_sig_of(env[n]) != _sig_of(state[n])
               for n in plan.state_out if n in state):
            # the step changed a state var's shape or dtype (the bf16
            # recipe's moving statistics: bf16 from the startup program,
            # float32 after a batch_norm step), so the scope has left
            # this signature and no later step can replay it: neither
            # captured nor cached
            return None, fetches, healthy
        # the state buffers: the scope's tensors where the step read them
        # or wrote them in place, else the entry's own copies
        for n, v in state.items():
            new = env[n] if n in plan.state_out else v
            entry.state[n] = new if new is v and isinstance(
                v, torch.Tensor) else _clone(new)
            if isinstance(entry.state[n], torch.Tensor):
                self._buffers[id(entry.state[n])] = entry.state[n]
        # the eager step's intermediates go before the capture makes its
        # own, so the peak holds one step's activations, not two
        del env
        entry.guard = guard
        if dev.type == "cuda" and not plan.host_rng_ops \
                and not plan.host_loops and not plan.prints:
            self._capture(entry)
        self._publish(entry, scope, out=False)
        return entry, fetches, healthy

    def _capture(self, entry: _Entry) -> None:
        before = launch_counts()
        # the graph itself is kept beside its instantiation, so its nodes
        # can be read (``graphs()``)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with CAPTURE_LOCK, torch.cuda.graph(
                    graph, stream=self._capture_stream()):
                self._body(entry)
            graph.instantiate()
        except Exception as e:
            e.add_note("Executor: capturing the step in a CUDA graph "
                       "failed; the step is not run eagerly in its place")
            raise
        after = launch_counts()
        # the capture recorded launches and ran none: they count at each
        # replay instead
        entry.launches = {k: after[k] - before.get(k, 0) for k in after
                          if after[k] != before.get(k, 0)}
        add_launches({k: -n for k, n in entry.launches.items()})
        entry.graph = graph

    def _publish(self, entry: _Entry, scope: Scope, out: bool = True,
                 healthy: bool = True) -> None:
        """After a step: the scope's vars are the entry's buffers (a
        state var the step only reads, where the scope itself holds it).
        With ``out``, the state vars the step wrote too (a var the block
        writes and never reads as a copy; not after a guarded step whose
        flag came back False: such a var has no pre-step twin to gate);
        the eager first step has set those already."""
        if out:
            for n, v in entry.out.items():
                if n in entry.state:
                    scope.set_var(n, v)
                elif healthy:
                    scope.set_var(n, _clone(v))
        held = weakref.ref(scope)
        for n, v in entry.state.items():
            if n in scope.vars:
                scope.set_var(n, v)
            self._holders[id(v)] = held

    @staticmethod
    def _load(entry: _Entry, feed, seeds) -> None:
        for n, v in feed.items():
            _copy_into(entry.feeds[n], v)
        entry.seeds_host = seeds
        _copy_into(entry.seeds, seed_tensor(seeds))

    def _bind(self, entry: _Entry, state, scope: Scope) -> None:
        """Before a replay: each state buffer holds the scope's value.  A
        var the scope replaced is copied in; if another scope holds the
        buffer, it keeps a copy of its own first."""
        for n, buf in entry.state.items():
            v = state[n]
            if v is buf:
                continue
            ref = self._holders.get(id(buf))
            holder = ref() if ref is not None else None
            if holder is not None and holder is not scope \
                    and holder.vars.get(n) is buf:
                holder.set_var(n, _clone(buf))
            _copy_into(buf, v)

    def _replay(self, entry: _Entry, state, scope: Scope) -> List[Any]:
        """A hit: the entry's step on its buffers (the graph on the
        card).  Returns the fetches, copied out of the buffers."""
        self._check_replayable(entry)
        self._bind(entry, state, scope)
        self._launch(entry)
        self._publish(entry, scope)
        return [_clone(f) for f in entry.fetches]

    def _check_replayable(self, entry: _Entry) -> None:
        if entry.plan.host_rng_ops and self.device.type == "cuda":
            raise NotImplementedError(
                f"Executor: this program holds "
                f"{', '.join(sorted(set(entry.plan.host_rng_ops)))}, which "
                f"draws on the host: a replay would repeat its first draw. "
                f"Run such a program (a startup program) once per "
                f"executor on the card, or on CPUPlace")

    def _launch(self, entry: _Entry) -> None:
        """The entry's step on its bound buffers: one graph replay on the
        card, the body eagerly where there is no graph."""
        if entry.graph is not None:
            if entry.guard is not None:
                # a replay's pre-step copies are never known complete
                # from the host (GuardedStep.restore)
                entry.guard.saved = False
            entry.graph.replay()
            add_launches(entry.launches)
        elif self.device.type == "cuda":
            # a step whose loop the host drives, or that prints: eager on
            # the card, and still no host sync but the loops' condition
            # reads and the prints
            with _sync_errors():
                self._body(entry)
        else:
            self._body(entry)

    def _step(self, program, feed, fetch_list, scope, mode,
              policy=None) -> List[Any]:
        """One step at the feeds' signature: a miss runs it eagerly and
        caches it (captured, on the card), a hit replays it.  With
        ``policy`` (a GuardPolicy) the step is guarded
        (``_run_guarded``), at a signature of its own."""
        key, plan, state, fetch_names = self._prepare(
            program, feed, fetch_list, scope, mode)
        if not plan.ops and not fetch_names:
            for op in plan.post_host:
                _run_host_op(op, scope)
            return []
        seeds = step_seeds(plan, *scope.next_rng_bits(program.random_seed))
        if policy is not None:
            fetches = self._run_guarded(program, key, plan, state,
                                        fetch_names, feed, seeds, scope,
                                        mode, policy)
        else:
            entry = self._lookup(key)
            if entry is None:
                entry, fetches, _ = self._miss(key, plan, fetch_names, mode,
                                               feed, state, seeds, scope)
            else:
                self._load(entry, feed, seeds)
                fetches = self._replay(entry, state, scope)
        for op in plan.post_host:
            _run_host_op(op, scope)
        return fetches

    def _miss(self, key, plan, fetch_names, mode, feed, state, seeds, scope,
              guard=None):
        """A new signature: its first step (``_first_step``), the
        persistent tier consulted before it and settled after it, and
        the entry cached.  -> (entry, fetches, healthy)."""
        aot = self._aot_cache()
        record = None if aot is None else \
            self._persistent_load(aot, key, plan)
        before = launch_counts()
        builds = _build.stats["nvcc_builds"]
        entry, fetches, healthy = self._first_step(
            plan, fetch_names, mode, feed, state, seeds, scope, guard)
        if aot is not None:
            after = launch_counts()
            self._persistent_settle(
                aot, key, plan, mode, record,
                {k: n - before.get(k, 0) for k, n in after.items()},
                _build.stats["nvcc_builds"] - builds)
        if entry is not None:
            self._store(key, entry)
        return entry, fetches, healthy

    # -- guardrails ----------------------------------------------------------
    def _guard_check_names(self, prog_fp: str, policy, program: Program,
                           plan: BlockPlan, fetch_names) -> tuple:
        """The sentinel's check set for this (program, fetch,
        policy.check) — cached, since re-walking every parameter per
        step is the hot-loop Python cost the plan cache exists to avoid.
        'loss' = the fetches (non-floats are skipped by the sentinel),
        'grads' = each parameter's @GRAD the step writes, 'params' = the
        post-update parameters.  Parameters are identified on the
        FRAMEWORK block (the desc block's VarDescs don't record
        parameter-ness)."""
        key = (prog_fp, tuple(fetch_names), policy.check)
        cached = self._guard_names.get(key)
        if cached is not None:
            return cached
        from .core.registry import grad_var_name
        from .framework import Parameter

        names: List[str] = []
        want = set(policy.check)
        if "loss" in want:
            names.extend(fetch_names)
        params = [n for n, v in program.global_block().vars.items()
                  if isinstance(v, Parameter)]
        if "grads" in want:
            written = {n for op in plan.ops for n in op.output_names() if n}
            names.extend(g for g in (grad_var_name(p) for p in params)
                         if g in written)
        if "params" in want:
            pset = set(params)
            names.extend(n for n in plan.state_out if n in pset)
        out = tuple(dict.fromkeys(names))
        self._guard_names[key] = out
        return out

    def _guard_ctx_for(self, prog_fp: str, scope: Scope) -> dict:
        """The guard context (rollback snapshot + escalation counter) for
        this (program, scope) pairing — rollback must republish values
        that came from THIS scope's run of THIS program, and alternating
        scopes must each keep their own escalation counter.  The scope
        is held weakly and verified by identity (an id() reused after GC
        must not inherit a stale snapshot).  LRU-bounded like the step
        cache: an evicted context drops its snapshot instead of pinning
        device memory for programs that will never run again."""
        key = (prog_fp, id(scope))
        ctx = self._guard_ctxs.get(key)
        if ctx is None or ctx["scope"]() is not scope:
            ctx = {"scope": weakref.ref(scope), "snapshot": None,
                   "since_snapshot": 0, "consecutive_bad": 0}
            self._guard_ctxs[key] = ctx
        else:
            self._guard_ctxs.move_to_end(key)
        while len(self._guard_ctxs) > self.CACHE_CAPACITY:
            self._guard_ctxs.popitem(last=False)
        while len(self._guard_names) > self.CACHE_CAPACITY:
            self._guard_names.pop(next(iter(self._guard_names)))
        return ctx

    def _run_guarded(self, program, key, plan, state, fetch_names, feed,
                     seeds, scope, mode, policy) -> List[Any]:
        """One guarded step: chaos points -> rollback snapshot upkeep ->
        watchdog/retry dispatch (the step with its sentinel and gated
        publish, then the flag's one host read) -> recovery accounting.
        Returns the fetches; raises NonFiniteError / NonFiniteEscalation
        with the (pre-step) state already in the scope.  A StepFault /
        StepTimeout escape republishes the last-good snapshot into the
        scope when one exists (rollback policy); without one the scope
        keeps whatever the failed dispatch left (pair step_timeout with
        on_nonfinite="rollback" when the scope must survive a wedged
        device)."""
        from ..observability.tracing import tracer as _obs_tracer
        from ..resilience import guardrails as gr
        from ..resilience.chaos import injector

        prog_fp = key[0]
        check = self._guard_check_names(prog_fp, policy, program, plan,
                                        fetch_names)
        key = key + (("guard",) + check,)
        tr = _obs_tracer()
        inj = injector()
        if inj.enabled():
            feed = gr.poison_feed(feed, inj)
        gctx = self._guard_ctx_for(prog_fp, scope)
        if policy.on_nonfinite == "rollback" and (
                gctx["snapshot"] is None
                or gctx["since_snapshot"] >= policy.snapshot_every):
            # pre-step state is always last-good (bad steps publish the
            # gated pre-step values), so snapshotting before dispatch is
            # safe at any cadence
            gctx["snapshot"] = gr.device_snapshot(state)
            gctx["since_snapshot"] = 0
        found = self._lookup(key)
        cuda = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if cuda else None
        if found is not None:
            self._check_replayable(found)

        def dispatch(ctl):
            if inj.enabled():
                inj.maybe_fail("guard.fault")
                inj.maybe_hang("guard.hang")
            if not ctl.begin_consume():
                # the watchdog abandoned this attempt while it stalled
                # host-side; a retry may already be running on the same
                # state — do not touch the device (the claim is atomic
                # with the monitor's cancel)
                raise gr.StepFault("dispatch abandoned after watchdog "
                                   "timeout")
            entry = found
            guard = entry.guard if entry is not None else \
                gr.build_guarded_step_fn(state_in=plan.state_in,
                                         state_out=plan.state_out,
                                         check_names=check)
            target = entry.state if entry is not None else state
            if cuda:
                # the watchdog's worker thread: the executor's device,
                # and the caller's stream, which the feeds were copied on
                torch.cuda.set_device(self.device)
            try:
                with (torch.cuda.stream(stream) if cuda
                      else contextlib.nullcontext()):
                    if entry is None:
                        _, fetches, healthy = self._miss(
                            key, plan, fetch_names, mode, feed, state,
                            seeds, scope, guard)
                        return fetches, healthy
                    self._load(entry, feed, seeds)
                    self._bind(entry, state, scope)
                    gr.mark_launched(target)
                    self._launch(entry)
                    # the flag materialises here, INSIDE the watchdog
                    # deadline — a hung replay blocks on this read
                    healthy = guard.read()
                    gr.mark_launched(target, False)
                    self._publish(entry, scope, healthy=healthy)
                    return [_clone(f) for f in entry.fetches], healthy
            except Exception:
                # a fault after the launch is only re-dispatchable once
                # the state is exactly pre-step again: the guard's
                # complete pre-step copies put back
                if not gr.state_buffers_live(target) \
                        and guard.restore(target):
                    gr.mark_launched(target, False)
                if gr.state_buffers_live(target):
                    ctl.unconsume()
                raise

        try:
            fetches, healthy = gr.dispatch_guarded(dispatch, policy,
                                                   self._health)
        except gr.StepFault:
            # the failed/hung dispatch may have left a partly written
            # state; with a rollback policy we hold a last-good snapshot
            # no step writes — republish it so the scope is whole for
            # whoever catches this
            if gctx["snapshot"] is not None:
                for n, v in gr.device_snapshot(gctx["snapshot"]).items():
                    scope.set_var(n, v)
                gctx["since_snapshot"] = 0
                tr.instant("guard/fault_rollback", cat="guard")
            raise
        self._health["guarded_steps"] += 1
        gctx["since_snapshot"] += 1
        if healthy:
            gctx["consecutive_bad"] = 0
            return fetches
        self._health["nonfinite_steps"] += 1
        gctx["consecutive_bad"] += 1
        escalate = (policy.escalate_after > 0
                    and gctx["consecutive_bad"] >= policy.escalate_after)
        tr.instant("guard/nonfinite_step", cat="guard",
                   consecutive=gctx["consecutive_bad"])
        if escalate:
            tr.instant("guard/escalation", cat="guard")
            self._health["escalations"] += 1
            gctx["consecutive_bad"] = 0
            gctx["snapshot"] = None     # the restorer will change the scope
            raise gr.NonFiniteEscalation(
                f"{policy.escalate_after} consecutive non-finite steps "
                f"under on_nonfinite={policy.on_nonfinite!r}; escalate to "
                f"checkpoint restore")
        if policy.on_nonfinite == "raise":
            raise gr.NonFiniteError(
                "guarded step produced non-finite values (loss/grad/param "
                "sentinel); scope holds the pre-step state")
        if policy.on_nonfinite == "rollback":
            tr.instant("guard/rollback", cat="guard")
            self._health["rollbacks"] += 1
            # publish COPIES: the snapshot itself must survive the steps
            # that write whatever sits in the scope
            for n, v in gr.device_snapshot(gctx["snapshot"]).items():
                scope.set_var(n, v)
            gctx["since_snapshot"] = 0  # scope now equals the snapshot
        else:                           # "skip": gated state IS pre-step
            tr.instant("guard/skip", cat="guard")
            self._health["skips"] += 1
        return fetches

    # -- entry points -------------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            mode: str = "train", validate: Optional[str] = None,
            guard=None) -> List[Any]:
        """One step of ``program``'s global block.  ``mode="infer"``
        turns dropout off.  ``validate``: the static-analysis pre-flight
        — "off" (the default), "structural" (desc-only passes), "full"
        (adds the shape/dtype re-check) or "cost"; without it the
        ``PADDLE_TPU_VALIDATE`` env flag decides.  The analysis is cached
        by program fingerprint, so a hot loop pays it once, and it
        changes nothing the step computes.

        ``guard``: a ``resilience.GuardPolicy`` (or an ``on_nonfinite``
        string shorthand) enabling the training guardrails: the step
        runs with a finiteness sentinel over loss/grads/params and a
        gated publish of the state it writes, both in its body (so in
        its one graph replay on the card), and the host reads the one
        health flag after it; non-finite steps are raised/skipped/
        rolled back per the policy with the scope never holding a
        corrupted update, and the dispatch runs under the policy's
        watchdog deadline + transient-fault retry.  Counters:
        ``health_stats()``.  Guarded steps are bitwise-identical to
        unguarded ones on healthy batches."""
        policy = None
        if guard is not None:
            from ..resilience.guardrails import GuardPolicy

            policy = (guard if isinstance(guard, GuardPolicy)
                      else GuardPolicy(on_nonfinite=str(guard)))
        program = program or default_main_program()
        scope = scope or global_scope()
        level = self._validate_level(validate)
        if level != "off":
            self._preflight(program, level, _fetch_names(fetch_list))
        feed = {k: _feed_value(v) for k, v in (feed or {}).items()}
        with record_event(f"executor_step/{mode}"):
            fetches = self._step(program, feed, fetch_list, scope, mode,
                                 policy)
        return _fetch_numpy(fetches) if return_numpy else fetches

    def run_steps(self, program: Optional[Program] = None,
                  feeds: Optional[Sequence[Dict[str, Any]]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True,
                  mode: str = "train") -> List[List[Any]]:
        """Run ``len(feeds)`` steps at one signature: the same steps, in
        the same order, with the scope's rng advanced exactly as that
        many ``run()`` calls would advance it, and every step's fetches
        returned (a list over steps of fetch lists).  On the card all
        the feeds go to the device first, then each step is one graph
        replay, and the host waits once, at the end.  All feeds must
        share one signature (bucket padded sequences)."""
        feeds = list(feeds or [])
        if not feeds:
            return []
        program = program or default_main_program()
        scope = scope or global_scope()
        level = self._validate_level(None)
        if level != "off":          # PADDLE_TPU_VALIDATE covers these too
            self._preflight(program, level, _fetch_names(fetch_list))
        feeds = [{k: _feed_value(v) for k, v in f.items()} for f in feeds]
        sig0 = tuple((n, _sig_of(v)) for n, v in sorted(feeds[0].items()))
        for i, f in enumerate(feeds[1:], 1):
            sig = tuple((n, _sig_of(v)) for n, v in sorted(f.items()))
            if sig != sig0:
                raise ValueError(
                    f"run_steps feed #{i} signature differs from feed #0 "
                    f"— every step in one dispatch must share a compiled "
                    f"shape (bucket sequence lengths / fix the batch "
                    f"size): {sig} != {sig0}")
        staged = [{n: _staged(v, self.device) for n, v in f.items()}
                  for f in feeds]
        out = [self._step(program, f, fetch_list, scope, mode)
               for f in staged]
        if not return_numpy:
            return out
        flat = _fetch_numpy([f for row in out for f in row])
        n = len(out[0]) if out else 0
        return [flat[i * n:(i + 1) * n] for i in range(len(out))]

    def run_pipeline(self, program: Optional[Program] = None,
                     loader=None,
                     fetch_list: Optional[Sequence] = None,
                     scope: Optional[Scope] = None,
                     fetch_every: int = 8, return_numpy: bool = True,
                     mode: str = "train", on_fetch=None,
                     guard=None) -> Union[List[Any], int]:
        """Run every feed dict of ``loader`` (an iterable such as a
        ``fluid.DataLoader``, or a zero-arg callable returning one)
        through ``run()`` without waiting for each step's fetches: they
        stay on the device and are drained every ``fetch_every`` steps,
        so the host queues steps ahead of the card.  The steps are
        ``run()``'s, so the results equal the synchronous loop's
        bitwise.  Returns the per-step fetch lists or, with
        ``on_fetch(outs)``, streams each step's fetches to it and returns
        the step count.  A fetched state value (a persistable, or a var
        the block does not write) is drained at once, every step, as the
        reference does.  ``guard`` (a GuardPolicy) threads through to each
        step's run(); the health flag is read per step, so a guarded
        pipeline trades the deferred-fetch overlap for the sentinel."""
        if loader is None:
            raise ValueError("run_pipeline needs a loader (an iterable of "
                             "feed dicts)")
        if callable(loader) and not hasattr(loader, "__iter__"):
            loader = loader()
        fetch_every = max(1, int(fetch_every))
        blk = (program or default_main_program()).desc.global_block()
        written = {n for op in blk.ops
                   if op.type not in MARKER_OPS and op.type not in HOST_OPS
                   for n in op.output_names() if n}
        force_numpy = False
        for f in (fetch_list or []):
            n = f.name if isinstance(f, Variable) else str(f)
            if n not in written or (n in blk.vars
                                    and blk.vars[n].persistable):
                fetch_every, force_numpy = 1, True
                break
        pending: List[List[Any]] = []
        results: List[Any] = []
        n_steps = 0

        def drain():
            if not pending:
                return
            flat = [f for outs in pending for f in outs]
            if return_numpy or force_numpy:
                flat = _fetch_numpy(flat)
            elif self.device.type == "cuda":
                # still a wait: it bounds the steps in flight
                torch.cuda.current_stream(self.device).synchronize()
            n = len(flat) // len(pending)
            for i in range(len(pending)):
                outs = flat[i * n:(i + 1) * n]
                if on_fetch is not None:
                    on_fetch(outs)
                else:
                    results.append(outs)
            pending.clear()

        try:
            for feed in loader:
                pending.append(self.run(program, feed=feed,
                                        fetch_list=fetch_list, scope=scope,
                                        return_numpy=False, mode=mode,
                                        guard=guard))
                n_steps += 1
                if len(pending) >= fetch_every:
                    drain()
        except BaseException:
            # deliver the fetches of the steps that ran, but never let
            # that mask the loader's error
            try:
                drain()
            except Exception:
                pass
            raise
        drain()
        return n_steps if on_fetch is not None else results

    # -- analysis of one step ------------------------------------------------
    def cost_analysis(self, program: Optional[Program] = None,
                      feed: Optional[Dict[str, Any]] = None,
                      fetch_list: Optional[Sequence] = None,
                      scope: Optional[Scope] = None,
                      mode: str = "train") -> Dict[str, float]:
        """Totals of one step's per-op cost table
        (``profiler.op_cost_table``: every op run alone on meta tensors,
        products counted by ``FlopCounterMode``), WITHOUT executing the
        step: ``{'flops', 'bytes accessed'}``, the reference's keys for
        its XLA cost analysis of the compiled step.  ``fetch_list`` is
        accepted for the reference's signature; the table covers every
        op of the block."""
        from .profiler import op_cost_table

        rows = op_cost_table(program, feed, scope, mode, print_table=False)
        return {"flops": float(sum(r["flops"] for r in rows)),
                "bytes accessed": float(sum(r["bytes"] for r in rows))}

    def _analysis_step(self, program, feed, fetch_list, scope):
        """(program, feeds on the device, fetch names, plan, a copy of
        the state the step reads): what ``memory_analysis`` and
        ``device_time_per_step`` run, without touching the scope's values
        or its rng."""
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = {k: _staged(_feed_value(v), self.device)
                for k, v in (feed or {}).items()}
        fetch_names = _fetch_names(fetch_list)
        plan = BlockPlan(program.desc.global_block(), list(feed),
                         fetch_names, program=program.desc)
        state = {n: _clone(v) for n, v in self._state_of(plan,
                                                          scope).items()}
        return program, feed, fetch_names, plan, state

    def memory_analysis(self, program: Optional[Program] = None,
                        feed: Optional[Dict[str, Any]] = None,
                        fetch_list: Optional[Sequence] = None,
                        scope: Optional[Scope] = None,
                        mode: str = "train") -> Dict[str, float]:
        """The measured memory of one step at this signature, the
        counterpart of the static planner's peak
        (``analysis.cost.plan_program``).

        This is a measurement, not a compiler's static figure (the
        reference reads XLA's buffer assignment): the step runs once,
        eagerly, on a copy of the state it reads (the scope keeps its
        values and its rng; fixed seeds), and ``temp_bytes`` is the
        caching allocator's peak over that run above what was allocated
        before it.  The reference's keys: ``argument_bytes`` (feeds +
        the state read), ``output_bytes`` (fetches + the state written),
        ``alias_bytes`` (outputs written in place into an argument's
        memory), ``temp_bytes``, ``generated_code_bytes`` (0: no code is
        generated) and ``peak_bytes`` = arguments + temps, the step's
        own allocations over its resident arguments.  On the CPU no
        allocator keeps a peak: ``temp_bytes`` and ``peak_bytes`` are
        NaN there."""
        program, feed, fetch_names, plan, state = self._analysis_step(
            program, feed, fetch_list, scope)
        dev = self.device
        cuda = dev.type == "cuda"
        seeds = [0] * len(plan.salts)
        env = dict(state)
        env.update(feed)
        argument_bytes = _nbytes(env.values())
        held = _storages(env.values())
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            run_block_ops(plan, env, seeds,
                          seed_tensor(seeds).to(dev), dev, mode)
        temp = float("nan")
        if cuda:
            torch.cuda.synchronize(dev)
            temp = float(torch.cuda.max_memory_allocated(dev) - base)
        outs = [env[n] for n in list(plan.state_out) + fetch_names]
        output_bytes = _nbytes(outs)
        alias_bytes = sum(_nbytes([v]) for v in outs
                          if _storages([v]) & held)
        return {"argument_bytes": float(argument_bytes),
                "output_bytes": float(output_bytes),
                "temp_bytes": temp,
                "alias_bytes": float(alias_bytes),
                "generated_code_bytes": 0.0,
                "peak_bytes": float(argument_bytes) + temp}

    def device_time_per_step(self, program: Optional[Program] = None,
                             feed: Optional[Dict[str, Any]] = None,
                             fetch_list: Optional[Sequence] = None,
                             scope: Optional[Scope] = None,
                             iters: int = 50, trials: int = 3,
                             mode: str = "train") -> float:
        """Seconds per step on the device clock: the step is captured
        once (a fresh executor's first run, on a copy of the state it
        reads: the scope is NOT updated), then each trial replays its
        CUDA graph ``iters`` times between two CUDA events; the median
        over ``trials`` is returned.  No host work sits between the
        replays, so this is the card's time for the step, the
        counterpart of the reference's chained steps in one jit.  On the
        CPU (or for a step the executor does not capture) each trial
        runs ``iters`` steps on the host clock."""
        program, feed, fetch_names, plan, state = self._analysis_step(
            program, feed, fetch_list, scope)
        scratch = Scope()
        for n, v in state.items():
            scratch.set_var(n, v)
        exe = Executor(self.place)
        exe.run(program, feed, fetch_names, scratch, return_numpy=False,
                mode=mode)
        entry = next(iter(exe._cache.values()), None)
        graph = entry.graph if entry is not None else None
        times = []
        for _ in range(max(1, trials)):
            if graph is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    graph.replay()
                end.record()
                end.synchronize()
                # each replay launches the captured kernels once more
                add_launches({k: n * iters
                              for k, n in entry.launches.items()})
                times.append(start.elapsed_time(end) / 1e3 / iters)
                continue
            t0 = time.perf_counter()
            for _ in range(iters):
                out = exe.run(program, feed, fetch_names, scratch,
                              return_numpy=False, mode=mode)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            else:
                _fetch_numpy(out)
            times.append((time.perf_counter() - t0) / iters)
        exe.close()
        return float(statistics.median(times))


def _run_host_op(op, scope: Scope) -> None:
    """One host IO op on ``scope`` (the reference executor's
    ``_run_host_op``): ``save`` / ``save_combine`` write the scope's
    values of ``X`` to ``file_path``, ``load`` / ``load_combine`` set
    ``Out`` from it."""
    from . import io as fluid_io

    if op.type in ("save", "save_combine"):
        names = op.input("X")
        path = op.attr("file_path")
        if op.type == "save":
            fluid_io.save_tensor(scope.find_var(names[0]), path)
        else:
            fluid_io.save_tensors({n: scope.find_var(n) for n in names},
                                  path)
    elif op.type in ("load", "load_combine"):
        names = op.output("Out")
        path = op.attr("file_path")
        if op.type == "load":
            scope.set_var(names[0], fluid_io.load_tensor(path))
        else:
            loaded = fluid_io.load_tensors(path)
            for n in names:
                scope.set_var(n, loaded[n])


def _staged(v, device):
    """A feed value on ``device``: a host tensor copied there through
    pinned memory, asynchronously."""
    if isinstance(v, (SeqArray, NestedSeqArray)):
        return _like(v, [_staged(t, device) for t in _tensors(v)])
    if v.device == device:
        return v
    if device.type == "cuda" and not v.is_cuda:
        v = v.pin_memory()
    return v.to(device, non_blocking=True)


@contextlib.contextmanager
def _sync_errors():
    """PyTorch raises at any host sync an op makes (``.item()``, a
    pageable copy, a boolean index) while this is active."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)
