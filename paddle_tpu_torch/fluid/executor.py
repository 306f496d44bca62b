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
  copy back into the buffer.  A var replaced in the scope (``set_var``,
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
reference takes them); fetches of a bfloat16 value come back as float32.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import add_launches, launch_counts
from .core.lod import NestedSeqArray, SeqArray
from .core.selected_rows import SelectedRows
from .core.types import runtime_dtype, torch_dtype
from .framework import Program, Variable, default_main_program
from .lowering import (MARKER_OPS, BlockPlan, run_block_ops, seed_tensor,
                       step_seeds)

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "CPUPlace",
           "CUDAPlace", "scope_from_numpy", "scope_to_numpy"]


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


def _to_device(v, device: torch.device):
    """One host value as a device tensor; int64 and float64 narrow to
    int32 and float32 as in the reference's runtime.  Arrays are copied:
    the optimizer ops update scope tensors in place, and a read-only
    array (a JAX buffer) must not be written through.  A SeqArray moves
    as its data and its int32 lengths."""
    if isinstance(v, SeqArray):
        return SeqArray(_to_device(v.data, device),
                        _to_device(v.lengths, device))
    t = v if isinstance(v, torch.Tensor) else _host_tensor(v)
    return t.to(device=device, dtype=torch_dtype(runtime_dtype(t.dtype)))


def _to_numpy(t):
    """A scope value on the host: a numpy array of its own (a CPU
    tensor's is copied: the next step updates the tensor in place), or a
    SeqArray (NestedSeqArray) of numpy fields.  A bfloat16 value comes
    back as float32 (exactly): numpy has no bfloat16, where the reference
    returns an ``ml_dtypes`` bfloat16 array."""
    if isinstance(t, (SeqArray, NestedSeqArray)):
        return _like(t, [_to_numpy(x) for x in _tensors(t)])
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


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
    caller's array), a tensor where it lies.  A SeqArray keeps its
    structure, with int32 lengths."""
    if isinstance(v, SeqArray):
        return SeqArray(_feed_value(v.data), _feed_value(v.lengths))
    t = v if isinstance(v, torch.Tensor) else _host_tensor(v)
    return t.to(dtype=torch_dtype(runtime_dtype(t.dtype)))


def _sig_of(v) -> tuple:
    """Shape and dtype of a feed or state value (never its contents)."""
    if isinstance(v, SeqArray):
        return ("seq",) + tuple(v.data.shape) + (str(v.data.dtype),)
    return tuple(v.shape) + (str(v.dtype),)


def _tensors(v) -> List[torch.Tensor]:
    """A value's tensors: a SeqArray's data and lengths, a
    NestedSeqArray's (the output of ``beam_search_decode``) data and
    both lengths, a SelectedRows' (a sparse gradient) rows and values,
    else the tensor itself."""
    if isinstance(v, SeqArray):
        return [v.data, v.lengths]
    if isinstance(v, NestedSeqArray):
        return [v.data, v.outer_lengths, v.inner_lengths]
    if isinstance(v, SelectedRows):
        return [v.rows, v.values]
    return [v]


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
            if t.dtype == torch.bfloat16:
                t = t.float()
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
    out = [_like(v, [t.numpy() for t in o]) for v, o in zip(values, host)]
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
                 "launches")

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


class Executor:
    """Executor with the reference's executable cache.  API mirrors
    fluid.Executor: ``run(program, feed, fetch_list, scope)`` -> list of
    numpy arrays."""

    # bound on the cached step signatures (each with its CUDA graph and
    # buffers on the card); LRU eviction, as in the reference
    CACHE_CAPACITY = 64

    def __init__(self, place: Union[CUDAPlace, CPUPlace, None] = None,
                 compile_cache=None):
        if compile_cache not in (None, False):
            raise NotImplementedError("Executor: compile_cache (the "
                                      "reference's persistent AOT tier) is "
                                      "not ported to paddle_tpu_torch")
        self.device = _place_device(place)
        self.place = place if place is not None else CUDAPlace(
            self.device.index or 0)
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # (program fp, feed names, fetch names) -> BlockPlan
        self._cls_cache: "OrderedDict[tuple, BlockPlan]" = OrderedDict()
        self._stats = {
            "executable": {"hits": 0, "misses": 0, "evictions": 0},
            "structure": {"hits": 0, "misses": 0, "evictions": 0}}
        self._stream = None             # the capture stream, made once
        # every state buffer of this executor's entries (by id, weakly),
        # and the scope each one was last published to
        self._buffers: "weakref.WeakValueDictionary[int, torch.Tensor]" = \
            weakref.WeakValueDictionary()
        self._holders: Dict[int, "weakref.ref[Scope]"] = {}

    # -- caches ---------------------------------------------------------------
    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """Counters of the executable cache (step signatures, each a
        captured CUDA graph on the card) and the structure cache (the
        block's plan per program, feed names and fetch names):
        ``{'executable': {hits, misses, evictions, size}, 'structure':
        {...}}``, the reference's two blocks of the same name.  A hot
        training loop converges to pure hits."""
        out = {k: dict(v) for k, v in self._stats.items()}
        out["executable"]["size"] = len(self._cache)
        out["structure"]["size"] = len(self._cls_cache)
        return out

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
            if not isinstance(v, (torch.Tensor, SeqArray)):
                # a host value (as the reference's jit takes numpy state):
                # uploaded once, and the scope that holds it keeps the
                # device tensor
                v = _to_device(v, self.device)
                _owner_of(scope, n).set_var(n, v)
            dev = v.data.device if isinstance(v, SeqArray) else v.device
            if dev != self.device:
                raise ValueError(f"Executor: scope variable {n!r} is on "
                                 f"{dev}, the executor runs on "
                                 f"{self.device}")
            state[n] = v
        return state

    def _prepare(self, program, feed, fetch_list, scope, mode):
        """-> (the signature, the plan, the state values, the fetch
        names)."""
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        prog_fp = self._program_key(program)
        plan = self._plan(prog_fp, program, list(feed), fetch_names)
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
        with torch.no_grad():
            run_block_ops(plan, env, entry.seeds_host, entry.seeds,
                          self.device, entry.mode)
            for n in plan.state_out:
                if n in entry.state and env[n] is not entry.state[n]:
                    for d, x in zip(_tensors(entry.state[n]),
                                    _tensors(env[n])):
                        d.copy_(x)
        entry.out = {n: entry.state.get(n, env[n]) for n in plan.state_out}
        entry.fetches = [env[n] for n in entry.fetch_names]

    def _first_step(self, plan, fetch_names, mode, feed, state, seeds,
                    scope) -> Tuple[Optional[_Entry], List[Any]]:
        """A miss: run the step eagerly on the scope's tensors, then give
        the entry its buffers and, on the card, capture the graph.
        Returns the entry (None for a step that moved its own state to
        another signature) and the eager step's fetches."""
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
        guard = (_sync_errors() if dev.type == "cuda"
                 and not plan.host_rng_ops else contextlib.nullcontext())
        with torch.no_grad(), guard:
            run_block_ops(plan, env, seeds, entry.seeds, dev, mode)
        for n in plan.state_out:
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
            return None, fetches
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
        if dev.type == "cuda" and not plan.host_rng_ops \
                and not plan.host_loops:
            self._capture(entry)
        self._publish(entry, scope, out=False)
        return entry, fetches

    def _capture(self, entry: _Entry) -> None:
        before = launch_counts()
        # the graph itself is kept beside its instantiation, so its nodes
        # can be read (``graphs()``)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, stream=self._capture_stream()):
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

    def _publish(self, entry: _Entry, scope: Scope, out: bool = True
                 ) -> None:
        """After a step: the scope's vars are the entry's buffers (a
        state var the step only reads, where the scope itself holds it).
        With ``out``, the state vars the step wrote too (a var the block
        writes and never reads as a copy); the eager first step has set
        those already."""
        if out:
            for n, v in entry.out.items():
                scope.set_var(n, v if n in entry.state else _clone(v))
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
        if entry.plan.host_rng_ops and self.device.type == "cuda":
            raise NotImplementedError(
                f"Executor: this program holds "
                f"{', '.join(sorted(set(entry.plan.host_rng_ops)))}, which "
                f"draws on the host: a replay would repeat its first draw. "
                f"Run such a program (a startup program) once per "
                f"executor on the card, or on CPUPlace")
        self._bind(entry, state, scope)
        if entry.graph is not None:
            entry.graph.replay()
            add_launches(entry.launches)
        elif self.device.type == "cuda":
            # a step whose loop the host drives: eager on the card, and
            # still no host sync but the loops' condition reads
            with _sync_errors():
                self._body(entry)
        else:
            self._body(entry)
        self._publish(entry, scope)
        return [_clone(f) for f in entry.fetches]

    def _step(self, program, feed, fetch_list, scope, mode) -> List[Any]:
        """One step at the feeds' signature: a miss runs it eagerly and
        caches it (captured, on the card), a hit replays it."""
        key, plan, state, fetch_names = self._prepare(
            program, feed, fetch_list, scope, mode)
        if not plan.ops and not fetch_names:
            return []
        seeds = step_seeds(plan, *scope.next_rng_bits(program.random_seed))
        entry = self._lookup(key)
        if entry is None:
            entry, fetches = self._first_step(plan, fetch_names, mode, feed,
                                              state, seeds, scope)
            if entry is not None:
                self._store(key, entry)
            return fetches
        self._load(entry, feed, seeds)
        return self._replay(entry, state, scope)

    # -- entry points -------------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            mode: str = "train", **unported) -> List[Any]:
        """One step of ``program``'s global block.  ``mode="infer"``
        turns dropout off.  The reference's ``validate`` and ``guard``
        options are not ported and raise."""
        if unported:
            raise NotImplementedError(
                f"Executor.run: {', '.join(sorted(unported))} not ported "
                f"to paddle_tpu_torch")
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = {k: _feed_value(v) for k, v in (feed or {}).items()}
        fetches = self._step(program, feed, fetch_list, scope, mode)
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
        """Run every feed dict of ``loader`` (an iterable, or a zero-arg
        callable returning one; the reference's DataLoader is not ported)
        through ``run()`` without waiting for each step's fetches: they
        stay on the device and are drained every ``fetch_every`` steps,
        so the host queues steps ahead of the card.  The steps are
        ``run()``'s, so the results equal the synchronous loop's
        bitwise.  Returns the per-step fetch lists or, with
        ``on_fetch(outs)``, streams each step's fetches to it and returns
        the step count.  A fetched state value (a persistable, or a var
        the block does not write) is drained at once, every step, as the
        reference does.  ``guard`` is not ported."""
        if guard is not None:
            raise NotImplementedError("Executor.run_pipeline: guard (the "
                                      "reference's guardrails) is not "
                                      "ported to paddle_tpu_torch")
        if loader is None:
            raise ValueError("run_pipeline needs a loader (an iterable of "
                             "feed dicts)")
        if callable(loader) and not hasattr(loader, "__iter__"):
            loader = loader()
        fetch_every = max(1, int(fetch_every))
        blk = (program or default_main_program()).desc.global_block()
        written = {n for op in blk.ops if op.type not in MARKER_OPS
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
                                        return_numpy=False, mode=mode))
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

    def cost_analysis(self, *args, **kwargs):
        raise NotImplementedError("Executor.cost_analysis (XLA's HLO cost "
                                  "model) is not ported to paddle_tpu_torch")


def _staged(v, device):
    """A feed value on ``device``: a host tensor copied there through
    pinned memory, asynchronously."""
    if isinstance(v, SeqArray):
        return SeqArray(_staged(v.data, device), _staged(v.lengths, device))
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
