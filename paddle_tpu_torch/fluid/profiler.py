"""Profiler — the port of ``paddle_tpu/fluid/profiler.py`` (analog of
python/paddle/v2/fluid/profiler.py: the ``profiler`` context :76,
``cuda_profiler`` :33, over platform/profiler.h's RecordEvent).

``record_event`` times a block on the host clock and nothing else: it
never synchronizes with the card, so a step it wraps (``Executor.run``
wraps each in ``executor_step/<mode>``) keeps its one host sync, and on
the card it measures what the host spent issuing the step, not the
card's time.  Every event is also a span of the observability tracer.
The deep device profile (``tpu_trace``, and ``cuda_profiler`` by the
reference's name) is ``torch.profiler`` writing a Chrome trace into the
directory given.  ``op_cost_table`` counts each op's flops on ``meta``
tensors (``torch.utils.flop_counter``), where the reference costs each
op's HLO.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

from ..observability.tracing import tracer as _obs_tracer
from ..utils.sync import RANK_PROFILER, OrderedLock

__all__ = ["profiler", "cuda_profiler", "tpu_trace", "reset_profiler",
           "op_cost_table", "record_event", "get_profile_table"]

# appended from whatever thread runs a step (a scheduler's, a loader
# consumer's), so every touch goes through the lock
_events: Dict[str, List[float]] = defaultdict(list)
_events_lock = OrderedLock("fluid.profiler", RANK_PROFILER)
_enabled = False
_trace_ids = itertools.count()


@contextlib.contextmanager
def record_event(name: str):
    """Time a block on the host clock (platform::RecordEvent,
    profiler.h:25): into the table while ``profiler()`` is active, and
    as a tracing span (same name, cat="profiler") while the tracer is
    on."""
    tr = _obs_tracer()
    if not _enabled and not tr.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if _enabled:
            with _events_lock:
                _events[name].append(t1 - t0)
        tr.complete(name, t0, t1, cat="profiler")


def reset_profiler():
    with _events_lock:
        _events.clear()


def get_profile_table(sorted_key: Optional[str] = "total"):
    """Event table like the reference's ParseEvents output
    (platform/profiler.cc): name, calls, total, min, max, ave (s)."""
    with _events_lock:
        snapshot = {name: list(times) for name, times in _events.items()}
    rows = []
    for name, times in snapshot.items():
        rows.append({
            "name": name, "calls": len(times),
            "total": sum(times), "min": min(times), "max": max(times),
            "ave": sum(times) / len(times),
        })
    if sorted_key:
        rows.sort(key=lambda r: -r.get(sorted_key, 0))
    return rows


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             print_table: bool = True):
    """fluid.profiler.profiler(state, sorted_key): collect events for
    the block and print the table at its exit."""
    global _enabled
    old, _enabled = _enabled, True
    reset_profiler()
    try:
        yield
    finally:
        _enabled = old
        if print_table:
            rows = get_profile_table(sorted_key)
            if rows:
                w = max(len(r["name"]) for r in rows)
                print(f"{'Event':<{w}}  Calls  Total(s)   Min(s)    Max(s)"
                      f"    Ave(s)")
                for r in rows:
                    print(f"{r['name']:<{w}}  {r['calls']:>5}  "
                          f"{r['total']:8.4f}  {r['min']:8.4f}  "
                          f"{r['max']:8.4f}  {r['ave']:8.4f}")


@contextlib.contextmanager
def tpu_trace(log_dir: Optional[str] = None):
    """Deep profile of the block through ``torch.profiler`` (host ops,
    and the card's kernels and copies where there is a card), written
    as a Chrome trace ``trace.<pid>.<n>.json`` into ``log_dir`` (a
    folder under the temporary directory by default).  Yields the
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "paddle_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{next(_trace_ids)}.json"))


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """The reference's name (fluid/profiler.py:33): ``tpu_trace`` into
    the directory ``output_file``.  ``output_mode`` and ``config`` (the
    reference's nvprof settings) change nothing."""
    with tpu_trace(output_file) as d:
        yield d


def _meta(v):
    """A ``meta`` copy of a value's shape and dtype (a SeqArray's data and
    lengths, a SelectedRows' rows and values)."""
    import numpy as np
    import torch

    from .core.lod import SeqArray
    from .core.selected_rows import SelectedRows

    if isinstance(v, SeqArray):
        return SeqArray(_meta(v.data), _meta(v.lengths))
    if isinstance(v, SelectedRows):
        return SelectedRows(_meta(v.rows), _meta(v.values), v.height)
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    from .executor import _feed_value

    return _meta(_feed_value(np.asarray(v)))     # a host value


def _valid_taps(x_shape, w_shape, out_shape, stride, padding, dilation):
    """Multiply-adds of a (non-transposed) convolution that read the
    input, not its zero padding: per spatial dim, the (output position,
    filter tap) pairs whose input index lies inside the input, times the
    batch and both channel extents."""
    taps = 1
    for d, (n_in, n_out, k) in enumerate(zip(x_shape[2:], out_shape[2:],
                                             w_shape[2:])):
        taps *= sum(1 for o in range(n_out) for j in range(k)
                    if 0 <= o * stride[d] - padding[d] + j * dilation[d]
                    < n_in)
    return x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
               transposed, *args, out_shape=None, **kwargs):
    from torch.utils.flop_counter import conv_flop_count

    if transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=True)
    return 2 * _valid_taps(x_shape, w_shape, out_shape, stride, padding,
                           dilation)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, stride,
                        padding, dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kwargs):
    from torch.utils.flop_counter import conv_backward_flop

    if transposed:
        return conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias,
                                  stride, padding, dilation, transposed,
                                  _output_padding, _groups, output_mask,
                                  out_shape)
    # the input's and the weight's gradients each pair the forward's
    # valid taps once
    fwd = 2 * _valid_taps(x_shape, w_shape, grad_out_shape, stride,
                          padding, dilation)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def op_cost_table(program=None, feed=None, scope=None, mode="train",
                  top: int = 20, print_table: bool = True):
    """Per-op cost breakdown of one step: where does its compute go?

    Each desc op of the global block runs alone on ``meta`` tensors
    (shapes carried from the feeds and the scope's values through the
    block, no data, no device) under ``torch.utils.flop_counter.
    FlopCounterMode``; its bytes are its inputs' plus its outputs'.  A
    grad op takes its vector-Jacobian product through its forward op's
    taped graph, as the executor runs it, so the forward's flops are
    counted once, at the forward op.  The rows are sorted by flops.

    The reference costs each op's lowered HLO with XLA's cost analysis
    instead, so only the products compare across packages: here as
    there, a ``mul`` / ``matmul`` / ``conv2d`` (and their grads) counts
    2 flops per multiply-add (``2 * M * N * K``; a convolution counts the
    multiply-adds that read the input and not its zero padding, as XLA
    does, where FlopCounterMode's own rule counts ``2 * out_elems *
    C_in/groups * kh * kw``), and their tables agree at the same shapes.
    Elsewhere the rules differ: FlopCounterMode counts only products
    (mm, bmm, convolutions, attention), so an elementwise op or a
    reduction counts 0 here where XLA counts an operation per element;
    bytes here are the op's input and output tensors, where XLA counts
    the bytes its fused HLO touches.  An op that cannot run on meta
    tensors (a value-dependent shape, an unregistered type) counts 0
    and its outputs take their recorded shapes, so the table goes on.
    """
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .core.registry import EmitCtx, get_op_info
    from .core.types import runtime_dtype, torch_dtype
    from .executor import _feed_value, _nbytes, global_scope
    from .framework import _DUMMY_BATCH, default_main_program
    from .lowering import (BlockPlan, _emit_taped, _emit_tape_grad,
                           _gather_inputs, _scatter_outputs)

    aten = torch.ops.aten
    program = program or default_main_program()
    scope = scope or global_scope()
    feed = {k: _meta(_feed_value(v)) for k, v in (feed or {}).items()}
    block = program.desc.global_block()
    # every op live: the table covers the block, not only what a fetch
    # needs
    every = sorted({n for op in block.ops for n in op.output_names() if n})
    plan = BlockPlan(block, list(feed), every, program=program.desc)
    index = {id(op): i for i, op in enumerate(block.ops)}
    meta = torch.device("meta")
    env = dict(feed)
    for n in plan.state_in:
        v = scope.find_var(n)
        if v is None:
            if n in block.vars and not block.vars[n].persistable:
                continue            # written by an op this table skips
            raise RuntimeError(f"op_cost_table: input {n!r} absent from "
                               f"the scope (run startup first)")
        env[n] = _meta(v)
    seeds = [0] * len(plan.salts)
    seed_buf = torch.zeros(len(plan.salts), dtype=torch.int32, device=meta)
    batch = next((v.shape[0] for v in feed.values()
                  if getattr(v, "shape", ()) and v.shape[0] > 0),
                 _DUMMY_BATCH)

    def fallback_outputs(op):
        for names in op.outputs.values():
            for n in names:
                if not n or n in env:
                    continue
                vd = block.vars.get(n)
                shape = ([batch if d in (-1, None) else d for d in vd.shape]
                         if vd is not None and vd.shape is not None else [])
                dtype = (torch_dtype(runtime_dtype(vd.dtype))
                         if vd is not None and vd.dtype else torch.float32)
                env[n] = torch.empty(shape, dtype=dtype, device=meta)

    def seed_of(entries, pos):
        if pos not in entries:
            return None
        i, host = entries[pos]
        return seeds[i] if host else seed_buf[i]

    def lower_block(idx, sub_env):
        sub_env = dict(sub_env)
        ops, entries = plan.sub_blocks[idx]
        for pos, op in enumerate(ops):
            ins = _gather_inputs(op, sub_env)
            ctx = EmitCtx(op, seed=seed_of(entries, pos), device=meta,
                          mode=mode, lower_block=lower_block)
            _scatter_outputs(op, get_op_info(op.type).emit(ctx, ins),
                             sub_env)
        return sub_env

    rows = []
    tape = {}
    for pos, op in enumerate(plan.ops):
        flops, nbytes = 0.0, 0.0
        try:
            ins = _gather_inputs(op, env)
            ctx = EmitCtx(op, seed=seed_of(plan.seed, pos), device=meta,
                          mode=mode, lower_block=lower_block)
            counter = FlopCounterMode(display=False, custom_mapping={
                aten.convolution: _conv_flop,
                aten.convolution_backward: _conv_backward_flop})
            with counter, torch.no_grad():
                if pos in plan.grad_of:
                    outs = _emit_tape_grad(op, ins,
                                           tape.pop(plan.grad_of[pos]))
                elif pos in plan.tape:
                    outs, tape[pos] = _emit_taped(ctx, op, ins,
                                                  plan.tape[pos])
                else:
                    outs = get_op_info(op.type).emit(ctx, ins)
            _scatter_outputs(op, outs, env)
            flops = float(counter.get_total_flops())
            nbytes = float(_nbytes(v for vals in ins.values() for v in vals)
                           + _nbytes(v for vals in outs.values()
                                     for v in vals))
        except Exception:
            # control flow the host drives, unregistered types, emitters
            # a meta tensor cannot run: count as zero, keep going
            fallback_outputs(op)
        rows.append({"op": f"#{index[id(op)]} {op.type}", "flops": flops,
                     "bytes": nbytes})

    total_flops = sum(r["flops"] for r in rows) or 1.0
    rows.sort(key=lambda r: -r["flops"])
    if print_table:
        print(f"{'op':<40}{'GFLOPs':>12}{'MB':>10}{'% flops':>9}")
        for r in rows[:top]:
            print(f"{r['op']:<40}{r['flops']/1e9:>12.3f}"
                  f"{r['bytes']/1e6:>10.1f}"
                  f"{100*r['flops']/total_flops:>8.1f}%")
        rest = rows[top:]
        if rest:
            print(f"{'... ' + str(len(rest)) + ' more ops':<40}"
                  f"{sum(r['flops'] for r in rest)/1e9:>12.3f}")
    return rows
