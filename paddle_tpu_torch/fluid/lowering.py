"""Block lowering: run a block's ops eagerly on one device — the port of
``paddle_tpu/fluid/lowering.py``.

The reference traces every op's emitter into one XLA computation, where
dead code is dropped and a grad op's re-run of its forward op is folded
into the first run by common-subexpression elimination.  Eager PyTorch
does neither by itself, so ``BlockPlan`` does both from the desc alone:

* dead-code elimination: only ops that feed a fetch or write a
  persistable var run, and the forward op of each live grad op that
  takes its product from the forward's graph (the Transformer's
  unfetched ``predict`` projection, for one, never runs);
* a forward op whose ``*_grad`` op has no emitter of its own runs under
  autograd with the inputs its grad op asks for as leaves, and keeps its
  graph on a tape; the grad op takes the vector-Jacobian product through
  that graph (``torch.autograd.grad``), so no forward runs twice — a
  ``fused_attention`` launches its forward kernel once per step and its
  grad op launches the dq and dk/dv kernels.

Sub-blocks: an op of a control-flow family (``while``, ``recurrent``,
``dynamic_recurrent``, ``conditional_block``) names a sub-block, which
its emitter runs through ``EmitCtx.lower_block``: every op of the
sub-block in order, into a copy of the map it is given, with no
dead-code elimination inside, as the reference traces it.  Nested
blocks go through the same hook.  Such an op with a ``*_grad`` op is
taped like any other, so its gradient is autograd's vector-Jacobian
product through the whole loop.

Random numbers: each random op carries a build-time ``__rng_salt__``; its
seed is an integer hash of (program seed, step, salt) (``op_seed``), so
the card and the CPU draw the same dropout masks from the same seed.
The host computes a step's seeds (one per salt, ``step_seeds``) and the
executor writes them into one int32 buffer on the device; an op that
draws on the device gets a 0-d view of its entry, as the reference's
``rng_bits`` are a traced input, so a step captured in a CUDA graph
draws new masks at each replay.  An op that draws on the host
(``host_rng``) gets the int itself.  A random op in a sub-block has its
salt in the same buffer, so each iteration draws what the reference's
fixed step key draws.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.desc import BlockDesc, OpDesc, ProgramDesc
from .core.lod import SeqArray
from .core.registry import (EmitCtx, GRAD_SUFFIX, base_op_type, get_op_info,
                            has_op, is_grad_op_type)

__all__ = ["BlockPlan", "run_block_ops", "op_seed", "step_seeds",
           "seed_tensor", "MARKER_OPS"]

# pure marker ops (wired by the executor's feed/fetch handling)
MARKER_OPS = {"feed", "fetch"}

_M64 = (1 << 64) - 1


def op_seed(seed: int, step: int, salt: int) -> int:
    """uint32 seed of the random op with ``salt`` in step ``step`` of a
    program seeded ``seed``: a splitmix64 finalizer over the three."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xD1B54A32D192ED03
         + int(salt) * 0x8CB92BA72F3D8DD7) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & 0xFFFFFFFF


def step_seeds(plan: "BlockPlan", seed: int, step: int) -> List[int]:
    """The uint32 seed of each of the plan's salts in step ``step``."""
    return [op_seed(seed, step, salt) for salt in plan.salts]


def seed_tensor(seeds: Sequence[int]) -> torch.Tensor:
    """Host int32 tensor holding the bits of uint32 seeds (the kernels
    read each entry as a uint32; ``keep_scale`` masks it back)."""
    return torch.from_numpy(np.asarray(seeds, np.uint32).view(np.int32)
                            .copy())


class BlockPlan:
    """What running a block for given feeds and fetches needs, derived
    from the desc: the live ops in order, the state read from the scope
    (``state_in``) and written back (``state_out``), the tape links
    between grad ops and their forward ops, the random ops' salts in
    seed-buffer order (``salts``; a grad op shares its forward op's,
    and the ops of sub-blocks are walked too), the live ops that draw
    on the host (``host_rng_ops``) and the ops whose trip count the
    host reads (``host_loops``, in sub-blocks too).  ``program`` is the
    desc whose sub-blocks the block's control-flow ops run
    (``sub_blocks``: index -> its ops and their seed entries)."""

    def __init__(self, block: BlockDesc, feed_names: Sequence[str],
                 fetch_names: Sequence[str],
                 program: Optional[ProgramDesc] = None):
        ops = [op for op in block.ops if op.type not in MARKER_OPS]
        persistable = {n for n, vd in block.vars.items() if vd.persistable}
        needed = set(fetch_names)
        live = []
        for op in reversed(ops):
            if any(n and (n in needed or n in persistable)
                   for n in op.output_names()):
                live.append(op)
                needed.update(n for n in op.input_names() if n)
                if is_grad_op_type(op.type) and not has_op(op.type):
                    # its product needs its forward op's taped graph, so
                    # the forward op lives even where nothing fetches
                    # its output
                    needed.update(n.split(GRAD_SUFFIX)[0]
                                  for slot, names in op.inputs.items()
                                  if slot.endswith(GRAD_SUFFIX)
                                  for n in names if n)
        self.ops: List[OpDesc] = live[::-1]

        feeds = set(feed_names)
        written: set = set()
        self.state_in: List[str] = []
        for op in self.ops:
            for n in op.input_names():
                if n and n not in written and n not in feeds \
                        and n not in self.state_in:
                    self.state_in.append(n)
            written.update(n for n in op.output_names() if n)
        for n in fetch_names:
            if n not in written and n not in feeds \
                    and n not in self.state_in:
                self.state_in.append(n)
        self.state_out = sorted(n for n in written if n in persistable)

        # seed[position] = (the op's entry in the step's seeds, whether
        # it draws on the host); the same for each sub-block's ops
        self.salts: List[int] = []
        self.host_rng_ops: List[str] = []
        self.host_loops: List[str] = []
        self.sub_blocks: Dict[int, Tuple[List[OpDesc],
                                         Dict[int, Tuple[int, bool]]]] = {}
        self.seed = self._walk(self.ops, program)

        # tape[forward position] = the (slot, index) inputs its grad op
        # wants; grad_of[grad position] = forward position
        self.tape: Dict[int, List[Tuple[str, int]]] = {}
        self.grad_of: Dict[int, int] = {}
        writers: Dict[str, List[int]] = {}
        for pos, op in enumerate(self.ops):
            if is_grad_op_type(op.type) and not has_op(op.type):
                fwd = self._forward_of(pos, op, writers)
                self.grad_of[pos] = fwd
                self.tape[fwd] = [
                    (slot[: -len(GRAD_SUFFIX)], i)
                    for slot, names in op.outputs.items()
                    for i, n in enumerate(names) if n]
            for n in op.output_names():
                if n:
                    writers.setdefault(n, []).append(pos)

    def _walk(self, ops: List[OpDesc], program: Optional[ProgramDesc]
              ) -> Dict[int, Tuple[int, bool]]:
        """The seed entries of ``ops``; the sub-blocks they run are
        planned on the way (every op, in order)."""
        seed = {}
        for pos, op in enumerate(ops):
            if op.type == "while" and op.attr("max_iters", None) is None:
                # a trip count only the data decides: the host reads
                # the condition
                self.host_loops.append(op.type)
            salt = op.attr("__rng_salt__", None)
            if salt is not None:
                if salt not in self.salts:
                    self.salts.append(salt)
                host = has_op(op.type) and get_op_info(op.type).host_rng
                if host:
                    self.host_rng_ops.append(op.type)
                seed[pos] = (self.salts.index(salt), host)
            idx = op.block_attr("sub_block")
            if idx is None or idx in self.sub_blocks:
                continue
            if program is None:
                raise ValueError(f"op {op.type} runs block {idx}: the plan "
                                 f"needs the program (BlockPlan(..., "
                                 f"program=...))")
            sub_ops = [o for o in program.block(idx).ops
                       if o.type not in MARKER_OPS]
            self.sub_blocks[idx] = (sub_ops, self._walk(sub_ops, program))
        return seed

    def _forward_of(self, pos: int, op: OpDesc,
                    writers: Dict[str, List[int]]) -> int:
        """The position of the forward op whose output gradients grad op
        ``op`` consumes: the latest writer of the var a cotangent names
        (``x@GRAD`` or ``x@GRAD@ZERO`` -> ``x``) of the grad op's type
        without a grad op yet (a loop may write the var again in place
        after its forward op)."""
        base = base_op_type(op.type)
        if not has_op(base):
            raise KeyError(f"no emitter for op type {op.type!r}")
        for slot, names in op.inputs.items():
            if not slot.endswith(GRAD_SUFFIX):
                continue
            for n in names:
                for fwd in reversed(writers.get(n.split(GRAD_SUFFIX)[0], [])
                                    if n else []):
                    if self.ops[fwd].type == base and fwd not in self.tape:
                        return fwd
        raise RuntimeError(f"grad op #{pos} ({op.type}) has no live forward "
                           f"op in this block")


def _gather_inputs(op: OpDesc, env: Dict[str, Any]) -> Dict[str, list]:
    ins: Dict[str, list] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if not n:
                continue
            if n not in env:
                raise KeyError(
                    f"op {op.type}: input {slot}={n!r} not materialized; "
                    f"known vars: {sorted(env)[:20]}...")
            vals.append(env[n])
        if vals:
            ins[slot] = vals
    return ins


def _scatter_outputs(op: OpDesc, outs: Dict[str, list], env: Dict[str, Any]):
    for slot, names in op.outputs.items():
        for n, v in zip(names, outs.get(slot, [])):
            if n:
                env[n] = v


def _data(v):
    """The tensor autograd sees: a SeqArray's padded data."""
    return v.data if isinstance(v, SeqArray) else v


def _emit_taped(ctx: EmitCtx, op: OpDesc, ins: Dict[str, list],
                wanted: List[Tuple[str, int]]):
    """Run a forward op under autograd with the wanted inputs as leaves
    (a SeqArray input's leaf is its data).  Returns (outputs detached for
    the env, (leaves, inputs, outputs with graph))."""
    ins = {slot: list(vals) for slot, vals in ins.items()}
    leaves = {}
    for slot, i in wanted:
        v = ins[slot][i]
        leaf = _data(v).detach().requires_grad_(True)
        ins[slot][i] = v.with_data(leaf) if isinstance(v, SeqArray) else leaf
        leaves[(slot, i)] = leaf
    with torch.enable_grad():
        outs = get_op_info(op.type).emit(ctx, ins)
    detached = {slot: [v.detach() for v in vals]
                for slot, vals in outs.items()}
    return detached, (leaves, ins, outs)


def _emit_tape_grad(op: OpDesc, ins: Dict[str, list], entry):
    """A ``*_grad`` op: the vector-Jacobian product of its forward op's
    taped graph with the cotangents ``<OutSlot>@GRAD``; gradients go out
    under ``<InSlot>@GRAD``, aligned with the forward slot's entries.  An
    input the outputs do not depend on gets zeros, and the gradient of a
    SeqArray input keeps that input's lengths."""
    leaves, primals, outs = entry
    cotangents = {s[: -len(GRAD_SUFFIX)]: v for s, v in ins.items()
                  if s.endswith(GRAD_SUFFIX)}
    ys, cts = [], []
    for slot in sorted(cotangents):
        for y, c in zip(outs.get(slot, []), cotangents[slot]):
            y = _data(y)
            if y.requires_grad:
                ys.append(y)
                # a cotangent must carry its output's dtype exactly
                cts.append(_data(c).to(y.dtype))
    keys = list(leaves)
    grads = (torch.autograd.grad(ys, [leaves[k] for k in keys], cts,
                                 allow_unused=True)
             if ys else [None] * len(keys))
    got = dict(zip(keys, grads))
    out: Dict[str, list] = {}
    for slot, names in op.outputs.items():
        fwd_slot = slot[: -len(GRAD_SUFFIX)]
        vals = []
        for i, n in enumerate(names):
            g = got.get((fwd_slot, i)) if n else None
            if n and g is None:
                g = torch.zeros_like(leaves[(fwd_slot, i)])
            primal = primals[fwd_slot][i] if n else None
            if isinstance(primal, SeqArray):
                g = primal.with_data(g)
            vals.append(g)
        out[slot] = vals
    return out


def run_block_ops(plan: BlockPlan, env: Dict[str, Any],
                  seeds: Sequence[int], seed_buf: Optional[torch.Tensor],
                  device: torch.device, mode: str = "train"
                  ) -> Dict[str, Any]:
    """Run the plan's ops in order into ``env`` (name -> tensor), the
    eager analog of the reference executor's per-op loop.  ``seeds`` are
    the step's seeds (``step_seeds``) and ``seed_buf`` the same values as
    an int32 tensor on ``device`` (``seed_tensor``), which the ops that
    draw on the device read."""
    tape: Dict[int, Any] = {}
    # under a running torch.profiler, each op's work is a range named
    # after its type, so the trace attributes time to Fluid ops
    annotate = torch.autograd.profiler._is_profiler_enabled

    def seed_of(entries, pos):
        if pos not in entries:
            return None
        i, host = entries[pos]
        return seeds[i] if host else seed_buf[i]

    def lower_block(idx: int, sub_env: Dict[str, Any]) -> Dict[str, Any]:
        """Sub-block ``idx``'s ops, in order, into a copy of
        ``sub_env``."""
        sub_env = dict(sub_env)
        ops, entries = plan.sub_blocks[idx]
        for pos, op in enumerate(ops):
            ins = _gather_inputs(op, sub_env)
            ctx = EmitCtx(op, seed=seed_of(entries, pos), device=device,
                          mode=mode, lower_block=lower_block)
            with (torch.profiler.record_function(op.type) if annotate
                  else contextlib.nullcontext()):
                outs = get_op_info(op.type).emit(ctx, ins)
            _scatter_outputs(op, outs, sub_env)
        return sub_env

    for pos, op in enumerate(plan.ops):
        ins = _gather_inputs(op, env)
        ctx = EmitCtx(op, seed=seed_of(plan.seed, pos), device=device,
                      mode=mode, lower_block=lower_block)
        with (torch.profiler.record_function(op.type) if annotate
              else contextlib.nullcontext()):
            if pos in plan.grad_of:
                outs = _emit_tape_grad(op, ins,
                                       tape.pop(plan.grad_of[pos]))
            elif pos in plan.tape:
                outs, tape[pos] = _emit_taped(ctx, op, ins, plan.tape[pos])
            else:
                outs = get_op_info(op.type).emit(ctx, ins)
        _scatter_outputs(op, outs, env)
    return env
