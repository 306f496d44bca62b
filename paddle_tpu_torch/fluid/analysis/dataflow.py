"""Shared def-use / liveness infrastructure for all analysis passes —
the port's copy of ``paddle_tpu/fluid/analysis/dataflow.py``.

The walk is built once over the raw ProgramDesc and every pass consumes
it:

* ``ProgramView`` — bounded, cycle-safe block/ancestor navigation that
  survives lying ``idx``/``parent_idx`` fields (seeded-bad programs must
  produce findings, not hangs);
* per-op normalized reads/writes with **control-flow attribution**: an op
  carrying a ``__block__`` attr (while / conditional_block / recurrent)
  accounts for its sub-block's *external* effects — names its body touches
  that the body does not declare — at the parent op's position;
* whole-program op liveness (mark-and-sweep from side effects,
  persistables, escaping writes, and fetch roots) for dead-code findings;
* single-block live ranges + greedy interval coloring (the contract of
  the reference's ``analyze_block``), which the cost model's byte
  timeline is built on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.desc import BlockDesc, OpDesc, ProgramDesc, VarDesc

__all__ = ["OpUse", "BlockView", "ProgramView", "SIDE_EFFECT_OPS",
           "CONTROL_FLOW_OPS", "HOST_IO_OPS", "live_ops", "block_liveness"]

# ops whose execution is an effect in itself (host IO, logging, runtime
# markers) — never dead even when nothing reads their outputs
SIDE_EFFECT_OPS = {"save", "load", "save_combine", "load_combine", "print",
                   "feed", "fetch", "assert", "py_func"}
# ops that carry a sub-block (the reference's BLOCK attr, framework.proto:27)
CONTROL_FLOW_OPS = {"while", "conditional_block", "recurrent",
                    "dynamic_recurrent", "parallel_do"}
# host IO ops the executor runs outside the step (lowering.HOST_OPS;
# duplicated as data to keep this module import-light)
HOST_IO_OPS = {"save", "load", "save_combine", "load_combine"}


class OpUse:
    """One op's normalized dataflow footprint at its block position."""

    __slots__ = ("idx", "desc", "reads", "writes", "sub_blocks",
                 "sub_reads", "sub_writes", "_read_names", "_write_names")

    def __init__(self, idx: int, desc: OpDesc):
        self.idx = idx
        self.desc = desc
        # (slot, position-in-slot, name) triples — precise coordinates
        self.reads: List[Tuple[str, int, str]] = [
            (slot, i, n) for slot, names in desc.inputs.items()
            for i, n in enumerate(names) if n]
        self.writes: List[Tuple[str, int, str]] = [
            (slot, i, n) for slot, names in desc.outputs.items()
            for i, n in enumerate(names) if n]
        self.sub_blocks: List[int] = [
            a["__block__"] for a in desc.attrs.values()
            if isinstance(a, dict) and "__block__" in a
            and isinstance(a["__block__"], int)]
        # external effects of the sub-blocks, filled by ProgramView
        self.sub_reads: Set[str] = set()
        self.sub_writes: Set[str] = set()
        # memoized name sets — the footprint is immutable once ProgramView
        # finishes wiring sub-effects, and the liveness fixpoint queries it
        # once per op per sweep
        self._read_names: Set[str] = None
        self._write_names: Set[str] = None

    @property
    def type(self) -> str:
        return self.desc.type

    def read_names(self) -> Set[str]:
        if self._read_names is None:
            self._read_names = {n for _, _, n in self.reads} | self.sub_reads
        return self._read_names

    def write_names(self) -> Set[str]:
        if self._write_names is None:
            self._write_names = ({n for _, _, n in self.writes}
                                 | self.sub_writes)
        return self._write_names


class BlockView:
    __slots__ = ("idx", "parent_idx", "desc", "ops")

    def __init__(self, pos: int, desc: BlockDesc):
        # trust the LIST position, not the self-declared idx (which seeded
        # -bad programs may fake)
        self.idx = pos
        self.parent_idx = desc.parent_idx
        self.desc = desc
        self.ops = [OpUse(i, od) for i, od in enumerate(desc.ops)]


class ProgramView:
    """Navigable, cycle-safe view over a ProgramDesc."""

    def __init__(self, desc: ProgramDesc):
        self.desc = desc
        self.blocks = [BlockView(i, bd) for i, bd in enumerate(desc.blocks)]
        self._effects: Dict[int, Tuple[Set[str], Set[str]]] = {}
        for b in self.blocks:
            for op in b.ops:
                for si in op.sub_blocks:
                    if 0 <= si < len(self.blocks):
                        r, w = self.block_effects(si)
                        op.sub_reads |= r
                        op.sub_writes |= w

    # -- navigation ----------------------------------------------------------
    def ancestors(self, block_idx: int) -> List[int]:
        """Ancestor chain (nearest first), bounded even on bad parent
        graphs (at most one hop per block)."""
        out, cur, hops = [], block_idx, 0
        n = len(self.blocks)
        while hops <= n:
            hops += 1
            b = self.blocks[cur]
            p = b.parent_idx
            if not (0 <= p < n and p < cur):
                break
            out.append(p)
            cur = p
        return out

    def visible_var(self, block_idx: int, name: str) -> Optional[VarDesc]:
        for bi in [block_idx] + self.ancestors(block_idx):
            vd = self.blocks[bi].desc.vars.get(name)
            if vd is not None:
                return vd
        return None

    def owner_block(self, block_idx: int, name: str) -> Optional[int]:
        for bi in [block_idx] + self.ancestors(block_idx):
            if name in self.blocks[bi].desc.vars:
                return bi
        return None

    # -- recursive external effects ------------------------------------------
    def block_effects(self, block_idx: int,
                      _stack: Optional[Set[int]] = None
                      ) -> Tuple[Set[str], Set[str]]:
        """Names a block (and its nested sub-blocks) reads/writes that the
        block does not itself declare — what its control-flow op accounts
        for at the parent level."""
        if block_idx in self._effects:
            return self._effects[block_idx]
        _stack = _stack or set()
        if block_idx in _stack or not (0 <= block_idx < len(self.blocks)):
            return set(), set()          # cyclic/bogus sub-block reference
        _stack = _stack | {block_idx}
        b = self.blocks[block_idx]
        reads: Set[str] = set()
        writes: Set[str] = set()
        for op in b.ops:
            reads |= {n for _, _, n in op.reads}
            writes |= {n for _, _, n in op.writes}
            for si in op.sub_blocks:
                r, w = self.block_effects(si, _stack)
                reads |= r
                writes |= w
        local = set(b.desc.vars)
        eff = (reads - local, writes - local)
        self._effects[block_idx] = eff
        return eff

    # -- persistables --------------------------------------------------------
    def is_persistable(self, block_idx: int, name: str) -> bool:
        vd = self.visible_var(block_idx, name)
        return bool(vd is not None and vd.persistable)


def live_ops(view: ProgramView, fetch: Sequence[str] = ()) -> Set[Tuple[int, int]]:
    """Mark-and-sweep op liveness over the whole program.

    Roots: side-effecting ops, ops writing a persistable var, ops writing a
    fetched name, ops whose writes escape their block (a sub-block op
    updating a parent var — the carried state of while/recurrent), and
    control-flow ops themselves.  Liveness then propagates backward through
    reads: an op is live if a live op reads something it writes.  The
    complement is the ``unreachable/dead`` set the reference's prune.cc
    computes for inference slicing — here it is a lint finding instead.
    """
    fetch_set = set(fetch)
    readers: Dict[str, Set[Tuple[int, int]]] = {}
    for b in view.blocks:
        for op in b.ops:
            for n in op.read_names():
                readers.setdefault(n, set()).add((b.idx, op.idx))

    live: Set[Tuple[int, int]] = set()
    for b in view.blocks:
        local = set(b.desc.vars)
        for op in b.ops:
            key = (b.idx, op.idx)
            if op.type in SIDE_EFFECT_OPS or op.type in CONTROL_FLOW_OPS \
                    or op.sub_blocks:
                live.add(key)
                continue
            for n in op.write_names():
                if n in fetch_set or view.is_persistable(b.idx, n) \
                        or n not in local:   # escaping write
                    live.add(key)
                    break

    # backward propagation to fixpoint; sweeping in reverse program order
    # follows the consumer->producer direction, so a def-use chain
    # resolves in one sweep instead of one sweep per link
    all_ops = [(b, op) for b in view.blocks for op in b.ops]
    changed = True
    while changed:
        changed = False
        for b, op in reversed(all_ops):
            key = (b.idx, op.idx)
            if key in live:
                continue
            for n in op.write_names():
                if any(r in live for r in readers.get(n, ())):
                    live.add(key)
                    changed = True
                    break
    return live


def block_liveness(block: BlockDesc) -> dict:
    """Single-block program-order liveness + greedy interval coloring.

    The contract of the reference's ``analyze_block`` and
    _dataflow_analyze: schedule = program order, live range = [first def,
    last use], persistables excluded, slots assigned greedily over sorted
    intervals.  ``cost.block_byte_plan`` and ``cost.legacy_stats``
    consume this; keys must stay stable.
    """
    descs = block.ops
    first_def: Dict[str, int] = {}
    last_pos: Dict[str, int] = {}
    for i, od in enumerate(descs):
        for names in od.outputs.values():
            for name in names:
                if name:
                    first_def.setdefault(name, i)
                    last_pos[name] = i
        for names in od.inputs.values():
            for name in names:
                if name:
                    last_pos[name] = i
    persistable = {n for n, v in block.vars.items()
                   if getattr(v, "persistable", False)}
    live_range = {n: (d, last_pos[n]) for n, d in first_def.items()
                  if n not in persistable}
    ivs = sorted((rng, n) for n, rng in live_range.items())
    free_at: List[int] = []
    reuse_slot: Dict[str, int] = {}
    for (start, end), name in ivs:
        slot = next((s for s, f in enumerate(free_at) if f < start), None)
        if slot is None:
            slot = len(free_at)
            free_at.append(-1)
        free_at[slot] = end
        reuse_slot[name] = slot
    return {"topo_order": list(range(len(descs))),
            "level": list(range(len(descs))),
            "live_range": {n: list(r) for n, r in live_range.items()},
            "reuse_slot": reuse_slot,
            "num_slots": len(free_at)}
