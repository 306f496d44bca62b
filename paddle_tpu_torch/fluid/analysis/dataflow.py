"""Def-use view of a program desc — the port's copy of ``ProgramView``
(with ``OpUse`` and ``BlockView``) from
``paddle_tpu/fluid/analysis/dataflow.py``, cut to what
``recompile.enumerate_buckets`` reads: per-op normalized reads and
writes with control-flow attribution (an op carrying a ``__block__``
attr accounts for its sub-block's external effects, the names its body
touches that the body does not declare, at the parent op's position),
cycle-safe against bogus sub-block references.  The ancestor
navigation, ``live_ops`` and ``block_liveness`` are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..core.desc import BlockDesc, OpDesc, ProgramDesc

__all__ = ["OpUse", "BlockView", "ProgramView"]


class OpUse:
    """One op's normalized dataflow footprint at its block position."""

    __slots__ = ("idx", "desc", "reads", "writes", "sub_blocks",
                 "sub_reads", "sub_writes", "_read_names", "_write_names")

    def __init__(self, idx: int, desc: OpDesc):
        self.idx = idx
        self.desc = desc
        # (slot, position-in-slot, name) triples
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
        self._read_names: Optional[Set[str]] = None
        self._write_names: Optional[Set[str]] = None

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
        # trust the LIST position, not the self-declared idx
        self.idx = pos
        self.parent_idx = desc.parent_idx
        self.desc = desc
        self.ops = [OpUse(i, od) for i, od in enumerate(desc.ops)]


class ProgramView:
    """Cycle-safe view over a ProgramDesc: its blocks' ops with their
    reads and writes."""

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
