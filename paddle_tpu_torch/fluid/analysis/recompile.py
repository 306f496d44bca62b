"""Closed bucket-set enumeration — the port's copy of ``feed_vars`` and
``enumerate_buckets`` from ``paddle_tpu/fluid/analysis/recompile.py``.

The executor keys its executable cache (a captured CUDA graph per entry
on the card) on the full feed-shape signature, so the signatures a
program can compile to are statically visible in its desc: once every
dynamic axis is bucketed they are a finite product, exactly the set an
ahead-of-time warm-up must cover.  A fully static program (the paged
serving step at a lane count) enumerates to exactly ONE signature.  The
recompile-hazard lint (``recompile_pass``, ``VALUE_SHAPE_OPS``) is not
ported.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .dataflow import ProgramView

__all__ = ["feed_vars", "enumerate_buckets"]


def feed_vars(view: ProgramView, block_idx: int = 0) -> Dict[str, Any]:
    """The step's feed surface: vars declared in the block that are read
    but never written and not persistable (the executor feeds exactly
    these)."""
    b = view.blocks[block_idx]
    # explicit feed ops (deserialized inference programs) name their
    # target outright; their write must not hide the var from the
    # read-never-written classification below
    explicit: List[str] = []
    for op in b.ops:
        if op.type == "feed":
            for n in op.write_names():
                if n in b.desc.vars and n not in explicit:
                    explicit.append(n)
    written = {n for op in b.ops if op.type != "feed"
               for n in op.write_names()}
    reads: List[str] = list(explicit)
    for op in b.ops:
        for n in op.read_names():
            if n not in written and n in b.desc.vars \
                    and not b.desc.vars[n].persistable and n not in reads:
                reads.append(n)
    return {n: b.desc.vars[n] for n in reads}


def _dyn_axes(vd) -> List[int]:
    if vd.shape is None:
        return []
    return [i for i, d in enumerate(vd.shape) if d is None or d < 0]


def enumerate_buckets(view: ProgramView,
                      batch_buckets: Sequence[int] = (),
                      time_buckets: Sequence[int] = (),
                      block_idx: int = 0) -> List[Dict[str, Any]]:
    """Enumerate the closed set of feed signatures this program can
    compile to, given the declared bucket axes.

    Every batch-dynamic feed (dim 0 == -1) pads to one shared batch
    bucket; every ragged (``lod_level > 0``) feed pads to one shared
    time bucket.  Returns one entry per (batch, time) combination with
    the concrete per-feed shapes; a program with no dynamic axes returns
    exactly one entry.  An open axis (dynamic but no buckets declared
    for it) is returned symbolically (``None``) and the entry is not
    ``closed``."""
    feeds = feed_vars(view, block_idx)
    batch_dynamic = any(0 in _dyn_axes(vd) for vd in feeds.values())
    ragged = any(vd.lod_level > 0 for vd in feeds.values())
    b_choices: List[Optional[int]] = (
        [int(x) for x in sorted(set(batch_buckets))]
        if batch_dynamic and batch_buckets
        else [None] if batch_dynamic else [1])
    t_choices: List[Optional[int]] = (
        [int(x) for x in sorted(set(time_buckets))]
        if ragged and time_buckets else [None] if ragged else [0])

    out: List[Dict[str, Any]] = []
    for bb in b_choices:
        for tb in t_choices:
            shapes: Dict[str, Any] = {}
            closed = True
            for name, vd in feeds.items():
                shape = list(vd.shape) if vd.shape is not None else None
                if shape is not None:
                    for i, d in enumerate(shape):
                        if d is not None and d >= 0:
                            continue
                        if i == 0:
                            shape[i] = bb
                            closed = closed and bb is not None
                        else:
                            shape[i] = None
                            closed = False
                if vd.lod_level > 0:
                    # padded SeqArray: [batch, time, *dims]
                    time = tb
                    closed = closed and tb is not None
                    shape = ([shape[0] if shape else bb, time]
                             + (shape[1:] if shape else []))
                shapes[name] = {"shape": shape, "dtype": vd.dtype,
                                "lod_level": vd.lod_level}
            out.append({"batch": bb, "time": tb or None,
                        "closed": closed, "feeds": shapes})
    return out
