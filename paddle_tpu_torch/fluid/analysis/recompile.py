"""Recompile-hazard lint + closed bucket-set enumeration — the port of
``paddle_tpu/fluid/analysis/recompile.py``.

The executor keys its executable cache (a captured CUDA graph per entry
on the card) on the full feed-shape signature (executor.py ``_sig_of``):
any feed whose concrete shape derives from runtime *values* rather than
a bucket-padded shape captures a fresh step per distinct value — the
churn the ``recompiles_after_warmup == 0`` serving contract forbids.  Because the program is data, the hazard is statically
visible in the descs:

* a feed var with a dynamic extent anywhere but the leading batch dim
  (each distinct inner extent is a new signature — nothing pads it);
* a ragged (``lod_level > 0``) feed whose padded time extent enters the
  signature unless bucketed (``make_seq(bucket=)`` / the engine's
  ``time_bucket``);
* ops whose *output* shape or LoD depends on input values
  (``VALUE_SHAPE_OPS``) — no amount of input padding closes their
  shape set, so they can never live inside a pre-captured bucket;
* a transient var with no recorded shape reached by shape inference —
  its extent is only knowable at run time.

The flip side is the **closed bucket set**: once every dynamic axis is
bucketed, the program's compilable signatures are a finite enumerable
product — exactly the set an ahead-of-time warm-up must cover.  :func:`enumerate_buckets` produces it; a
fully static program (the paged decode-step) enumerates to exactly ONE
signature, which is the static form of the zero-recompile guarantee.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .dataflow import ProgramView
from .diagnostics import ERROR, INFO, WARNING, Diagnostics, Finding

__all__ = ["VALUE_SHAPE_OPS", "feed_vars", "enumerate_buckets",
           "recompile_pass"]

# ops whose output shape/LoD is a function of input VALUES — the
# executor can run them (eagerly, per value), but they can never be part
# of a closed, pre-capturable bucket set
VALUE_SHAPE_OPS = {
    "beam_search_decode",    # LoD of the result depends on decoded ids
    "lod_rank_table",        # table extent = distinct lengths in input
    "array_length",          # value-dependent tensor-array extent
}


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
    time bucket — the InferenceEngine's padding model.  Returns one
    entry per (batch, time) combination with the concrete per-feed
    shapes; a program with no dynamic axes returns exactly one entry.
    An open axis (dynamic but no buckets declared for it) is returned
    symbolically (``None``) — the signature set is NOT closed and the
    caller (plint / an ahead-of-time warm-up) must treat it as a hazard.
    """
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


def recompile_pass(ctx, diag: Diagnostics) -> None:
    """Flag value-derived shapes and unbucketed dynamic axes; attach the
    enumerated bucket set (``diag.reports["recompile"]``).  Options:
    ``batch_buckets`` / ``time_buckets`` (sequences of ints) declare
    the padding the serving layer applies."""
    opts = getattr(ctx, "options", {}) or {}
    view = ctx.view
    batch_buckets = tuple(opts.get("batch_buckets", ()) or ())
    time_buckets = tuple(opts.get("time_buckets", ()) or ())

    hazards = 0
    for b in view.blocks:
        for op in b.ops:
            if op.type in VALUE_SHAPE_OPS:
                hazards += 1
                diag.add(Finding(
                    ERROR, "recompile", "value-shape-op",
                    f"op '{op.type}' derives its output shape/LoD from "
                    f"input VALUES — it cannot be bucket-padded and "
                    f"recompiles (or re-traces) per distinct value; "
                    f"keep it out of the compiled serving path",
                    block=b.idx, op=op.idx, op_type=op.type))

    feeds = feed_vars(view, 0) if view.blocks else {}
    for name, vd in feeds.items():
        dyn = _dyn_axes(vd)
        inner = [i for i in dyn if i != 0]
        if inner:
            hazards += 1
            diag.add(Finding(
                WARNING, "recompile", "dynamic-inner-dim",
                f"feed '{name}' has dynamic extent at dim(s) {inner} "
                f"(shape {vd.shape}) — each distinct extent compiles a "
                f"new executable; pad it to a declared bucket",
                block=0, var=name))
        if vd.lod_level > 0 and not time_buckets:
            diag.add(Finding(
                WARNING, "recompile", "ragged-feed",
                f"feed '{name}' is ragged (lod_level={vd.lod_level}); "
                f"its padded time extent enters the compile signature — "
                f"bucket it (make_seq(bucket=) / engine time_bucket) or "
                f"declare time_buckets for a closed bucket set",
                block=0, var=name))
        if 0 in dyn and not batch_buckets:
            diag.add(Finding(
                INFO, "recompile", "open-batch-axis",
                f"feed '{name}' is batch-dynamic with no declared batch "
                f"buckets — the bucket set is open (fine for training; "
                f"a serving/AOT path must declare batch_buckets)",
                block=0, var=name))

    # transient vars shape inference could not pin: their extents are
    # runtime values, so the signature (or the donated temps) can drift
    for b in view.blocks:
        written = {n for op in b.ops for n in op.write_names()}
        for name, vd in b.desc.vars.items():
            if vd.persistable or name not in written:
                continue
            from ..core.types import VarType

            if vd.type in (VarType.DENSE_TENSOR, VarType.LOD_TENSOR) \
                    and vd.shape is None:
                diag.add(Finding(
                    WARNING, "recompile", "unpinned-shape",
                    f"var '{name}' is written but has no recorded "
                    f"shape — its extent is only knowable at run time",
                    block=b.idx, var=name))

    buckets = enumerate_buckets(view, batch_buckets, time_buckets) \
        if view.blocks else []
    closed = all(e["closed"] for e in buckets) and not hazards
    diag.reports["recompile"] = {
        "hazards": hazards,
        "closed": closed,
        "bucket_count": len(buckets),
        "bucket_set": buckets,
    }
    if closed:
        diag.add(Finding(
            INFO, "recompile", "bucket-set",
            f"closed bucket set: {len(buckets)} compilable "
            f"signature(s)"
            + (" — fully static, the zero-recompile steady state"
               if len(buckets) == 1 else "")))
    else:
        diag.add(Finding(
            INFO, "recompile", "bucket-set",
            f"bucket set is OPEN ({len(buckets)} enumerated "
            f"signature(s), {hazards} hazard(s)) — an AOT cache cannot "
            f"pre-compile this program exhaustively"))
