"""The analysis pass suite over ProgramDesc — the port of
``paddle_tpu/fluid/analysis/passes.py``.

Five passes share the ``ProgramView`` def-use infrastructure (dataflow.py)
and emit into one ``Diagnostics`` report (diagnostics.py):

* ``structural``  — var visibility / parent sanity / sub-block indices;
  string-for-string the same findings as the reference's validator.
* ``dataflow``    — use-before-write, double-write within one op,
  dead (unreachable) ops and unused vars.
* ``grad_link``   — every ``X@GRAD`` traces to a forward ``X``; every
  ``*_grad`` op's base op is registered and instantiated.
* ``sharding``    — per-dim mesh-axis annotations are well-formed and
  consistent across producer/consumer pairs; host IO never reads a
  transient value past the executor's donation point.
* ``shape_check`` — abstract re-execution of the registry's emitters
  on ``meta`` tensors (the procedure framework.Block._infer_op runs at
  build time) over an already-built/deserialized program, diffed
  against the recorded VarDesc shape/dtype — the check that catches the
  ``infer_shape=False`` holes left by backward.py and hand-edited or
  corrupted serialized programs.  The reference runs its emitters under
  ``jax.eval_shape``; a meta tensor carries a shape and a dtype and no
  data, so the same emitters run here without touching a device.

The cost family (``cost``, ``recompile``, ``comms``) lives in its own
modules and registers here like any pass.  The reference's
``shardprop`` pass (whole-program sharding propagation) is not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

from ..core.registry import GRAD_SUFFIX, get_op_info, has_op
from ..core.types import VarType, canonical_dtype
from .dataflow import (CONTROL_FLOW_OPS, HOST_IO_OPS, ProgramView,
                       live_ops)
from .diagnostics import ERROR, INFO, WARNING, Diagnostics, Finding

__all__ = ["AnalysisContext", "PASSES", "structural_pass", "dataflow_pass",
           "grad_link_pass", "sharding_pass", "shape_check_pass",
           "cost_pass", "recompile_pass", "comms_pass"]


class AnalysisContext:
    """Everything a pass needs: the raw desc, the shared view, the
    fetch roots (vars the caller intends to read — executor fetch_list /
    plint --fetch), and free-form ``options`` the cost-family passes
    read (assume_batch, chip, budget_bytes, batch/time_buckets,
    mesh_axes, dcn_axes — see cost.py / recompile.py / comms.py)."""

    def __init__(self, desc, fetch: Sequence[str] = (),
                 fetch_given: bool = False,
                 options: Optional[Dict] = None):
        self.desc = desc
        self.view = ProgramView(desc)
        self.fetch = tuple(fetch)
        self.fetch_given = fetch_given or bool(fetch)
        self.options = dict(options or {})


# ---------------------------------------------------------------------------
# structural — parity with the reference's validate_program
# ---------------------------------------------------------------------------

def structural_pass(ctx: AnalysisContext, diag: Diagnostics) -> None:
    """Var visibility + block-graph sanity.  Message strings (via
    Finding.legacy()) stay byte-identical to the reference's."""
    blocks = ctx.desc.blocks
    nblocks = len(blocks)
    if nblocks == 0:
        diag.add(Finding(ERROR, "structural", "no-blocks",
                         "program has no blocks"))
        return
    for b in blocks:
        # parent must come earlier (rules out cycles; self-declared idx,
        # exactly like the reference's walk)
        parent_ok = b.parent_idx < b.idx
        if b.parent_idx >= nblocks or not parent_ok:
            diag.add(Finding(ERROR, "structural", "bad-parent",
                             "parent_idx out of range or not an ancestor",
                             block=b.idx))

        def visible(name: str) -> bool:
            cur, hops = b, 0
            while cur is not None and hops <= nblocks:
                hops += 1
                if name in cur.vars:
                    return True
                cur = (blocks[cur.parent_idx]
                       if 0 <= cur.parent_idx < min(cur.idx, nblocks)
                       else None)
            return False

        for oi, od in enumerate(b.ops):
            if not od.type:
                diag.add(Finding(ERROR, "structural", "empty-op-type",
                                 "empty op type", block=b.idx, op=oi,
                                 op_type=od.type))
            for slot, names in od.inputs.items():
                for pos, n in enumerate(names):
                    if n and not visible(n):
                        diag.add(Finding(
                            ERROR, "structural", "undeclared-input",
                            f"input var '{n}' not declared",
                            block=b.idx, op=oi, op_type=od.type,
                            slot=f"{slot}#{pos}", var=n))
            for slot, names in od.outputs.items():
                for pos, n in enumerate(names):
                    if n and not visible(n):
                        diag.add(Finding(
                            ERROR, "structural", "undeclared-output",
                            f"output var '{n}' not declared",
                            block=b.idx, op=oi, op_type=od.type,
                            slot=f"{slot}#{pos}", var=n))
            for a in od.attrs.values():
                if isinstance(a, dict) and "__block__" in a:
                    bi = a["__block__"]
                    if not (isinstance(bi, int) and 0 <= bi < nblocks):
                        diag.add(Finding(
                            ERROR, "structural", "bad-sub-block",
                            f"sub-block index {bi} out of range",
                            block=b.idx, op=oi, op_type=od.type))


# ---------------------------------------------------------------------------
# dataflow — use-before-write / double write / dead code
# ---------------------------------------------------------------------------

def dataflow_pass(ctx: AnalysisContext, diag: Diagnostics) -> None:
    view = ctx.view
    fetch_set = set(ctx.fetch)
    for b in view.blocks:
        local = b.desc.vars
        first_write: Dict[str, int] = {}
        for op in b.ops:
            for n in op.write_names():
                first_write.setdefault(n, op.idx)
        reported_feed: Set[str] = set()
        for op in b.ops:
            # write-after-write to the same var within ONE op
            seen_out: Dict[str, str] = {}
            for slot, pos, n in op.writes:
                at = f"{slot}#{pos}"
                if n in seen_out:
                    diag.add(Finding(
                        ERROR, "dataflow", "write-after-write",
                        f"output var '{n}' is written twice by one op "
                        f"(slots {seen_out[n]} and {at})",
                        block=b.idx, op=op.idx, op_type=op.type,
                        slot=at, var=n))
                else:
                    seen_out[n] = at
            # use-before-write (vars DECLARED here; ancestor-declared reads
            # are scope-chain state, persistables are scope state)
            for slot, pos, n in op.reads:
                vd = local.get(n)
                if vd is None or vd.persistable or n.startswith("@STATE@"):
                    continue
                fw = first_write.get(n)
                if fw is None:
                    if n not in reported_feed:
                        reported_feed.add(n)
                        diag.add(Finding(
                            INFO, "dataflow", "assumed-feed",
                            f"var '{n}' is read but never written in this "
                            f"program; assumed to be fed or scope state",
                            block=b.idx, op=op.idx, op_type=op.type,
                            slot=f"{slot}#{pos}", var=n))
                elif fw > op.idx:
                    diag.add(Finding(
                        ERROR, "dataflow", "use-before-write",
                        f"var '{n}' is read before its first write "
                        f"(first written by op#{fw})",
                        block=b.idx, op=op.idx, op_type=op.type,
                        slot=f"{slot}#{pos}", var=n))
                elif fw == op.idx and n in {w for _, _, w in op.writes}:
                    diag.add(Finding(
                        WARNING, "dataflow", "in-place-first-touch",
                        f"op reads and writes '{n}' but nothing wrote it "
                        f"earlier — the read becomes a scope state load",
                        block=b.idx, op=op.idx, op_type=op.type, var=n))

    # dead (unreachable) ops: nothing transitively side-effecting,
    # persistable, escaping, or fetched reads their outputs.  Without fetch
    # roots the intent is unknowable (a forward program's last op is
    # usually the fetch target), so findings downgrade to info.
    live = live_ops(view, ctx.fetch)
    dead_sev = WARNING if ctx.fetch_given else INFO
    for b in view.blocks:
        for op in b.ops:
            if (b.idx, op.idx) in live:
                continue
            outs = sorted(op.write_names())
            diag.add(Finding(
                dead_sev, "dataflow", "dead-op",
                f"op outputs {outs} are never read, not persistable, and "
                f"not fetched (dead op)",
                block=b.idx, op=op.idx, op_type=op.type))

    # unused vars: declared but neither read nor written anywhere
    used: Set[str] = set()
    for b in view.blocks:
        for op in b.ops:
            used |= op.read_names() | op.write_names()
    for b in view.blocks:
        for n, vd in b.desc.vars.items():
            if n in used or vd.persistable or n in fetch_set:
                continue
            diag.add(Finding(INFO, "dataflow", "unused-var",
                             f"var '{n}' is declared but never used",
                             block=b.idx, var=n))


# ---------------------------------------------------------------------------
# grad_link — backward-graph lint
# ---------------------------------------------------------------------------

def grad_link_pass(ctx: AnalysisContext, diag: Diagnostics) -> None:
    view = ctx.view
    fwd_op_types: Set[str] = {op.type for b in view.blocks for op in b.ops}
    for b in view.blocks:
        for name in b.desc.vars:
            if GRAD_SUFFIX not in name:
                continue
            base = name.split(GRAD_SUFFIX)[0]
            if base and view.visible_var(b.idx, base) is None:
                diag.add(Finding(
                    ERROR, "grad_link", "orphan-grad",
                    f"gradient var '{name}' has no forward var "
                    f"'{base}' in scope",
                    block=b.idx, var=name))
        for op in b.ops:
            if not op.type.endswith("_grad"):
                continue
            base = op.type[: -len("_grad")]
            if not has_op(base):
                diag.add(Finding(
                    ERROR, "grad_link", "grad-base-unregistered",
                    f"grad op's base op '{base}' is not registered",
                    block=b.idx, op=op.idx, op_type=op.type))
            elif base not in fwd_op_types:
                diag.add(Finding(
                    WARNING, "grad_link", "grad-base-missing",
                    f"no forward '{base}' op exists in the program",
                    block=b.idx, op=op.idx, op_type=op.type))


# ---------------------------------------------------------------------------
# sharding + donation safety
# ---------------------------------------------------------------------------

def _fmt_sharding(s) -> str:
    return "(" + ", ".join(a if a else "-" for a in s) + ")"


def sharding_pass(ctx: AnalysisContext, diag: Diagnostics) -> None:
    view = ctx.view

    def producer_of(bidx: int, name: str, before: Optional[int]):
        """Last op writing ``name`` in its owner block (before the
        consumer when both live in the same block)."""
        owner = view.owner_block(bidx, name)
        if owner is None:
            return None, None
        limit = before if owner == bidx else None
        found = None
        for op in view.blocks[owner].ops:
            if limit is not None and op.idx >= limit:
                break
            if name in op.write_names():
                found = op
        return owner, found

    seen_pairs = set()
    for b in view.blocks:
        for name, vd in b.desc.vars.items():
            sh = vd.sharding
            if sh is None:
                continue
            if vd.shape is not None and len(sh) != len(vd.shape):
                diag.add(Finding(
                    ERROR, "sharding", "rank-mismatch",
                    f"var '{name}' has {len(vd.shape)} dims but its "
                    f"sharding {_fmt_sharding(sh)} names {len(sh)} dims",
                    block=b.idx, var=name))
            axes = [a for a in sh if a]
            dup = {a for a in axes if axes.count(a) > 1}
            if dup:
                diag.add(Finding(
                    ERROR, "sharding", "axis-reuse",
                    f"var '{name}' sharding {_fmt_sharding(sh)} uses mesh "
                    f"axis {sorted(dup)} on more than one dim",
                    block=b.idx, var=name))
        for op in b.ops:
            # producer/consumer consistency across aliasing pairs:
            # assign X->Out copies the value, optimizer ops pair Param
            # with Grad (the grad all-reduce layout must match the param)
            pairs = []
            if op.type == "assign":
                ins, outs = op.desc.input("X"), op.desc.output("Out")
                pairs += list(zip(ins, outs))
            if "Param" in op.desc.inputs and "Grad" in op.desc.inputs:
                pairs += list(zip(op.desc.input("Param"),
                                  op.desc.input("Grad")))
            for a, c in pairs:
                va = view.visible_var(b.idx, a)
                vc = view.visible_var(b.idx, c)
                if va is None or vc is None:
                    continue
                if va.sharding is not None and vc.sharding is not None \
                        and list(va.sharding) != list(vc.sharding):
                    # one finding per var pair, however many blocks the
                    # pair recurs in (while bodies clone these ops)
                    if (a, c) in seen_pairs:
                        continue
                    seen_pairs.add((a, c))
                    pb, pop = producer_of(b.idx, a, op.idx)
                    where_p = (f"block {pb} op#{pop.idx} ({pop.type})"
                               if pop is not None else
                               f"block {pb if pb is not None else b.idx}"
                               f" (no producing op)")
                    diag.add(Finding(
                        ERROR, "sharding", "producer-consumer-conflict",
                        f"'{a}' sharded {_fmt_sharding(va.sharding)} "
                        f"(producer {where_p}) but '{c}' sharded "
                        f"{_fmt_sharding(vc.sharding)} (consumer block "
                        f"{b.idx} op#{op.idx} ({op.type})) — per-dim "
                        f"mesh axes must agree across "
                        f"producer/consumer",
                        block=b.idx, op=op.idx, op_type=op.type, var=c))

    # donation safety (global block only — that is the step the executor
    # runs host IO around): after the step only persistable/state values
    # survive in the scope; transient intermediates live inside the step
    # (its captured graph's buffers on the card).
    gb = view.blocks[0] if view.blocks else None
    if gb is None:
        return
    traced = [op.idx for op in gb.ops if op.type not in HOST_IO_OPS]
    if traced:
        lo, hi = traced[0], traced[-1]
        for op in gb.ops:
            if op.type in HOST_IO_OPS and lo < op.idx < hi:
                diag.add(Finding(
                    ERROR, "sharding", "host-io-interleaved",
                    f"host IO op '{op.type}' is interleaved between "
                    f"compute ops (op#{lo}..op#{hi}); the executor "
                    f"rejects this — move it to the block boundary",
                    block=gb.idx, op=op.idx, op_type=op.type))
    traced_writes = {n for op in gb.ops if op.type not in HOST_IO_OPS
                     for n in op.write_names()}
    for op in gb.ops:
        if op.type not in ("save", "save_combine"):
            continue
        for slot, pos, n in op.reads:
            vd = view.visible_var(gb.idx, n)
            if vd is None or vd.persistable or n.startswith("@STATE@"):
                continue
            if n in traced_writes:
                diag.add(Finding(
                    ERROR, "sharding", "donation-read",
                    f"'{op.type}' reads transient var '{n}' past the "
                    f"executor's donation point — only persistable/state "
                    f"values survive the compiled segment's buffer "
                    f"donation; mark it persistable or fetch it instead",
                    block=gb.idx, op=op.idx, op_type=op.type,
                    slot=f"{slot}#{pos}", var=n))


# ---------------------------------------------------------------------------
# shape_check — abstract re-execution of the emitters
# ---------------------------------------------------------------------------

# build-time skip list (framework._NO_INFER_OPS) + control flow + array ops
# whose emitters need a live block lowerer or runtime-only values
_SKIP_INFER_OPS = CONTROL_FLOW_OPS | HOST_IO_OPS | {
    "feed", "fetch", "print", "read_from_array", "write_to_array",
    "array_length", "lod_rank_table", "beam_search", "beam_search_decode",
}
# dtypes the runtime narrows on device — recorded vs computed pairs that
# are NOT a defect (core.types.runtime_dtype)
_NARROWED = {("int64", "int32"), ("float64", "float32")}


class _SkipOp(Exception):
    pass


def _abstract_of(vd):
    """Meta value from a VarDesc, via the SAME encoding build-time
    inference uses (framework.abstract_from_meta) — sharing the helper is
    what guarantees the re-check re-runs the recorded procedure."""
    from ..framework import abstract_from_meta

    if vd.type not in (VarType.DENSE_TENSOR, VarType.LOD_TENSOR,
                       VarType.SELECTED_ROWS):
        raise _SkipOp(f"var '{vd.name}' has opaque type {vd.type}")
    if vd.shape is None:
        raise _SkipOp(f"var '{vd.name}' has no recorded shape")
    try:
        return abstract_from_meta(vd.shape, vd.dtype, vd.lod_level,
                                  name=vd.name)
    except NotImplementedError as e:       # a level-2 sequence var
        raise _SkipOp(str(e)) from e


def _dtype_matches(recorded: str, computed: str) -> bool:
    r, c = canonical_dtype(recorded), canonical_dtype(computed)
    return r == c or (r, c) in _NARROWED


def _check_grad_op(ctx, b, op, diag) -> None:
    """Positional rule for ``*_grad`` ops (which backward.py appends with
    infer_shape=False): the vjp guarantees grad-of-input[pos] has the
    exact shape/dtype of forward input[pos] in the same slot."""
    view = ctx.view
    for out_slot, names in op.desc.outputs.items():
        if not out_slot.endswith(GRAD_SUFFIX):
            continue
        fwd_names = op.desc.inputs.get(out_slot[: -len(GRAD_SUFFIX)], [])
        for pos, gname in enumerate(names):
            if not gname or pos >= len(fwd_names) or not fwd_names[pos]:
                continue
            gvd = view.visible_var(b.idx, gname)
            fvd = view.visible_var(b.idx, fwd_names[pos])
            if gvd is None or fvd is None:
                continue            # structural pass owns undeclared vars
            if gvd.shape is not None and fvd.shape is not None \
                    and list(gvd.shape) != list(fvd.shape):
                diag.add(Finding(
                    ERROR, "shape_check", "grad-shape-mismatch",
                    f"gradient '{gname}' records shape {gvd.shape} but "
                    f"its forward var '{fwd_names[pos]}' has shape "
                    f"{fvd.shape}",
                    block=b.idx, op=op.idx, op_type=op.type,
                    slot=f"{out_slot}#{pos}", var=gname))
            if not _dtype_matches(fvd.dtype, gvd.dtype) \
                    and not _dtype_matches(gvd.dtype, fvd.dtype):
                diag.add(Finding(
                    ERROR, "shape_check", "grad-dtype-mismatch",
                    f"gradient '{gname}' records dtype {gvd.dtype} but "
                    f"its forward var '{fwd_names[pos]}' is {fvd.dtype}",
                    block=b.idx, op=op.idx, op_type=op.type,
                    slot=f"{out_slot}#{pos}", var=gname))


def shape_check_pass(ctx: AnalysisContext, diag: Diagnostics) -> None:
    import torch

    from ..core.registry import EmitCtx
    from ..framework import _DUMMY_BATCH, reduce_abstract

    view = ctx.view
    for b in view.blocks:
        for op in b.ops:
            od = op.desc
            if od.type in _SKIP_INFER_OPS or op.sub_blocks:
                continue
            if od.type.endswith("_grad"):
                _check_grad_op(ctx, b, op, diag)
                continue
            if not has_op(od.type):
                diag.add(Finding(
                    ERROR, "shape_check", "unregistered-op",
                    f"op type '{od.type}' is not registered — the "
                    f"executor cannot lower it",
                    block=b.idx, op=op.idx, op_type=od.type))
                continue
            info = get_op_info(od.type)
            # abstract inputs from the recorded descs
            try:
                abstract_ins: Dict[str, list] = {}
                batch_dyn = False
                for slot, names in od.inputs.items():
                    vals = []
                    for n in names:
                        if not n:
                            continue
                        vd = view.visible_var(b.idx, n)
                        if vd is None:
                            raise _SkipOp(f"input '{n}' undeclared")
                        try:
                            vals.append(_abstract_of(vd))
                        except ValueError as e:
                            raise _SkipOp(str(e)) from e
                        batch_dyn = batch_dyn or (
                            vd.shape is not None and len(vd.shape) > 0
                            and vd.shape[0] == -1)
                    if vals:
                        abstract_ins[slot] = vals
            except _SkipOp as e:
                diag.add(Finding(
                    INFO, "shape_check", "recheck-skipped",
                    f"shape re-check skipped: {e}",
                    block=b.idx, op=op.idx, op_type=od.type))
                continue

            try:
                with torch.no_grad():
                    out_abs = info.emit(
                        EmitCtx(od, device=torch.device("meta")),
                        abstract_ins)
            except Exception as e:
                diag.add(Finding(
                    INFO, "shape_check", "recheck-skipped",
                    f"shape re-check skipped: emitter not abstractly "
                    f"evaluable ({type(e).__name__}: {e})",
                    block=b.idx, op=op.idx, op_type=od.type))
                continue

            for slot, names in od.outputs.items():
                for pos, (n, av) in enumerate(zip(names,
                                                  out_abs.get(slot, []))):
                    if not n:
                        continue
                    red = reduce_abstract(av)
                    if red is None:
                        continue            # opaque (RankTable, ...)
                    shape, dt, _lod = red   # reduce as _infer_op records
                    if batch_dyn and shape and shape[0] == _DUMMY_BATCH:
                        shape[0] = -1
                    vd = view.visible_var(b.idx, n)
                    if vd is None:
                        continue        # structural pass owns this
                    if vd.shape is None:
                        diag.add(Finding(
                            INFO, "shape_check", "no-recorded-shape",
                            f"output '{n}' has no recorded shape; "
                            f"inference says {shape}",
                            block=b.idx, op=op.idx, op_type=od.type,
                            slot=f"{slot}#{pos}", var=n))
                        continue
                    if list(vd.shape) != shape:
                        diag.add(Finding(
                            ERROR, "shape_check", "shape-mismatch",
                            f"var '{n}' records shape {vd.shape} but "
                            f"re-running '{od.type}' inference yields "
                            f"{shape}",
                            block=b.idx, op=op.idx, op_type=od.type,
                            slot=f"{slot}#{pos}", var=n))
                    if not _dtype_matches(vd.dtype, dt):
                        diag.add(Finding(
                            ERROR, "shape_check", "dtype-mismatch",
                            f"var '{n}' records dtype {vd.dtype} but "
                            f"re-running '{od.type}' inference yields "
                            f"{dt}",
                            block=b.idx, op=op.idx, op_type=od.type,
                            slot=f"{slot}#{pos}", var=n))


# the cost-family passes live in their own modules; they share
# AnalysisContext/Diagnostics and register here like any pass
from .comms import comms_pass                              # noqa: E402
from .cost import cost_pass                                # noqa: E402
from .recompile import recompile_pass                      # noqa: E402

# ordered registry: cheap structural truths first, emitter runs last
PASSES = [
    ("structural", structural_pass),
    ("dataflow", dataflow_pass),
    ("grad_link", grad_link_pass),
    ("sharding", sharding_pass),
    ("shape_check", shape_check_pass),
    ("cost", cost_pass),
    ("recompile", recompile_pass),
    ("comms", comms_pass),
]
