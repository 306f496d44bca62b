"""Sharded-program collective-traffic estimator (ICI vs DCN) — the port
of ``paddle_tpu/fluid/analysis/comms.py``.

A sharded program annotates its persistables with per-dim mesh-axis
shardings (``VarDesc.sharding``); the partitioner that runs it inserts
the collectives those shardings imply.  This pass predicts that traffic
from the descs alone:

* **tensor-parallel partial sums** — a matmul family op whose
  *contracted* dims are sharded over a mesh axis produces partial
  results that all-reduce the output over that axis;
* **data-parallel gradient sync** — with a batch axis in the mesh,
  every replicated parameter's gradient all-reduces over it once per
  step (the report also prices the int8/block-scaled variant of exactly
  these bytes, EQuARX, PAPERS.md arxiv 2506.17615).

Traffic classifies per axis as ICI (the links between the cards of one
host: NVLink) or DCN (the network between hosts) via the ``dcn_axes``
option — the axis that spans hosts is declared, not guessed.  Wire
bytes use the ring all-reduce identity ``2*(n-1)/n * payload`` per
participant, priced at the chip spec's per-tier bandwidth.  The pass is
desc-only: the port builds no sharded program yet (ROADMAP A15), so it
prices sharded descs from the reference, and is silent on unsharded
programs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .cost import get_chip, var_bytes
from .dataflow import ProgramView
from .diagnostics import INFO, WARNING, Diagnostics, Finding

__all__ = ["comms_pass", "estimate_comms", "CommsReport", "WIRE_RULES"]

# mesh axes conventionally used for batch sharding (the reference's
# parallel/mesh.py _dp_axes + its transpiler's dp default)
BATCH_AXES = ("dp", "batch")

_MATMUL_FAMILY = ("mul", "matmul", "quantized_mul", "quantized_matmul")


def _ring_wire_bytes(payload: float, n: int) -> float:
    n = max(2, int(n))
    return 2.0 * (n - 1) / n * payload


def _shuffle_wire_bytes(payload: float, n: int) -> float:
    """all-gather / reduce-scatter / all-to-all: each participant moves
    (n-1)/n of the payload once (half a ring all-reduce)."""
    n = max(2, int(n))
    return (n - 1) / n * payload


# per-collective-kind wire-byte rules (ring algorithms, per participant;
# the kinds keep the reference's HLO names)
WIRE_RULES = {
    "all-reduce": _ring_wire_bytes,
    "all-gather": _shuffle_wire_bytes,
    "reduce-scatter": _shuffle_wire_bytes,
    "all-to-all": _shuffle_wire_bytes,
}


def _hlo_kind_of(entry: Dict) -> str:
    k = entry.get("hlo_kind")
    if k:
        return str(k)
    # legacy heuristic entries: "allreduce(partial-sum)" etc.
    return "all-reduce" if "allreduce" in str(entry.get("kind", "")) \
        else str(entry.get("kind", "all-reduce"))


class CommsReport:
    __slots__ = ("per_axis", "per_kind", "ici_bytes", "dcn_bytes",
                 "ici_time_s", "dcn_time_s", "grad_sync_bytes",
                 "collectives", "axis_sizes", "dcn_axes",
                 "quantized_dcn_bytes")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "per_axis": {a: dict(d) for a, d in self.per_axis.items()},
            # per-collective-kind subtotals so a differential rel_err
            # gate can say *which* kind diverged
            "per_kind": {k: dict(d) for k, d in self.per_kind.items()},
            "ici_bytes": self.ici_bytes,
            "dcn_bytes": self.dcn_bytes,
            "ici_time_s": self.ici_time_s,
            "dcn_time_s": self.dcn_time_s,
            "grad_sync_bytes": self.grad_sync_bytes,
            "collectives": list(self.collectives),
            "axis_sizes": dict(self.axis_sizes),
            "dcn_axes": sorted(self.dcn_axes),
            # EQuARX framing: the same all-reduces with int8 payloads +
            # per-block fp32 scales (~1/32 overhead) over the DCN tier
            "int8_quantized_dcn_bytes": self.quantized_dcn_bytes,
        }


def _axis_sizes(view: ProgramView, opts: Dict) -> Dict[str, int]:
    """Mesh axis extents: the explicit option, then the axes the
    program's shardings name, at an assumed size of 2 (recorded in the
    report — byte totals are weakly sensitive to n via 2*(n-1)/n).  The
    reference also reads an active device mesh; the port has none."""
    sizes = dict(opts.get("mesh_axes") or {})
    named = set()
    for b in view.blocks:
        for vd in b.desc.vars.values():
            for ax in (vd.sharding or ()):
                if ax:
                    named.add(ax.rstrip("?"))
    for ax in named:
        sizes.setdefault(ax, 2)
    return sizes


def estimate_comms(view_or_program, chip=None,
                   options: Optional[Dict] = None) -> CommsReport:
    view = view_or_program if isinstance(view_or_program, ProgramView) \
        else ProgramView(getattr(view_or_program, "desc", view_or_program))
    opts = options or {}
    chip = get_chip(opts.get("chip") if "chip" in opts else chip)
    assume_batch = int(opts.get("assume_batch", 1))
    dcn_axes = {str(a) for a in (opts.get("dcn_axes") or ())}
    sizes = _axis_sizes(view, opts)

    rep = CommsReport.__new__(CommsReport)
    rep.per_axis = {}
    rep.per_kind = {}
    rep.collectives = []
    rep.axis_sizes = sizes
    rep.dcn_axes = dcn_axes
    rep.grad_sync_bytes = 0.0

    def record(axis: str, kind: str, payload: float, where: str,
               hlo_kind: str = "all-reduce") -> None:
        n = sizes.get(axis, 2)
        wire = WIRE_RULES.get(hlo_kind, _ring_wire_bytes)(payload, n)
        d = rep.per_axis.setdefault(
            axis, {"count": 0, "payload_bytes": 0.0, "wire_bytes": 0.0,
                   "tier": "dcn" if axis in dcn_axes else "ici"})
        d["count"] += 1
        d["payload_bytes"] += payload
        d["wire_bytes"] += wire
        k = rep.per_kind.setdefault(
            hlo_kind, {"count": 0, "payload_bytes": 0.0,
                       "wire_bytes": 0.0})
        k["count"] += 1
        k["payload_bytes"] += payload
        k["wire_bytes"] += wire
        rep.collectives.append({"axis": axis, "kind": kind,
                                "hlo_kind": hlo_kind,
                                "payload_bytes": payload, "at": where})

    # an inferred collective graph (the reference's shardprop pass,
    # passed as the ``collectives`` option) replaces the heuristic scan
    # below outright: every entry is already placed and sized
    inferred = opts.get("collectives")
    if inferred is not None:
        for e in inferred:
            hk = _hlo_kind_of(e)
            payload = float(e.get("payload_bytes", 0.0))
            record(str(e.get("axis", "")), str(e.get("kind", hk)),
                   payload, str(e.get("at", "")), hlo_kind=hk)
            if e.get("grad"):
                rep.grad_sync_bytes += payload
        rep.ici_bytes = sum(d["wire_bytes"]
                            for a, d in rep.per_axis.items()
                            if a not in dcn_axes)
        rep.dcn_bytes = sum(d["wire_bytes"]
                            for a, d in rep.per_axis.items()
                            if a in dcn_axes)
        rep.ici_time_s = rep.ici_bytes / chip.ici_bw if chip.ici_bw \
            else 0.0
        rep.dcn_time_s = rep.dcn_bytes / chip.dcn_bw if chip.dcn_bw \
            else 0.0
        rep.quantized_dcn_bytes = rep.dcn_bytes / 4.0 * (1.0 + 4.0 / 32.0)
        return rep

    def sharded_axes(name: str, block_idx: int, dims) -> List[str]:
        vd = view.visible_var(block_idx, name)
        if vd is None or vd.sharding is None:
            return []
        out = []
        for i in dims:
            if 0 <= i < len(vd.sharding) and vd.sharding[i]:
                out.append(vd.sharding[i].rstrip("?"))
        return out

    # tensor-parallel partial sums: contraction over a sharded dim
    for b in view.blocks:
        for op in b.ops:
            od = op.desc
            if od.type not in _MATMUL_FAMILY:
                continue
            x = (od.inputs.get("X") or [""])[0]
            y = (od.inputs.get("Y") or [""])[0]
            xvd = view.visible_var(b.idx, x)
            if xvd is None or xvd.shape is None:
                continue
            nx = len(xvd.shape)
            if od.type in ("mul", "quantized_mul"):
                xd = int(od.attrs.get("x_num_col_dims", 1))
                yd = int(od.attrs.get("y_num_col_dims", 1))
                x_contract = list(range(xd, nx))
                y_contract = list(range(yd))
            else:
                tx = bool(od.attrs.get("transpose_X", False))
                ty = bool(od.attrs.get("transpose_Y", False))
                x_contract = [nx - 2 if tx else nx - 1]
                yvd = view.visible_var(b.idx, y)
                ny = len(yvd.shape) if yvd is not None and yvd.shape \
                    else 2
                y_contract = [ny - 1 if ty else ny - 2]
            axes = set(sharded_axes(x, b.idx, x_contract)
                       + sharded_axes(y, b.idx, y_contract))
            for out_slot in od.outputs.values():
                for out_name in out_slot:
                    payload, _ = var_bytes(
                        view.visible_var(b.idx, out_name), assume_batch)
                    for ax in axes:
                        record(ax, "allreduce(partial-sum)",
                               float(payload),
                               f"block {b.idx} op#{op.idx} ({od.type})")

    # data-parallel gradient sync: one all-reduce per parameter whose
    # gradient is produced, over every batch axis present in the mesh
    batch_axes = [a for a in sizes if a in BATCH_AXES]
    if batch_axes:
        # one sync per base param, however many @GRAD/@RENAME aliases
        # backward.py emitted for it
        bases: Dict[str, int] = {}
        for b in view.blocks:
            for op in b.ops:
                if not op.type.endswith("_grad"):
                    continue
                for n in op.write_names():
                    if "@GRAD" in n:
                        bases.setdefault(n.split("@GRAD")[0], b.idx)
        for base, bi in sorted(bases.items()):
            vd = view.visible_var(bi, base)
            if vd is None or not vd.persistable:
                continue
            payload, _ = var_bytes(vd, assume_batch)
            rep.grad_sync_bytes += payload
            for ax in batch_axes:
                record(ax, "allreduce(grad-sync)", float(payload),
                       f"param {base}")

    rep.ici_bytes = sum(d["wire_bytes"] for a, d in rep.per_axis.items()
                        if a not in dcn_axes)
    rep.dcn_bytes = sum(d["wire_bytes"] for a, d in rep.per_axis.items()
                        if a in dcn_axes)
    rep.ici_time_s = rep.ici_bytes / chip.ici_bw if chip.ici_bw else 0.0
    rep.dcn_time_s = rep.dcn_bytes / chip.dcn_bw if chip.dcn_bw else 0.0
    # int8 payload + one fp32 scale per 32-element block
    rep.quantized_dcn_bytes = rep.dcn_bytes / 4.0 * (1.0 + 4.0 / 32.0)
    return rep


def comms_pass(ctx, diag: Diagnostics) -> None:
    """Collective-byte tally per mesh axis for sharded programs; silent
    (report-only) for unsharded single-chip programs.  Options:
    ``mesh_axes`` ({axis: size}), ``dcn_axes`` (axes that span hosts),
    ``chip``, ``assume_batch``."""
    opts = getattr(ctx, "options", {}) or {}
    rep = estimate_comms(ctx.view, options=opts)
    diag.reports["comms"] = rep.to_dict()
    if not rep.per_axis:
        return
    total = rep.ici_bytes + rep.dcn_bytes
    diag.add(Finding(
        INFO, "comms", "summary",
        f"{len(rep.collectives)} collective(s), "
        f"{total/2**20:.2f} MiB wire traffic "
        f"(ici {rep.ici_bytes/2**20:.2f} MiB, "
        f"dcn {rep.dcn_bytes/2**20:.2f} MiB; grad sync payload "
        f"{rep.grad_sync_bytes/2**20:.2f} MiB)"))
    if rep.dcn_bytes:
        diag.add(Finding(
            WARNING, "comms", "dcn-bound",
            f"{rep.dcn_bytes/2**20:.2f} MiB crosses the DCN per step "
            f"(~{rep.dcn_time_s*1e3:.2f} ms at "
            f"{get_chip(opts.get('chip')).dcn_bw/1e9:.0f} GB/s) — an "
            f"int8 block-scaled all-reduce (EQuARX) cuts it to "
            f"~{rep.quantized_dcn_bytes/2**20:.2f} MiB"))
