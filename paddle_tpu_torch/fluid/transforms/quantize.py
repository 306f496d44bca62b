"""Post-training int8 weight quantization over pruned inference programs
— the port of ``paddle_tpu/fluid/transforms/quantize.py``, line for
line, so both packages rewrite a program into the same bytes and give
the same int8 weights and scales, bit for bit.

The rewrite walks a pruned ``ProgramDesc``, calibrates per-output-channel
int8 scales for the matmul-heavy weights (``mul`` / ``matmul`` /
``conv2d`` — ``fc`` lowers to ``mul``) from the persistables in the
scope, replaces each eligible float weight with an int8 persistable plus
a float32 ``<name>@quant.scale`` sidecar var, and rewrites the consuming
ops to the ``quantized_*`` ops (ops/quant_ops.py).  Calibration runs on
the host: a weight on the card is copied to the CPU first, and the int8
weight and its scale go into the scope as numpy arrays (host values the
executor, or ``io.device_put_persistables``, puts on the card).

Eligibility is conservative — a weight is only rewritten when every
consumer in the program is one of the quantizable ops, when its
recorded and loaded dtype is float, and when it is a persistable present
in the scope.  Everything else is left untouched.

Control-flow sub-blocks are covered: ``while`` / ``recurrent`` /
``dynamic_recurrent`` pass read-only parent vars into their sub-block by
name through the ``P`` slot, so a weight consumed by a ``mul`` inside a
While beam-search body (the whole NMT decoder step) quantizes like any
other: the sub-block op is rewritten in place and the scale sidecar is
appended to every router's ``P`` list.  ``conditional_block`` snapshots
its reads instead, so weights it consumes stay float (in ``skipped``).

Scale conventions are quant_ops' (symmetric max-abs, zero-max channels
get scale 1.0); the per-op output-channel axis is:

* ``mul``      — axis 1 of the ``y_num_col_dims``-flattened [K, N] view;
* ``matmul``   — the result's last dim (Y's row dim under transpose_Y);
* ``conv2d``   — OIHW dim 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..executor import _host_tensor
from ..ops.quant_ops import abs_max_scale, quantize_array

__all__ = ["quantize_program", "QuantStats", "SCALE_SUFFIX"]

SCALE_SUFFIX = "@quant.scale"

# op type -> (weight input slot, rewritten op type)
_QUANT_OPS: Dict[str, Tuple[str, str]] = {
    "mul": ("Y", "quantized_mul"),
    "matmul": ("Y", "quantized_matmul"),
    "conv2d": ("Filter", "quantized_conv2d"),
}

_FLOAT_DTYPES = ("float32", "float64", "bfloat16", "float16")

# control-flow ops that pass read-only parent vars into their sub-block
# env by name via the "P" slot (conditional_block seeds its body from
# X-slot @PRE snapshots, so it is not a router)
_P_ROUTERS = ("while", "recurrent", "dynamic_recurrent")


@dataclass
class QuantStats:
    """What the rewrite did — surfaced through
    ``InferenceEngine.cache_stats()`` beside the bucket counters."""

    quantized: List[str] = field(default_factory=list)
    skipped: Dict[str, str] = field(default_factory=dict)
    ops_rewritten: int = 0
    weight_bytes_before: int = 0
    weight_bytes_after: int = 0

    def to_dict(self) -> Dict[str, object]:
        return {
            "weights_quantized": len(self.quantized),
            "ops_rewritten": self.ops_rewritten,
            "skipped": dict(self.skipped),
            "weight_bytes_before": self.weight_bytes_before,
            "weight_bytes_after": self.weight_bytes_after,
            "weight_bytes_saved": (self.weight_bytes_before
                                   - self.weight_bytes_after),
        }


def _host_value(val) -> torch.Tensor:
    """A scope value on the CPU as a tensor: a card tensor copied over,
    a host array by the executor's rule (an ``ml_dtypes`` bfloat16 one
    by its bits)."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu()
    return _host_tensor(val)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _calibrate(w2: torch.Tensor, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """quant_ops' own abs_max_scale / quantize_array over a host tensor
    (the calibrator runs the emitter's formula).  -> (int8 array,
    float32 per-``axis`` scale vector)."""
    scale = abs_max_scale(w2, axis=axis)
    return quantize_array(w2, scale, axis=axis).numpy(), scale.numpy()


def _quantize_weight(w: torch.Tensor, op_type: str, attrs: Dict) -> Tuple[
        np.ndarray, np.ndarray]:
    """-> (int8 weight in the original layout, float32 scale vector)."""
    wf = w.to(torch.float32)
    if op_type == "mul":
        yd = int(attrs.get("y_num_col_dims", 1))
        lead = math.prod(w.shape[:yd]) if yd else 1
        q2, scale = _calibrate(wf.reshape(lead, -1), axis=1)  # [K, N]
        return q2.reshape(tuple(w.shape)), scale
    if op_type == "matmul":
        # output channel = the result's last dim = Y's last dim, or Y's
        # second-to-last under transpose_Y
        axis = w.dim() - 2 if attrs.get("transpose_Y", False) \
            else w.dim() - 1
        q, scale = _calibrate(wf, axis=axis)
        return q, scale.reshape(-1)
    if op_type == "conv2d":
        return _calibrate(wf, axis=0)                         # [OC]
    raise ValueError(f"no quantization recipe for op {op_type!r}")


def quantize_program(program, scope, *, weight_dtype: str = "int8",
                     ops: Sequence[str] = ("mul", "matmul", "conv2d"),
                     skip: Sequence[str] = (), min_elements: int = 1,
                     ) -> QuantStats:
    """Rewrite ``program`` IN PLACE (callers owning a shared program
    should ``program.clone(for_test=True)`` first — the engine passes its
    private pruned program) and replace the quantized weights' scope
    values with int8 arrays + fp32 scale sidecars.  Returns QuantStats.

    ``skip`` names weights to leave alone; ``min_elements`` bounds the
    smallest weight worth rewriting (tiny tensors save no bandwidth)."""
    if weight_dtype != "int8":
        raise ValueError(f"quantize_program: only weight_dtype='int8' is "
                         f"implemented, got {weight_dtype!r}")
    want = {t: _QUANT_OPS[t] for t in ops if t in _QUANT_OPS}
    skip = set(skip)
    block = program.global_block()
    bd = block.desc
    stats = QuantStats()

    # every (op, slot) each candidate weight feeds and every op that
    # writes it, program-wide — the all-consumers-quantizable safety
    # check reads these
    readers: Dict[str, List] = {}
    writers: Dict[str, List[str]] = {}
    for b in program.desc.blocks:
        for od in b.ops:
            for slot, names in od.inputs.items():
                for n in names:
                    if n:
                        readers.setdefault(n, []).append((od, slot))
            for names in od.outputs.values():
                for n in names:
                    if n:
                        writers.setdefault(n, []).append(od.type)

    # candidate weights from EVERY block: sub-block consumers (a mul
    # inside a While beam-search body) rewrite exactly like global ones
    candidates: Dict[str, List] = {}
    for b in program.desc.blocks:
        for od in b.ops:
            spec = want.get(od.type)
            if spec is None:
                continue
            wslot, _ = spec
            for wname in od.input(wslot):
                candidates.setdefault(wname, []).append(od)

    for wname, w_ops in sorted(candidates.items()):
        if wname in skip:
            stats.skipped[wname] = "explicitly skipped"
            continue
        vd = bd.vars.get(wname)
        if vd is None or not vd.persistable:
            stats.skipped[wname] = "not a persistable weight"
            continue
        if vd.dtype not in _FLOAT_DTYPES:
            stats.skipped[wname] = f"dtype {vd.dtype} not float"
            continue
        val = scope.find_var(wname)
        if val is None:
            stats.skipped[wname] = "no value in scope to calibrate from"
            continue
        w = _host_value(val)
        if not w.is_floating_point():
            stats.skipped[wname] = (f"scope value dtype "
                                    f"{_dtype_name(w)} not float")
            continue
        if w.numel() < min_elements:
            stats.skipped[wname] = f"only {w.numel()} elements"
            continue
        if wname in writers:
            stats.skipped[wname] = (f"written by "
                                    f"{sorted(set(writers[wname]))} — not "
                                    f"a constant weight")
            continue
        if any(wname in b.vars for b in program.desc.blocks if b is not bd):
            stats.skipped[wname] = ("shadowed by a sub-block var of the "
                                    "same name — unsafe to retype")
            continue
        bad = [(od.type, slot) for od, slot in readers.get(wname, [])
               if not (od.type in want and slot == want[od.type][0])
               and not (od.type in _P_ROUTERS and slot == "P"
                        and od.block_attr("sub_block") is not None)]
        if bad:
            stats.skipped[wname] = (f"also consumed by "
                                    f"{sorted(set(bad))} — unsafe to "
                                    f"retype")
            continue
        # consumers must agree on the quantization layout (one stored
        # int8 tensor serves them all): same op type + layout attrs
        recipes = {(od.type,
                    int(od.attr("y_num_col_dims", 1)),
                    bool(od.attr("transpose_Y", False))) for od in w_ops}
        if len(recipes) > 1:
            stats.skipped[wname] = (f"consumers disagree on layout: "
                                    f"{sorted(recipes)}")
            continue

        op_type = w_ops[0].type
        q, scale = _quantize_weight(w.to(torch.float32), op_type,
                                    w_ops[0].attrs)
        scale_name = wname + SCALE_SUFFIX
        stats.weight_bytes_before += w.numel() * w.element_size()
        stats.weight_bytes_after += q.nbytes + scale.nbytes

        # scope: int8 weight under the ORIGINAL name (save/load round-
        # trips keep working) + fp32 scale sidecar
        scope.set_var(wname, q)
        scope.set_var(scale_name, scale)
        # descs: retype the weight, declare the sidecar, rewrite the ops
        vd.dtype = "int8"
        if scale_name not in bd.vars:
            block.create_var(name=scale_name, shape=list(scale.shape),
                             dtype="float32", persistable=True,
                             stop_gradient=True)
        for od in w_ops:
            od.type = want[op_type][1]
            od.inputs["Scale"] = [scale_name]
            stats.ops_rewritten += 1
        # route the sidecar into every sub-block the weight reaches —
        # appending it to each router's P slot puts it in the body env
        # by name, right next to the int8 weight (nested loops hold the
        # weight in every level's P, so the scale rides the same chain)
        for od, slot in readers.get(wname, []):
            if od.type in _P_ROUTERS and slot == "P" \
                    and scale_name not in od.inputs["P"]:
                od.inputs["P"].append(scale_name)
        stats.quantized.append(wname)

    if stats.ops_rewritten:
        program._bump_version()
    return stats
