"""Static program cost analysis: peak-HBM planning + roofline op costs —
the port of ``paddle_tpu/fluid/analysis/cost.py``.

Program-as-data makes a program analyzable before it runs; this module
prices one from its descs alone:

* **peak-HBM planner** — a def-use/liveness walk per block producing a
  live-set *byte* timeline: params, activations, KV pools (int8 scale
  sidecars included — they are ordinary persistable vars with recorded
  shapes), feed buffers, and donation-aware buffer reuse (an op whose
  output matches a dying input's shape/dtype aliases its buffer, the
  ParamOut/cache_write idiom the port's executor runs in place: a
  captured step's state buffers are the scope's tensors).  Reports peak
  bytes with the top-k contributing vars and exact ``block/op#``
  coordinates.
* **per-op analytic cost model** — flops + HBM bytes read/written,
  registered per op type the way emitters are registered (``cost_rule``);
  unregistered ops fall back to a conservative default and surface as a
  ``cost/unregistered-cost-rule`` finding, so "the analyzer guessed" is
  always visible.  ``*_grad`` ops without their own rule derive from the
  base rule (the vjp doubles the forward flops).
* **roofline rollup** — per-op ``max(flops/peak_flops, bytes/hbm_bw)``
  at a declared ``ChipSpec``, summed into a step-time estimate with a
  compute-vs-memory-bound classification per op type.

The rules are the reference's, number for number: the same program
prices the same in both packages.  Only the machine differs —
``CHIP_SPECS`` holds the card the port runs on.

Consumers: ``Program.analyze(level="cost")`` / ``plint --cost`` (pass
form via :func:`cost_pass`), the serving generators' and engine's
``static_hbm_estimate`` (the scheduler's HBM admission), and
``chip_smoke.py``'s predicted-vs-measured cost check.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.types import VarType, canonical_dtype, torch_dtype
from .dataflow import ProgramView, block_liveness
from .diagnostics import ERROR, INFO, WARNING, Diagnostics, Finding

__all__ = ["ChipSpec", "CHIP_SPECS", "get_chip", "OpCost", "cost_rule",
           "op_cost", "var_bytes", "shard_divisor", "block_byte_plan",
           "plan_program", "roofline", "cost_pass", "KV_POOL_MARKERS"]


# ---------------------------------------------------------------------------
# chip specs — the declared roofline machine model
# ---------------------------------------------------------------------------

class ChipSpec:
    """Declared per-device capability numbers for the roofline estimate:
    dense bf16 peak FLOP/s, HBM bandwidth and capacity, and the two
    interconnect tiers the comms pass prices traffic against (``ici_bw``
    = the links between the cards of one host, NVLink on the card;
    ``dcn_bw`` = the network between hosts).  The field names are the
    reference's."""

    __slots__ = ("name", "peak_flops", "hbm_bw", "hbm_bytes", "ici_bw",
                 "dcn_bw", "conv_flops")

    def __init__(self, name: str, peak_flops: float, hbm_bw: float,
                 hbm_bytes: float, ici_bw: float = 100e9,
                 dcn_bw: float = 25e9, conv_flops: Optional[float] = None):
        self.name = name
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        self.hbm_bytes = float(hbm_bytes)
        self.ici_bw = float(ici_bw)
        self.dcn_bw = float(dcn_bw)
        # achievable conv rate: the tensor cores' peak by default; a
        # calibrated spec sets it from a measured conv
        self.conv_flops = (float(conv_flops) if conv_flops is not None
                           else self.peak_flops)

    def to_dict(self) -> Dict[str, float]:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "hbm_bytes": self.hbm_bytes,
                "ici_bw": self.ici_bw, "dcn_bw": self.dcn_bw,
                "conv_flops": self.conv_flops}

    def __repr__(self):
        return (f"ChipSpec({self.name}: {self.peak_flops/1e12:.0f} TF/s, "
                f"{self.hbm_bw/1e9:.0f} GB/s, "
                f"{self.hbm_bytes/2**30:.0f} GiB)")


GiB = float(2 ** 30)

# per-DEVICE numbers from the vendor's data sheet.  NVIDIA H100 Tensor
# Core GPU data sheet, SXM5 80 GB part: dense (no sparsity) bf16 tensor
# throughput 989 TFLOP/s, HBM3 at 3.35 TB/s, 80 GB, NVLink 900 GB/s (as
# ``ici_bw``); DGX H100 data sheet: one 400 Gb/s ConnectX-7 port a GPU
# (50 GB/s, as ``dcn_bw``).  The rates assume the card's 700 W limit.
CHIP_SPECS: Dict[str, ChipSpec] = {
    "h100": ChipSpec("h100", 989e12, 3.35e12, 80 * GiB, ici_bw=900e9,
                     dcn_bw=50e9),
}

# device names (``torch.cuda.get_device_name``) -> spec, by prefix
_DEVICE_NAME_TO_SPEC = (("NVIDIA H100", "h100"),)


def get_chip(spec=None) -> ChipSpec:
    """Resolve a chip spec: an explicit ChipSpec/name wins, then the
    ``PADDLE_TPU_CHIP`` env flag (the reference's name), then the
    attached card's name, then the H100 (the card the port runs on)."""
    if isinstance(spec, ChipSpec):
        return spec
    name = spec or os.environ.get("PADDLE_TPU_CHIP")
    if name:
        try:
            return CHIP_SPECS[str(name)]
        except KeyError:
            raise ValueError(f"unknown chip spec {name!r}; one of "
                             f"{sorted(CHIP_SPECS)}") from None
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name()
        for prefix, key in _DEVICE_NAME_TO_SPEC:
            if kind.startswith(prefix):
                return CHIP_SPECS[key]
    return CHIP_SPECS["h100"]


# ---------------------------------------------------------------------------
# byte accounting over VarDescs
# ---------------------------------------------------------------------------

# decode-time cache state markers (paged pool + block-scale sidecar,
# dense per-lane caches) — duplicated as data from serving/paged_decoder
# to keep this module import-light, same as dataflow.HOST_IO_OPS
KV_POOL_MARKERS = ("@kv_pool", "@kv_scales", "@kcache", "@vcache",
                   "@crossk", "@crossv")

_SIZED_TYPES = (VarType.DENSE_TENSOR, VarType.LOD_TENSOR,
                VarType.SELECTED_ROWS)


def dtype_bytes(dtype) -> int:
    return torch_dtype(canonical_dtype(dtype)).itemsize


def shard_divisor(vd, mesh_axes: Optional[Dict[str, int]] = None) -> int:
    """Per-DEVICE byte divisor for one VarDesc under a declared mesh:
    the product of the axis extents its sharding annotation maps onto
    dims that divide evenly.  Unannotated vars (activations, feeds,
    block tables) divide by 1 — the conservative per-shard plan charges
    them replicated, exactly the contract the serving mesh keeps for
    paging state."""
    if not mesh_axes or vd is None or vd.sharding is None \
            or vd.shape is None:
        return 1
    div = 1
    for d, ax in zip(vd.shape, vd.sharding):
        if not isinstance(ax, str):
            continue
        if ax.endswith("?"):          # deferred (ZeRO) placement
            ax = ax[:-1]
        n = mesh_axes.get(ax)
        if n and d is not None and d > 0 and d % int(n) == 0:
            div *= int(n)
    return div


def var_bytes(vd, assume_batch: int = 1,
              mesh_axes: Optional[Dict[str, int]] = None) -> Tuple[int, bool]:
    """(bytes, approximate) for one VarDesc.  Dynamic dims substitute
    ``assume_batch`` at dim 0 and 1 elsewhere; opaque/unsized vars cost
    0 — both substitutions flip the ``approximate`` flag so the report
    can say how much of the estimate is assumed rather than recorded.
    With ``mesh_axes`` the bytes are the per-device footprint: annotated
    dims that divide their axis extent scale down (see
    :func:`shard_divisor`)."""
    if vd is None or vd.type not in _SIZED_TYPES or vd.shape is None:
        return 0, True
    n, approx = 1, False
    for i, d in enumerate(vd.shape):
        if d is None or d < 0:
            d = assume_batch if i == 0 else 1
            approx = True
        n *= int(d)
    return (n * dtype_bytes(vd.dtype)) // shard_divisor(vd, mesh_axes), \
        approx


def _is_kv_state(name: str) -> bool:
    return any(m in name for m in KV_POOL_MARKERS)


# ---------------------------------------------------------------------------
# per-op cost rules — registered like shape rules, keyed by op type
# ---------------------------------------------------------------------------

class OpCost:
    """One op's analytic cost: flops + HBM bytes read/written.
    ``registered`` is False when the conservative default produced the
    numbers (surfaced as a finding by the cost pass)."""

    __slots__ = ("flops", "bytes_read", "bytes_written", "registered")

    def __init__(self, flops: float = 0.0, bytes_read: float = 0.0,
                 bytes_written: float = 0.0, registered: bool = True):
        self.flops = float(flops)
        self.bytes_read = float(bytes_read)
        self.bytes_written = float(bytes_written)
        self.registered = registered

    @property
    def bytes_total(self) -> float:
        return self.bytes_read + self.bytes_written

    def __repr__(self):
        return (f"OpCost(flops={self.flops:.3g}, "
                f"r={self.bytes_read:.3g}, w={self.bytes_written:.3g})")


class CostEnv:
    """What a cost rule may look at: the op desc plus shape/dtype/byte
    lookups over the vars visible at the op's block (the recorded descs
    — rules never re-run emitters)."""

    __slots__ = ("view", "block_idx", "assume_batch", "approx")

    def __init__(self, view: ProgramView, block_idx: int,
                 assume_batch: int = 1):
        self.view = view
        self.block_idx = block_idx
        self.assume_batch = int(assume_batch)
        self.approx = False          # sticky: any assumed dim seen

    def var(self, name: str):
        return self.view.visible_var(self.block_idx, name)

    def shape(self, name: str) -> Optional[List[int]]:
        vd = self.var(name)
        if vd is None or vd.shape is None:
            return None
        out = []
        for i, d in enumerate(vd.shape):
            if d is None or d < 0:
                d = self.assume_batch if i == 0 else 1
                self.approx = True
            out.append(int(d))
        return out

    def elems(self, name: str) -> int:
        s = self.shape(name)
        if s is None:
            return 0
        n = 1
        for d in s:
            n *= d
        return n

    def bytes(self, name: str) -> int:
        b, approx = var_bytes(self.var(name), self.assume_batch)
        self.approx = self.approx or approx
        return b

    def itemsize(self, name: str) -> int:
        vd = self.var(name)
        return dtype_bytes(vd.dtype) if vd is not None else 4

    # -- slot-level rollups --------------------------------------------------
    def slot_bytes(self, od, slot: str, output: bool = False) -> int:
        names = (od.outputs if output else od.inputs).get(slot, [])
        return sum(self.bytes(n) for n in names if n)

    def in_bytes(self, od, skip: Sequence[str] = ()) -> int:
        return sum(self.bytes(n) for s, names in od.inputs.items()
                   if s not in skip for n in names if n)

    def out_bytes(self, od, skip: Sequence[str] = ()) -> int:
        return sum(self.bytes(n) for s, names in od.outputs.items()
                   if s not in skip for n in names if n)

    def out_elems(self, od, slot: str = "Out") -> int:
        """Elements of an output slot, falling back to the matching
        ``<slot>@GRAD`` *input* for grad ops (the vjp contract: grad-of-
        Out has Out's shape) so forward rules can price grad descs."""
        names = od.outputs.get(slot) or od.inputs.get(slot + "@GRAD") \
            or od.inputs.get(slot) or []
        return sum(self.elems(n) for n in names if n)


# op type -> fn(od: OpDesc, env: CostEnv) -> OpCost
COST_RULES: Dict[str, Callable] = {}

# op families priced at ChipSpec.conv_flops instead of peak_flops
CONV_OPS = {"conv2d", "depthwise_conv2d", "conv2d_transpose", "conv3d",
            "quantized_conv2d"}


def cost_rule(*op_types: str):
    """Register an analytic cost rule for one or more op types — the
    cost-model analog of registering an emitter."""
    def deco(fn):
        for t in op_types:
            COST_RULES[t] = fn
        return fn
    return deco


def has_cost_rule(op_type: str) -> bool:
    return op_type in COST_RULES or (
        op_type.endswith("_grad") and op_type[:-5] in COST_RULES)


def op_cost(env: CostEnv, od) -> OpCost:
    """Cost one op desc: its registered rule, the derived grad rule
    (2x the base rule's flops — forward recompute + adjoint — with the
    grad op's own byte footprint), or the conservative default (1 flop
    per output element, every input read + every output written)."""
    rule = COST_RULES.get(od.type)
    if rule is not None:
        return rule(od, env)
    if od.type.endswith("_grad"):
        base = COST_RULES.get(od.type[: -len("_grad")])
        if base is not None:
            try:
                fwd = base(od, env)
                flops = 2.0 * fwd.flops
            except Exception:
                flops = float(sum(env.out_elems(od, s)
                                  for s in od.outputs))
            return OpCost(flops, env.in_bytes(od), env.out_bytes(od))
    flops = float(sum(env.elems(n) for s in od.outputs
                      for n in od.outputs[s] if n))
    return OpCost(flops, env.in_bytes(od), env.out_bytes(od),
                  registered=False)


# -- elementwise / data-movement families ------------------------------------

def _ew_cost(mult: float):
    def rule(od, env):
        out = sum(env.elems(n) for s in od.outputs
                  for n in od.outputs[s] if n)
        return OpCost(mult * out, env.in_bytes(od), env.out_bytes(od))
    return rule


# 1 flop per output element
for _t in ("relu", "sigmoid", "tanh", "exp", "sqrt", "square", "abs",
           "log", "scale", "cast", "assign", "dropout", "increment",
           "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "clip", "isfinite", "less_than", "equal",
           "sign", "floor", "ceil", "round", "logical_and", "logical_not",
           "sequence_mask", "one_hot", "label_smooth"):
    COST_RULES[_t] = _ew_cost(1.0)
# transcendental-heavy normalizations
for _t in ("softmax", "sequence_softmax", "log_softmax"):
    COST_RULES[_t] = _ew_cost(5.0)
for _t in ("layer_norm", "batch_norm", "group_norm"):
    COST_RULES[_t] = _ew_cost(8.0)
for _t in ("gelu", "swish", "silu"):
    COST_RULES[_t] = _ew_cost(8.0)


@cost_rule("reshape", "squeeze", "unsqueeze", "flatten")
def _reshape_cost(od, env):
    # views of their input — no bytes move, no flops
    return OpCost(0.0, 0.0, 0.0)


@cost_rule("transpose", "concat", "split", "slice", "pad", "stack",
           "expand", "tile", "sequence_expand", "gather", "batch_gather",
           "scatter", "shuffle_channel")
def _move_cost(od, env):
    return OpCost(0.0, env.in_bytes(od), env.out_bytes(od))


@cost_rule("fill_constant", "fill_constant_batch_size_like", "fill_zeros_like",
           "uniform_random", "gaussian_random")
def _fill_cost(od, env):
    return OpCost(0.0, 0.0, env.out_bytes(od))


@cost_rule("lookup_table", "embedding")
def _lookup_cost(od, env):
    # reads only the selected rows (== output bytes), not the table
    out = env.out_bytes(od)
    ids = env.slot_bytes(od, "Ids")
    return OpCost(0.0, out + ids, out)


# -- reductions and losses ----------------------------------------------------

def _red_cost(od, env):
    ins = sum(env.elems(n) for s in od.inputs
              for n in od.inputs[s] if n)
    return OpCost(float(ins), env.in_bytes(od), env.out_bytes(od))


for _t in ("mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "sum", "sums", "sequence_pool", "argmax",
           "accuracy"):
    COST_RULES[_t] = _red_cost


@cost_rule("cross_entropy")
def _ce_cost(od, env):
    return OpCost(3.0 * env.slot_bytes(od, "X") / 4.0,
                  env.in_bytes(od), env.out_bytes(od))


@cost_rule("softmax_with_cross_entropy")
def _swce_cost(od, env):
    logits = sum(env.elems(n) for n in od.inputs.get("Logits", []) if n)
    return OpCost(6.0 * logits, env.in_bytes(od), env.out_bytes(od))


@cost_rule("top_k", "topk")
def _topk_cost(od, env):
    import math

    n = sum(env.elems(nm) for s in od.inputs for nm in od.inputs[s] if nm)
    k = max(1, int(od.attrs.get("k", 1)))
    return OpCost(n * max(1.0, math.log2(k + 1)),
                  env.in_bytes(od), env.out_bytes(od))


# -- matmul family ------------------------------------------------------------

def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


@cost_rule("mul", "quantized_mul")
def _mul_cost(od, env):
    xs = env.shape((od.inputs.get("X") or [""])[0])
    if not xs:
        return OpCost(2.0 * env.out_elems(od), env.in_bytes(od),
                      env.out_bytes(od))
    xd = int(od.attrs.get("x_num_col_dims", 1))
    k = _prod(xs[xd:])
    return OpCost(2.0 * env.out_elems(od) * k, env.in_bytes(od),
                  env.out_bytes(od))


@cost_rule("matmul", "quantized_matmul")
def _matmul_cost(od, env):
    xs = env.shape((od.inputs.get("X") or [""])[0])
    if not xs:
        return OpCost(2.0 * env.out_elems(od), env.in_bytes(od),
                      env.out_bytes(od))
    k = xs[-2] if od.attrs.get("transpose_X", False) and len(xs) >= 2 \
        else xs[-1]
    return OpCost(2.0 * env.out_elems(od) * k, env.in_bytes(od),
                  env.out_bytes(od))


@cost_rule("conv2d", "quantized_conv2d")
def _conv2d_cost(od, env):
    fs = env.shape((od.inputs.get("Filter") or [""])[0])
    out = env.out_elems(od, "Output") or env.out_elems(od)
    if not fs or len(fs) != 4:
        return OpCost(2.0 * out, env.in_bytes(od), env.out_bytes(od))
    _, cin_per_group, kh, kw = fs
    return OpCost(2.0 * out * cin_per_group * kh * kw,
                  env.in_bytes(od), env.out_bytes(od))


@cost_rule("pool2d")
def _pool2d_cost(od, env):
    ks = od.attrs.get("ksize", [2, 2])
    window = _prod(ks) if isinstance(ks, (list, tuple)) else int(ks) ** 2
    out = env.out_elems(od)
    return OpCost(float(out * window), env.in_bytes(od), env.out_bytes(od))


@cost_rule("fused_attention")
def _fused_attention_cost(od, env):
    q = env.shape((od.inputs.get("Q") or [""])[0])
    k = env.shape((od.inputs.get("K") or [""])[0])
    if not q or not k or len(q) < 2:
        return OpCost(2.0 * env.out_elems(od), env.in_bytes(od),
                      env.out_bytes(od))
    d = q[-1]
    lq = q[-2]
    lk = k[-2] if len(k) >= 2 else lq
    heads_batch = _prod(q[:-2])
    # QK^T + PV; causal masking halves the touched extent
    flops = 4.0 * heads_batch * lq * lk * d
    if od.attrs.get("causal", False):
        flops /= 2.0
    return OpCost(flops, env.in_bytes(od), env.out_bytes(od))


@cost_rule("fused_vocab_cross_entropy")
def _fused_vocab_ce_cost(od, env):
    x = env.shape((od.inputs.get("X") or [""])[0])
    w = env.shape((od.inputs.get("W") or [""])[0])
    if not x or not w:
        return OpCost(2.0 * env.out_elems(od), env.in_bytes(od),
                      env.out_bytes(od))
    # logits matmul [*, d] x [d, V] + softmax over V, never materialized
    tokens = _prod(x[:-1])
    d = x[-1]
    vocab = w[-1]
    return OpCost(2.0 * tokens * d * vocab + 6.0 * tokens * vocab,
                  env.in_bytes(od), env.out_bytes(od))


# -- optimizers ---------------------------------------------------------------

def _opt_cost(mult):
    def rule(od, env):
        p = sum(env.elems(n) for n in od.inputs.get("Param", []) if n)
        return OpCost(mult * p, env.in_bytes(od), env.out_bytes(od))
    return rule


COST_RULES["sgd"] = _opt_cost(2.0)
COST_RULES["momentum"] = _opt_cost(4.0)
COST_RULES["adam"] = _opt_cost(12.0)
COST_RULES["adagrad"] = _opt_cost(6.0)
COST_RULES["rmsprop"] = _opt_cost(8.0)


# -- quantization -------------------------------------------------------------

COST_RULES["quantize"] = _ew_cost(3.0)
COST_RULES["dequantize"] = _ew_cost(2.0)


# -- KV-cache / paged serving ops --------------------------------------------

@cost_rule("cache_write")
def _cache_write_cost(od, env):
    # Out aliases Cache under donation: only the written slice moves
    v = env.slot_bytes(od, "Value")
    return OpCost(0.0, v + env.slot_bytes(od, "Index"), v)


@cost_rule("decode_attention")
def _decode_attention_cost(od, env):
    q = env.shape((od.inputs.get("Q") or [""])[0])
    kc = (od.inputs.get("KCache") or [""])[0]
    kb = env.bytes(kc)
    if not q or len(q) != 4:
        return OpCost(2.0 * env.out_elems(od), env.in_bytes(od),
                      env.out_bytes(od))
    b, lq, h, d = q
    lmax = (env.shape(kc) or [0, 1])[1]
    # QK^T + PV against the full cache extent (static upper bound)
    flops = 4.0 * b * lq * h * lmax * d
    reads = 2 * kb + env.slot_bytes(od, "Q") + env.slot_bytes(od, "Lengths")
    return OpCost(flops, reads, env.out_bytes(od))


def _pool_geometry(env, od):
    """(n_head, page_size, d_head, itemsize) from the Pool input."""
    ps = env.shape((od.inputs.get("Pool") or [""])[0]) or [1, 1, 1, 1]
    item = env.itemsize((od.inputs.get("Pool") or [""])[0])
    return ps[0], ps[2], ps[3], item


@cost_rule("paged_cache_write")
def _paged_write_cost(od, env):
    _, _, _, item = _pool_geometry(env, od)
    toks = env.slot_bytes(od, "K") + env.slot_bytes(od, "V")
    written = (sum(env.elems(n) for n in od.inputs.get("K", []) if n)
               + sum(env.elems(n) for n in od.inputs.get("V", []) if n)) \
        * item
    reads = toks + env.slot_bytes(od, "Pages") + env.slot_bytes(od,
                                                                "Offsets")
    return OpCost(0.0, reads, written)


@cost_rule("quantized_paged_cache_write")
def _qpaged_write_cost(od, env):
    base = _paged_write_cost(od, env)
    k_elems = sum(env.elems(n) for n in od.inputs.get("K", []) if n)
    v_elems = sum(env.elems(n) for n in od.inputs.get("V", []) if n)
    kshape = env.shape((od.inputs.get("K") or [""])[0]) or [1]
    # one fp32 block scale per (token, role): B*C scales for K and V each
    tokens = _prod(kshape[:2]) if len(kshape) >= 2 else kshape[0]
    return OpCost(6.0 * (k_elems + v_elems), base.bytes_read,
                  base.bytes_written + 2 * tokens * 4)


@cost_rule("ragged_decode_attention")
def _ragged_attention_cost(od, env):
    h, page, d, item = _pool_geometry(env, od)
    q = env.shape((od.inputs.get("Q") or [""])[0]) or [1, 1, h, d]
    pt = env.shape((od.inputs.get("PageTable") or [""])[0]) or [1, 1]
    b, c = q[0], q[1] if len(q) >= 2 else 1
    p = pt[-1]
    lmax = p * page                         # static page-table capacity
    flops = 4.0 * b * c * h * lmax * d
    # the pool pages a lane's table can address, K+V, plus the int8
    # pool's fp32 block-scale sidecar rows when present
    reads = 2.0 * b * p * page * h * d * item + env.slot_bytes(od, "Q") \
        + env.slot_bytes(od, "PageTable") + env.slot_bytes(od, "Lengths")
    if od.inputs.get("Scales"):
        reads += 2.0 * b * p * page * 4
    return OpCost(flops, reads, env.out_bytes(od))


@cost_rule("paged_page_copy", "quantized_paged_page_copy")
def _page_copy_cost(od, env):
    h, page, d, item = _pool_geometry(env, od)
    n_layer = max(1, int(od.attrs.get("n_layer", 1)))
    src = env.shape((od.inputs.get("Src") or [""])[0]) or [1]
    b = _prod(src)
    page_bytes = 2 * n_layer * page * h * d * item
    moved = float(b * page_bytes)
    if od.inputs.get("Scales"):
        moved += b * 2 * n_layer * page * 4
    return OpCost(0.0, moved, moved)


@cost_rule("paged_page_gather", "quantized_paged_page_gather",
           "paged_page_scatter", "quantized_paged_page_scatter")
def _page_xfer_cost(od, env):
    """Tier transfers move W whole pages (all layers, K+V) between the
    pool and a dense slab — pure bandwidth, zero flops; the int8 pool's
    fp32 scale sidecar rides the same rows."""
    h, page, d, item = _pool_geometry(env, od)
    n_layer = max(1, int(od.attrs.get("n_layer", 1)))
    pages = env.shape((od.inputs.get("Pages") or [""])[0]) or [1]
    w = _prod(pages)
    moved = float(w * 2 * n_layer * page * h * d * item)
    if od.inputs.get("Scales"):
        moved += w * 2 * n_layer * page * 4
    return OpCost(0.0, moved, moved)


# ---------------------------------------------------------------------------
# peak-HBM planner: liveness byte timeline per block
# ---------------------------------------------------------------------------

class _AliasClasses:
    """Union-find over var names; one buffer per class (donation-aware
    reuse).  A class rooted at a persistable contributes no transient
    bytes — its buffer is the donated scope value."""

    def __init__(self):
        self.parent: Dict[str, str] = {}
        self.persistable_root: Dict[str, bool] = {}

    def find(self, n: str) -> str:
        p = self.parent.setdefault(n, n)
        if p != n:
            p = self.find(p)
            self.parent[n] = p
        return p

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra
            self.persistable_root[ra] = (
                self.persistable_root.get(ra, False)
                or self.persistable_root.get(rb, False))

    def mark_persistable(self, n: str) -> None:
        self.persistable_root[self.find(n)] = True

    def is_persistable(self, n: str) -> bool:
        return self.persistable_root.get(self.find(n), False)


class BlockBytePlan:
    """Byte timeline for one block: per-op live bytes, the peak with
    coordinates and contributors, and the legacy liveness stats
    (``block_liveness``'s keys) it was derived from."""

    __slots__ = ("block_idx", "liveness", "timeline", "peak_bytes",
                 "peak_op", "contributors", "transient_peak",
                 "feed_bytes", "approximate", "n_ops")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "block": self.block_idx,
            "peak_bytes": self.peak_bytes,
            "peak_op": self.peak_op,
            "transient_peak_bytes": self.transient_peak,
            "feed_bytes": self.feed_bytes,
            "timeline": list(self.timeline),
            "contributors": [dict(c) for c in self.contributors],
            "approximate": self.approximate,
        }


def block_byte_plan(view: ProgramView, block_idx: int = 0,
                    assume_batch: int = 1,
                    sub_extra: Optional[Dict[int, int]] = None,
                    persistable_base: int = 0,
                    assume_donation: bool = True,
                    mesh_axes: Optional[Dict[str, int]] = None
                    ) -> BlockBytePlan:
    """Build the liveness byte timeline for one block.

    Transient live ranges come from :func:`dataflow.block_liveness` (the
    ONE derivation of live sets — ``legacy_stats`` reports the same
    stats); this adds byte weights, feed-buffer intervals, donation-
    aware aliasing, and per-op sub-block peaks (``sub_extra``: op idx ->
    extra transient bytes while that control-flow op runs).
    ``persistable_base`` is added to every timeline point (the resident
    params/KV bytes the program-level planner accounts once).

    ``assume_donation=False`` models a step that does NOT write its
    state in place (the reference's persistent-cache executables): a
    written persistable no longer aliases its scope buffer, so the new
    value is a fresh transient of full size live until the step returns
    — the pool/param write-back copy the in-place step avoids.
    Dying-transient reuse still applies either way.  The port's executor
    always writes in place (a captured step's state buffers are the
    scope's tensors); its serving estimates price the step without
    donation where the executor mounts a compile cache only to admit
    as the reference's do.
    """
    b = view.blocks[block_idx]
    plan = BlockBytePlan.__new__(BlockBytePlan)
    plan.block_idx = block_idx
    plan.n_ops = len(b.ops)
    plan.approximate = False
    liveness = block_liveness(b.desc)
    plan.liveness = liveness
    live_range: Dict[str, Tuple[int, int]] = {
        n: (int(r[0]), int(r[1])) for n, r in liveness["live_range"].items()}

    local = b.desc.vars

    def vbytes(name: str) -> int:
        got, approx = var_bytes(view.visible_var(block_idx, name),
                                assume_batch, mesh_axes)
        plan.approximate = plan.approximate or approx
        return got

    # feed-like vars: declared here, read but never written, not
    # persistable — the dispatch arguments; resident from op 0 until
    # their last use
    written = {n for op in b.ops for n in op.write_names()}
    feed_last: Dict[str, int] = {}
    for op in b.ops:
        for n in op.read_names():
            vd = local.get(n)
            if vd is None or vd.persistable or n in written:
                continue
            feed_last[n] = op.idx

    # donation-aware aliasing: at its defining op, an output whose
    # shape/dtype matches an input that dies at that op (or a donated
    # persistable input) shares the input's buffer
    aliases = _AliasClasses()
    sig_cache: Dict[str, Tuple] = {}

    def sig(name: str):
        if name not in sig_cache:
            vd = view.visible_var(block_idx, name)
            if vd is None or vd.shape is None \
                    or vd.type not in _SIZED_TYPES:
                sig_cache[name] = None
            else:
                shape = tuple(assume_batch if (d is None or d < 0) and i == 0
                              else (1 if d is None or d < 0 else int(d))
                              for i, d in enumerate(vd.shape))
                sig_cache[name] = (shape, canonical_dtype(vd.dtype))
        return sig_cache[name]

    for name, vd in local.items():
        if vd.persistable:
            aliases.mark_persistable(name)

    for op in b.ops:
        consumed: set = set()
        for n in op.write_names():
            rng = live_range.get(n)
            if rng is None or rng[0] != op.idx:
                continue                 # persistable or later re-def
            wsig = sig(n)
            if wsig is None:
                continue
            for r in op.read_names():
                if r in consumed or r == n or sig(r) != wsig:
                    continue
                r_vd = view.visible_var(block_idx, r)
                if r_vd is None:
                    continue
                dies_here = live_range.get(r, (None, None))[1] == op.idx \
                    and r not in feed_last
                donated = r_vd.persistable and assume_donation
                if dies_here or donated:
                    aliases.union(r, n)
                    if donated:
                        aliases.mark_persistable(n)
                    consumed.add(r)
                    break

    # collapse intervals to alias classes
    class_range: Dict[str, List[int]] = {}
    class_bytes: Dict[str, int] = {}
    class_members: Dict[str, List[str]] = {}
    for n, (lo, hi) in live_range.items():
        root = aliases.find(n)
        if aliases.is_persistable(root):
            continue                     # buffer donated from the scope
        rng = class_range.setdefault(root, [lo, hi])
        rng[0] = min(rng[0], lo)
        rng[1] = max(rng[1], hi)
        class_bytes[root] = max(class_bytes.get(root, 0), vbytes(n))
        class_members.setdefault(root, []).append(n)

    feed_bytes_total = 0
    for n, last in feed_last.items():
        nb = vbytes(n)
        feed_bytes_total += nb
        class_range[n] = [0, last]
        class_bytes[n] = nb
        class_members[n] = [n]
    plan.feed_bytes = feed_bytes_total

    if not assume_donation:
        # no-donation dispatch: every persistable the block WRITES
        # (ParamOut in-place idiom — output name == persistable name —
        # or a transient output the donating path would have aliased
        # onto it) gets a FRESH output buffer of full size, live from
        # its first write until the dispatch returns: the pool/param
        # write-back copy such a step pays.
        for op in b.ops:
            for n in op.write_names():
                vd = local.get(n)
                if vd is None or not vd.persistable:
                    continue
                key = f"@nodonate@{n}"
                if key in class_range:
                    class_range[key][0] = min(class_range[key][0],
                                              op.idx)
                    continue
                class_range[key] = [op.idx, max(0, len(b.ops) - 1)]
                class_bytes[key] = vbytes(n)
                class_members[key] = [key]

    sub_extra = sub_extra or {}
    n_ops = max(1, len(b.ops))
    timeline: List[int] = []
    peak, peak_op = 0, 0
    for i in range(n_ops):
        live = persistable_base + sub_extra.get(i, 0)
        for root, (lo, hi) in class_range.items():
            if lo <= i <= hi:
                live += class_bytes[root]
        timeline.append(int(live))
        if live > peak:
            peak, peak_op = live, i
    plan.timeline = timeline
    plan.peak_bytes = int(peak)
    plan.peak_op = int(peak_op)
    plan.transient_peak = int(peak - persistable_base)

    contributors = []
    for root, (lo, hi) in class_range.items():
        if lo <= peak_op <= hi:
            members = class_members[root]
            contributors.append({
                "var": members[0] if len(members) == 1
                else "→".join(members[:4]),
                "bytes": int(class_bytes[root]),
                "kind": "feed" if root in feed_last else "activation",
                "live": [int(lo), int(hi)],
            })
    contributors.sort(key=lambda c: (-c["bytes"], c["var"]))
    plan.contributors = contributors
    return plan


class ProgramMemoryPlan:
    """Whole-program peak-HBM plan: resident persistables (params + KV
    pools, int8 sidecars included) + the worst transient live set."""

    __slots__ = ("peak_bytes", "peak_block", "peak_op", "components",
                 "contributors", "blocks", "approximate", "assume_batch")

    def top(self, k: int = 8) -> List[Dict[str, Any]]:
        return self.contributors[:k]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "peak_bytes": self.peak_bytes,
            "peak_op": {"block": self.peak_block, "op": self.peak_op},
            "components": dict(self.components),
            "top": self.top(),
            "assume_batch": self.assume_batch,
            "approximate": self.approximate,
            "blocks": {bi: p.to_dict() for bi, p in self.blocks.items()},
        }

    def describe(self) -> str:
        comp = ", ".join(f"{k}={v/2**20:.2f} MiB"
                         for k, v in self.components.items() if v)
        return (f"peak {self.peak_bytes / 2**20:.2f} MiB at block "
                f"{self.peak_block} op#{self.peak_op} ({comp})")


def plan_program(view_or_program, assume_batch: int = 1,
                 assume_donation: bool = True,
                 mesh_axes: Optional[Dict[str, int]] = None
                 ) -> ProgramMemoryPlan:
    """Peak-HBM plan over the whole program.  Persistables are counted
    once by name across every block (params vs KV state split via
    ``KV_POOL_MARKERS``); sub-block transient peaks are charged at
    their control-flow op's position in the parent timeline.
    ``assume_donation=False`` prices a step without in-place state
    writes (see block_byte_plan), so admission never under-counts the
    write-back copies such a step pays.  ``mesh_axes`` turns the plan
    into a PER-SHARD footprint: vars with sharding annotations (params,
    the KV pool) scale by their shard divisor while unannotated state
    (block tables, feeds, activations) stays charged replicated — the
    conservative side of a real partitioning."""
    view = view_or_program if isinstance(view_or_program, ProgramView) \
        else ProgramView(getattr(view_or_program, "desc", view_or_program))
    plan = ProgramMemoryPlan.__new__(ProgramMemoryPlan)
    plan.assume_batch = int(assume_batch)
    plan.approximate = False

    params_bytes, kv_bytes = 0, 0
    persist_items: List[Tuple[str, int, str]] = []
    seen: set = set()
    for b in view.blocks:
        for name, vd in b.desc.vars.items():
            if not vd.persistable or name in seen:
                continue
            seen.add(name)
            nb, approx = var_bytes(vd, assume_batch, mesh_axes)
            plan.approximate = plan.approximate or approx
            kind = "kv_pool" if _is_kv_state(name) else "params"
            persist_items.append((name, nb, kind))
            if kind == "kv_pool":
                kv_bytes += nb
            else:
                params_bytes += nb
    persistable_total = params_bytes + kv_bytes

    # bottom-up transient peaks so a control-flow op charges its body
    sub_peak: Dict[int, int] = {}
    block_plans: Dict[int, BlockBytePlan] = {}
    for b in reversed(view.blocks):
        extra = {op.idx: sum(sub_peak.get(si, 0) for si in op.sub_blocks)
                 for op in b.ops if op.sub_blocks}
        bp = block_byte_plan(view, b.idx, assume_batch, sub_extra=extra,
                             persistable_base=0,
                             assume_donation=assume_donation,
                             mesh_axes=mesh_axes)
        plan.approximate = plan.approximate or bp.approximate
        sub_peak[b.idx] = bp.peak_bytes
        block_plans[b.idx] = bp
    plan.blocks = block_plans

    root = block_plans.get(0)
    if root is None:
        plan.peak_bytes = persistable_total
        plan.peak_block, plan.peak_op = 0, 0
        plan.contributors = []
    else:
        plan.peak_bytes = persistable_total + root.peak_bytes
        plan.peak_block, plan.peak_op = 0, root.peak_op
        contributors = [dict(c) for c in root.contributors]
        contributors += [{"var": n, "bytes": nb, "kind": kind,
                          "live": None}
                         for n, nb, kind in persist_items]
        contributors.sort(key=lambda c: (-c["bytes"], c["var"]))
        plan.contributors = contributors

    # at-peak split of the transient live set: feed buffers vs
    # activations (the live classes at the peak op carry their kind)
    feed_total = act_total = 0
    if root is not None:
        feed_total = sum(c["bytes"] for c in root.contributors
                         if c["kind"] == "feed")
        act_total = max(0, root.timeline[root.peak_op] - feed_total)
    plan.components = {
        "params": int(params_bytes),
        "kv_pool": int(kv_bytes),
        "activations": int(act_total),
        "feeds": int(feed_total),
    }
    return plan


def legacy_stats(program_or_block, block_idx: int = 0,
                 assume_batch: int = 1) -> Dict[str, Any]:
    """The reference's ``memory_optimize`` stats contract (topo_order /
    level / live_range / reuse_slot / num_slots — its ``analyze_block``
    keys) extended with the byte timeline's peak accounting: one live-set
    derivation feeds both the slot coloring and the byte planner."""
    desc = getattr(program_or_block, "desc", program_or_block)
    view = ProgramView(desc) if hasattr(desc, "blocks") else None
    if view is None:
        raise TypeError("legacy_stats needs a Program or ProgramDesc")
    bp = block_byte_plan(view, block_idx, assume_batch)
    out = dict(bp.liveness)
    out["peak_transient_bytes"] = bp.transient_peak
    out["peak_op"] = bp.peak_op
    out["byte_timeline"] = list(bp.timeline)
    return out


# ---------------------------------------------------------------------------
# roofline rollup
# ---------------------------------------------------------------------------

class RooflineReport:
    __slots__ = ("chip", "total_flops", "total_bytes", "step_time_s",
                 "by_op_type", "unregistered", "approximate")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "chip": self.chip.to_dict(),
            "total_flops": self.total_flops,
            "total_hbm_bytes": self.total_bytes,
            "step_time_s": self.step_time_s,
            "by_op_type": {t: dict(d) for t, d in self.by_op_type.items()},
            "unregistered": dict(self.unregistered),
            "approximate": self.approximate,
        }


def roofline(view_or_program, chip=None,
             assume_batch: int = 1) -> RooflineReport:
    """Sum per-op ``max(flops/peak, bytes/bw)`` over the program tree
    into a step-time estimate.  Control-flow ops charge their body per
    trip (``max_iters`` when declared; once otherwise, as the
    reference prices them),
    so total_flops, by_op_type, and step_time_s all see the same trip
    multiplier and stay mutually consistent."""
    view = view_or_program if isinstance(view_or_program, ProgramView) \
        else ProgramView(getattr(view_or_program, "desc", view_or_program))
    chip = get_chip(chip)
    rep = RooflineReport.__new__(RooflineReport)
    rep.chip = chip
    rep.by_op_type = {}
    rep.unregistered = {}
    rep.approximate = False
    rep.total_flops = rep.total_bytes = 0.0

    def charge(block_idx: int, mult: int, stack: frozenset) -> None:
        # stack guards cyclic/bogus sub-block references the same way
        # ProgramView.block_effects does — seeded-bad programs must
        # produce a report, not a hang
        if block_idx in stack or not 0 <= block_idx < len(view.blocks):
            return
        b = view.blocks[block_idx]
        env = CostEnv(view, block_idx, assume_batch)
        for op in b.ops:
            if op.sub_blocks:
                # layers.While stores max_iters=None when unbounded
                trips = max(1, int(op.desc.attrs.get("max_iters") or 1))
                for si in op.sub_blocks:
                    charge(si, mult * trips, stack | {block_idx})
                continue
            c = op_cost(env, op.desc)
            rep.total_flops += mult * c.flops
            rep.total_bytes += mult * c.bytes_total
            agg = rep.by_op_type.setdefault(
                op.type, {"count": 0, "flops": 0.0, "bytes": 0.0,
                          "time_s": 0.0})
            base = op.type[:-5] if op.type.endswith("_grad") else op.type
            rate = chip.conv_flops if base in CONV_OPS \
                else chip.peak_flops
            t = max(c.flops / rate, c.bytes_total / chip.hbm_bw)
            agg["count"] += mult
            agg["flops"] += mult * c.flops
            agg["bytes"] += mult * c.bytes_total
            agg["time_s"] += mult * t
            if not c.registered:
                rep.unregistered[op.type] = \
                    rep.unregistered.get(op.type, 0) + mult
        rep.approximate = rep.approximate or env.approx

    if view.blocks:
        charge(0, 1, frozenset())
    rep.step_time_s = sum(d["time_s"] for d in rep.by_op_type.values())
    for t, d in rep.by_op_type.items():
        d["bound"] = ("compute" if d["flops"] / chip.peak_flops
                      >= d["bytes"] / chip.hbm_bw else "memory")
    return rep


# ---------------------------------------------------------------------------
# the analysis pass (wired into PASSES / LEVELS["cost"])
# ---------------------------------------------------------------------------

def cost_pass(ctx, diag: Diagnostics) -> None:
    """Peak-HBM plan + roofline estimate as findings and a structured
    report (``diag.reports["cost"]``).  Options (``ctx.options``):
    ``assume_batch`` (int, default 1 — substituted for dynamic batch
    dims), ``chip`` (ChipSpec or name), ``budget_bytes`` (int —
    error-severity finding when the static peak exceeds it)."""
    opts = getattr(ctx, "options", {}) or {}
    assume_batch = int(opts.get("assume_batch", 1))
    chip = get_chip(opts.get("chip"))

    plan = plan_program(ctx.view, assume_batch,
                        mesh_axes=opts.get("mesh_axes"))
    roof = roofline(ctx.view, chip, assume_batch)
    diag.reports["cost"] = {"memory": plan.to_dict(),
                            "roofline": roof.to_dict()}

    for op_type, count in sorted(roof.unregistered.items()):
        diag.add(Finding(
            WARNING, "cost", "unregistered-cost-rule",
            f"op type '{op_type}' has no registered cost rule "
            f"({count} instance(s)) — conservative default used "
            f"(1 flop/output element, all inputs read)"))

    top = ", ".join(f"{c['var']}={c['bytes']/2**20:.2f}MiB"
                    for c in plan.top(3))
    diag.add(Finding(
        INFO, "cost", "summary",
        f"static peak HBM {plan.peak_bytes/2**20:.2f} MiB "
        f"({plan.describe()}); roofline step "
        f"{roof.step_time_s*1e3:.3f} ms on {chip.name} "
        f"({roof.total_flops/1e9:.2f} GFLOP, "
        f"{roof.total_bytes/2**20:.2f} MiB HBM traffic); top: {top}",
        block=plan.peak_block))

    budget = opts.get("budget_bytes")
    if budget is not None and plan.peak_bytes > int(budget):
        comp = ", ".join(f"{k}={v}" for k, v in plan.components.items())
        diag.add(Finding(
            ERROR, "cost", "over-budget",
            f"static peak HBM {plan.peak_bytes} bytes exceeds the "
            f"declared budget {int(budget)} bytes by "
            f"{plan.peak_bytes - int(budget)} ({comp}); top "
            f"contributors: {top}",
            block=plan.peak_block))
