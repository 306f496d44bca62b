"""Control-flow ops: sub-blocks run inside an op — the port of
``paddle_tpu/fluid/ops/control_flow_ops.py``, every op of it.

Each op runs its sub-block through ``ctx.lower_block`` (the lowering's
sub-block runner) over a name -> value map, as the reference traces it
into ``lax.while_loop`` / ``lax.scan`` / ``lax.cond``; here the loops
are Python loops over eager PyTorch ops:

* ``while`` with ``max_iters`` runs exactly ``max_iters`` iterations and
  keeps each iteration's carries only where the condition held
  (``torch.where``), as the reference's masked scan does: the trip count
  is static, so a step holding one is captured in a CUDA graph like any
  other, and autograd differentiates it.  Without ``max_iters`` the trip
  count depends on the data: the host reads the condition once per
  iteration (``read_condition``; ``HOST_LOOP`` counts the iterations and
  the reads).  Such a step cannot sit in a captured graph, so the
  executor runs it eagerly on the card (``fluid/executor.py``).
* ``recurrent`` (StaticRNN) and ``dynamic_recurrent`` (DynamicRNN) loop
  over the padded time axis, a static trip count; the dynamic form
  blends each step's state as ``m * new + (1 - m) * old`` and scales
  its outputs by the step's mask ``m``, the reference's formula (not a
  select: the rounding and the NaN behaviour are the reference's).
* ``conditional_block`` runs its sub-block and selects per the scalar
  condition on the device, where the reference's ``lax.cond`` runs one
  branch: the same values with no host read.
* Tensor arrays are a dense ``TensorArray`` (data [capacity, ...] and a
  0-d int32 size).  A write copies its element in at a device index
  (``index_copy``) and drops a past-capacity write by a select, so the
  index is never read on the host.
"""

from __future__ import annotations

from typing import Any, List

import torch

from ..core.lod import NestedSeqArray, SeqArray, seq_mask
from ..core.registry import OpInfo, primitive, register
from ..core.types import runtime_dtype, torch_dtype
from .math_ops import weak_scalar

__all__ = ["TensorArray", "RankTable", "HOST_LOOP", "read_condition"]

# what the data-dependent loops have done: iterations run and conditions
# read on the host (each a host sync on the card); callers zero them
HOST_LOOP = {"iterations": 0, "reads": 0}


class TensorArray:
    """Dense tensor array: a stacked buffer [capacity, ...] and the
    number of valid entries (a 0-d int32 tensor on the buffer's device),
    the reference's dense stand-in for a LoDTensorArray."""

    __slots__ = ("data", "size")

    def __init__(self, data, size):
        self.data = data
        self.size = size

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def detach(self) -> "TensorArray":
        return TensorArray(self.data.detach(), self.size)

    def __repr__(self):
        return f"TensorArray(data={tuple(self.data.shape)})"


class RankTable:
    """Per-sequence lengths (reference LoDRankTable).  Under the padded
    layout masking replaces the reference's shrinking batch, so the
    table carries the lengths only."""

    __slots__ = ("lengths",)

    def __init__(self, lengths):
        self.lengths = lengths

    def detach(self) -> "RankTable":
        return self


def _scalar_bool(c) -> torch.Tensor:
    """The condition as a 0-d bool tensor on its device."""
    x = c.data if isinstance(c, SeqArray) else c
    return x.reshape(()).to(torch.bool)


def read_condition(c) -> bool:
    """The condition on the host: one read (a host sync on the card),
    which may not happen while a CUDA graph captures.  The read is
    allowed under the executor's sync guard: it is the one sync a
    data-dependent loop makes each iteration."""
    x = _scalar_bool(c)
    HOST_LOOP["reads"] += 1
    if not x.is_cuda:
        return bool(x.item())
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "while without max_iters reads its condition on the host each "
            "iteration, which a CUDA graph cannot capture")
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return bool(x.item())
    finally:
        torch.cuda.set_sync_debug_mode(old)


# ---------------------------------------------------------------------------
# compare / logical ops and increment
# ---------------------------------------------------------------------------

def _cmp(op_type, fn):
    @primitive(op_type, inputs=["X", "Y"], outputs=["Out"], no_grad=True,
               seq_transparent=True)
    def _emit(ctx, x, y):
        return fn(x, y)
    _emit.__name__ = op_type
    return _emit


_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)


def _logical(op_type, fn, arity=2):
    @primitive(op_type, inputs=["X", "Y"][:arity], outputs=["Out"],
               no_grad=True, seq_transparent=True)
    def _emit(ctx, *args):
        return fn(*args)
    _emit.__name__ = op_type
    return _emit


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, arity=1)


@primitive("increment", inputs=["X"], outputs=["Out"], no_grad=True)
def increment(ctx, x):
    """X + step in X's dtype (the reference's ``asarray(step, x.dtype)``:
    truncated for an integer counter).  A Python scalar, so no host value
    is copied to the card."""
    step = ctx.attr("step", 1.0)
    if x.is_floating_point():
        return x + weak_scalar(step, x)
    return x + int(step)


# ---------------------------------------------------------------------------
# tensor-array ops
# ---------------------------------------------------------------------------

@primitive("lod_rank_table", inputs=["X"], outputs=["Out"], no_grad=True)
def lod_rank_table(ctx, x):
    """The lengths of a sequence batch (a dense batch: every row its full
    time axis)."""
    if isinstance(x, SeqArray):
        return RankTable(x.lengths)
    return RankTable(torch.full((x.shape[0],), x.shape[1],
                                dtype=torch.int32, device=x.device))


@primitive("max_sequence_len", inputs=["RankTable"], outputs=["Out"],
           no_grad=True)
def max_sequence_len(ctx, rt):
    return rt.lengths.max().to(torch.int32).reshape(1)


def _ta_emit(ctx, ins):
    """write_to_array: X at index I, on the device.  The first write
    allocates the buffer (the ``capacity`` attr); a write at or past
    capacity leaves the array as it was."""
    x = ins["X"][0]
    i = ins["I"][0].reshape(()).to(torch.int32)
    arr = ins.get("Array", [None])[0]
    xd = x.data if isinstance(x, SeqArray) else x
    if arr is None:
        cap = int(ctx.attr("capacity", 64))
        arr = TensorArray(
            torch.zeros((cap,) + tuple(xd.shape), dtype=xd.dtype,
                        device=xd.device),
            torch.zeros((), dtype=torch.int32, device=xd.device))
    cap = arr.data.shape[0]
    in_range = i < cap
    at = i.clamp(0, cap - 1).to(torch.int64).reshape(1)
    data = arr.data.index_copy(0, at, xd.to(arr.data.dtype).unsqueeze(0))
    data = torch.where(in_range, data, arr.data)
    size = torch.where(in_range, torch.maximum(arr.size, i + 1), arr.size)
    return {"Out": [TensorArray(data, size)]}


register(OpInfo("write_to_array", _ta_emit))


@primitive("read_from_array", inputs=["X", "I"], outputs=["Out"])
def read_from_array(ctx, arr, i):
    """Entry I (clamped into the buffer, as XLA's dynamic index is)."""
    at = i.reshape(()).to(torch.int64).clamp(0, arr.data.shape[0] - 1)
    return arr.data.index_select(0, at.reshape(1)).squeeze(0)


@primitive("array_length", inputs=["X"], outputs=["Out"], no_grad=True)
def array_length(ctx, arr):
    return arr.size.to(torch.int32).reshape(1)


@primitive("lod_tensor_to_array", inputs=["X", "RankTable"],
           outputs=["Out"])
def lod_tensor_to_array(ctx, x, rt):
    """A sequence batch [B, T, ...] as T entries [B, ...] (no rank-table
    sort under the padded layout)."""
    data = x.data if isinstance(x, SeqArray) else x
    stacked = data.transpose(0, 1)
    return TensorArray(stacked, torch.full((), stacked.shape[0],
                                           dtype=torch.int32,
                                           device=stacked.device))


@primitive("array_to_lod_tensor", inputs=["X", "RankTable"],
           outputs=["Out"])
def array_to_lod_tensor(ctx, arr, rt):
    """The entries stacked back to [B, T, ...], with the rank table's
    lengths."""
    data = arr.data.transpose(0, 1)
    if isinstance(rt, RankTable):
        return SeqArray(data, rt.lengths)
    return data


@primitive("shrink_rnn_memory", inputs=["X", "RankTable", "I"],
           outputs=["Out"])
def shrink_rnn_memory(ctx, x, rt, i):
    """Identity: under padding and masking the carry keeps its batch
    (``dynamic_recurrent`` freezes finished rows)."""
    return x


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

def _select(pred: torch.Tensor, new, old):
    """``where(pred, new, old)`` over a carry, field by field."""
    if isinstance(new, TensorArray):
        return TensorArray(torch.where(pred, new.data, old.data),
                           torch.where(pred, new.size, old.size))
    if isinstance(new, SeqArray):
        return SeqArray(torch.where(pred, new.data, old.data),
                        torch.where(pred, new.lengths, old.lengths))
    return torch.where(pred, new, old)


def _while_emit(ctx, ins):
    op = ctx.op
    sub_idx = op.block_attr("sub_block")
    # the X / Condition slots hold the @PRE snapshots of the carried
    # vars; the sub-block reads and writes them by their own names
    x_names = op.attr("carried_names", None) or op.input("X")
    cond_name = op.attr("cond_name", None) or op.input("Condition")[0]
    xs = tuple(ins.get("X", []))
    p_env = dict(zip(op.input("P"), ins.get("P", [])))
    cond = ins["Condition"][0]
    max_iters = op.attr("max_iters", None)

    def body(cond, xs):
        env = dict(p_env)
        env.update(zip(x_names, xs))
        env[cond_name] = cond
        env = ctx.lower_block(sub_idx, env)
        return env[cond_name], tuple(env[n] for n in x_names)

    if max_iters is None:
        # a data-dependent trip count: the host reads the condition
        while read_condition(cond):
            cond, xs = body(cond, xs)
            HOST_LOOP["iterations"] += 1
    else:
        # exactly max_iters iterations, each kept where the condition
        # held: a static trip count, differentiable
        for _ in range(int(max_iters)):
            pred = _scalar_bool(cond)
            ncond, nxs = body(cond, xs)
            xs = tuple(_select(pred, n, o) for n, o in zip(nxs, xs))
            cond = torch.where(pred, ncond, cond)
    out = {"Out": list(xs)}
    if op.output("CondOut"):
        out["CondOut"] = [cond]
    return out


register(OpInfo("while", _while_emit, stop_grad_slots=("Condition",),
                doc="reference while_op.cc:52 WhileOp"))


# ---------------------------------------------------------------------------
# recurrent (StaticRNN) / dynamic_recurrent (DynamicRNN)
# ---------------------------------------------------------------------------

def _col(m: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [B] step mask shaped to broadcast over a [B, ...] value."""
    return m.reshape((-1,) + (1,) * (ndim - 1))


def _stack(vals: List[Any]):
    if isinstance(vals[0], SeqArray):
        return SeqArray(torch.stack([v.data for v in vals]),
                        torch.stack([v.lengths for v in vals]))
    return torch.stack(vals)


def _recurrent_common(ctx, ins, masked: bool):
    op = ctx.op
    sub_idx = op.block_attr("sub_block")
    in_names = op.attr("step_input_names")       # inner per-step vars
    state_names = op.attr("state_names")         # inner pre-state vars
    update_names = op.attr("state_update_names")  # inner updated states
    out_names = op.attr("step_output_names")     # inner per-step outputs
    auto_init = op.attr("auto_init_states", [])  # zero-init state specs
    reverse = bool(op.attr("is_reverse", False))

    p_env = dict(zip(op.input("P"), ins.get("P", [])))
    lengths = None
    datas = []
    for x in ins.get("X", []):
        if isinstance(x, NestedSeqArray):
            # a step input over sub-sequences (the reference's
            # recurrent-over-subsequences): the loop steps the OUTER
            # axis and each step sees one sub-sequence of every row as a
            # level-1 SeqArray, data [B, M, ...] and lengths
            # inner_lengths[:, step]
            lengths = x.outer_lengths if lengths is None else lengths
            datas.append(SeqArray(
                x.data.transpose(0, 1).contiguous(),
                x.inner_lengths.transpose(0, 1).contiguous()))
        elif isinstance(x, SeqArray):
            lengths = x.lengths if lengths is None else lengths
            datas.append(x.data.transpose(0, 1))          # [T, B, ...]
        else:
            datas.append(x.transpose(0, 1))

    lead = datas[0].data if isinstance(datas[0], SeqArray) else datas[0]
    T, batch = lead.shape[0], lead.shape[1]
    dtype = lead.dtype if lead.is_floating_point() else torch.float32
    dev = lead.device

    inits = list(ins.get("InitStates", []))
    carry = []
    for k in range(len(state_names)):
        spec = auto_init[k] if k < len(auto_init) else None
        if spec is not None:
            dt = (torch_dtype(runtime_dtype(spec["dtype"]))
                  if "dtype" in spec else dtype)
            carry.append(torch.full((batch,) + tuple(spec["shape"]),
                                    spec.get("value", 0.0), dtype=dt,
                                    device=dev))
        else:
            carry.append(inits.pop(0))
    carry = tuple(carry)

    if masked and lengths is not None:
        mask = seq_mask(lengths, T).to(dtype).transpose(0, 1)   # [T, B]
    else:
        mask = torch.ones((T, batch), dtype=dtype, device=dev)
    if reverse:
        datas = [SeqArray(torch.flip(d.data, [0]), torch.flip(d.lengths, [0]))
                 if isinstance(d, SeqArray) else torch.flip(d, [0])
                 for d in datas]
        mask = torch.flip(mask, [0])

    steps = []
    for t in range(T):
        mt = mask[t]
        env = dict(p_env)
        env.update(zip(state_names, carry))
        env.update(zip(in_names, (
            SeqArray(d.data[t], d.lengths[t]) if isinstance(d, SeqArray)
            else d[t] for d in datas)))
        env = ctx.lower_block(sub_idx, env)
        new = tuple(env[n] for n in update_names)
        outs = tuple(env[n] for n in out_names)
        if masked:
            new = tuple(_col(mt, n.dim()) * n + (1 - _col(mt, n.dim())) * o
                        for n, o in zip(new, carry))
            outs = tuple(
                SeqArray(o.data * _col(mt, o.data.dim()),
                         (o.lengths * mt.to(o.lengths.dtype))
                         .to(o.lengths.dtype))
                if isinstance(o, SeqArray) else o * _col(mt, o.dim())
                for o in outs)
        carry = new
        steps.append(outs)

    stacked = []
    for k in range(len(out_names)):
        o = _stack([s[k] for s in steps])                     # [T, B, ...]
        if isinstance(o, SeqArray):
            # per-step sequence outputs stack to a nested sequence
            od, ol = o.data, o.lengths
            if reverse:
                od, ol = torch.flip(od, [0]), torch.flip(ol, [0])
            outer = lengths if lengths is not None else torch.full(
                (batch,), T, dtype=torch.int32, device=dev)
            stacked.append(NestedSeqArray(od.transpose(0, 1), outer,
                                          ol.transpose(0, 1)))
            continue
        o = torch.flip(o, [0]) if reverse else o
        o = o.transpose(0, 1)                                 # [B, T, ...]
        stacked.append(SeqArray(o, lengths)
                       if masked and lengths is not None else o)
    return {"Out": stacked, "FinalStates": list(carry)}


def _recurrent_emit(ctx, ins):
    return _recurrent_common(ctx, ins, masked=False)


def _dynamic_recurrent_emit(ctx, ins):
    return _recurrent_common(ctx, ins, masked=True)


register(OpInfo("recurrent", _recurrent_emit,
                doc="reference recurrent_op.cc:635 RecurrentOp: a static "
                    "RNN over the time axis"))
register(OpInfo("dynamic_recurrent", _dynamic_recurrent_emit,
                doc="DynamicRNN: a masked loop over the padded time axis"))


# ---------------------------------------------------------------------------
# conditional_block
# ---------------------------------------------------------------------------

def _conditional_block_emit(ctx, ins):
    """The sub-block's outputs where the scalar condition holds, the
    inputs of the same names elsewhere: the block runs and a device
    select keeps or drops its results (no host read)."""
    op = ctx.op
    sub_idx = op.block_attr("sub_block")
    x_names = op.attr("in_names", None) or op.input("X")
    out_names = op.attr("out_names")
    env0 = dict(zip(x_names, ins.get("X", [])))
    pred = _scalar_bool(ins["Cond"][0])
    env = ctx.lower_block(sub_idx, dict(env0))
    return {"Out": [_select(pred, env[n], env0[n]) for n in out_names]}


register(OpInfo("conditional_block", _conditional_block_emit,
                stop_grad_slots=("Cond",),
                doc="reference conditional_block_op.cc: a sub-block "
                    "under a scalar predicate"))


# ---------------------------------------------------------------------------
# IfElse split / merge and the rank reorder
# ---------------------------------------------------------------------------

@primitive("split_lod_tensor", inputs=["X", "Mask"],
           outputs=["OutTrue", "OutFalse"])
def split_lod_tensor(ctx, x, mask):
    """Rows of X to OutTrue where Mask, to OutFalse elsewhere, each over
    the full batch with the other rows zeroed (the reference's static
    shapes); merge_lod_tensor selects by the same mask."""
    data = x.data if isinstance(x, SeqArray) else x
    m = mask.reshape(-1).to(torch.bool)
    mb = _col(m, data.dim())
    zero = torch.zeros_like(data)
    t = torch.where(mb, data, zero)
    f = torch.where(mb, zero, data)
    if isinstance(x, SeqArray):
        none = torch.zeros_like(x.lengths)
        return (SeqArray(t, torch.where(m, x.lengths, none)),
                SeqArray(f, torch.where(m, none, x.lengths)))
    return t, f


@primitive("merge_lod_tensor", inputs=["InTrue", "InFalse", "Mask", "X?"])
def merge_lod_tensor(ctx, in_true, in_false, mask, x):
    """Rows from InTrue where Mask, from InFalse elsewhere."""
    td = in_true.data if isinstance(in_true, SeqArray) else in_true
    fd = in_false.data if isinstance(in_false, SeqArray) else in_false
    m = mask.reshape(-1).to(torch.bool)
    out = torch.where(_col(m, td.dim()), td, fd)
    if isinstance(in_true, SeqArray) and isinstance(in_false, SeqArray):
        return SeqArray(out, torch.where(m, in_true.lengths,
                                         in_false.lengths))
    return out


@primitive("reorder_lod_tensor_by_rank", inputs=["X", "RankTable"],
           outputs=["Out"])
def reorder_lod_tensor_by_rank(ctx, x, rt):
    """The batch in the rank table's order: descending length, ties in
    batch order (a stable sort)."""
    order = torch.argsort(-rt.lengths, stable=True)
    if isinstance(x, SeqArray):
        return SeqArray(x.data[order], x.lengths[order])
    return x[order]
