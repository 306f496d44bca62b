"""Op registry: op semantics registered as PyTorch emitters — the port of
``paddle_tpu/fluid/core/registry.py``.

Each op registers ONE function of tensors.  The same emitter runs at
graph-build time on ``meta`` tensors (shape and dtype inference, see
``framework.Block._infer_op``) and at run time on the executor's device.

Gradients keep the desc-level contract: ``append_backward`` emits real
``*_grad`` ops into the program.  A ``*_grad`` op without its own
emitter is lowered generically (``lowering.py``): the forward op runs
under autograd and keeps its graph for its grad op, which then takes
the vector-Jacobian product — the forward is never run twice.  Ops with
a cheaper adjoint register a ``*_grad`` emitter of their own.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["OpInfo", "EmitCtx", "register", "primitive", "get_op_info",
           "has_op", "registered_ops", "GRAD_SUFFIX", "grad_var_name",
           "is_grad_op_type", "base_op_type"]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def is_grad_op_type(op_type: str) -> bool:
    return op_type.endswith("_grad")


def base_op_type(grad_op_type: str) -> str:
    if not grad_op_type.endswith("_grad"):
        raise ValueError(f"{grad_op_type!r} is not a grad op type")
    return grad_op_type[: -len("_grad")]


class EmitCtx:
    """Per-op emission context handed to every emitter.

    Carries the op's attributes, the device that ops creating tensors
    from nothing allocate on (``meta`` during shape inference), and the
    op's random seed, the uint32 ``op_seed`` the lowering derives from
    the program seed, the step and the op's ``__rng_salt__`` (the
    reference carries a JAX key here).  For an op that draws on the
    device (dropout, fused_attention) the seed is a 0-d int32 tensor
    holding those 32 bits, a view into the step's seed buffer on the
    executor's device, as the reference's ``rng_bits`` are a traced
    input: a captured step reads it at each replay.  An op registered
    with ``host_rng=True`` draws on the host and gets a Python int.  The
    seed is None where no draw may happen, as in shape inference.

    ``lower_block(idx, env) -> env`` runs sub-block ``idx`` over the
    name -> value map ``env`` (the control-flow ops' hook into the
    lowering, as in the reference); None where no block may run, as in
    shape inference.
    """

    __slots__ = ("op", "attrs", "seed", "device", "lower_block", "mode")

    def __init__(self, op, seed: Optional[int] = None,
                 device: Optional[torch.device] = None,
                 lower_block: Optional[Callable] = None, mode: str = "train"):
        self.op = op
        self.attrs = op.attrs
        self.seed = seed
        self.device = torch.device("cpu") if device is None else device
        self.lower_block = lower_block
        self.mode = mode                # "train" | "infer"

    def attr(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)


class OpInfo:
    """Registered semantics for one op type."""

    __slots__ = ("type", "emit", "no_grad", "stop_grad_slots", "host_rng",
                 "doc")

    def __init__(self, type: str, emit: Callable, no_grad: bool = False,
                 stop_grad_slots: Sequence[str] = (), host_rng: bool = False,
                 doc: str = ""):
        self.type = type
        self.emit = emit          # (ctx, ins: dict[str, list]) -> dict[str, list]
        self.no_grad = no_grad
        self.stop_grad_slots = tuple(stop_grad_slots)
        self.host_rng = host_rng  # draws on the host from an int seed
        self.doc = doc


_REGISTRY: Dict[str, OpInfo] = {}


def register(op_info: OpInfo) -> OpInfo:
    if op_info.type in _REGISTRY:
        raise ValueError(f"op {op_info.type!r} already registered")
    _REGISTRY[op_info.type] = op_info
    return op_info


def get_op_info(op_type: str) -> OpInfo:
    try:
        return _REGISTRY[op_type]
    except KeyError:
        raise KeyError(
            f"op {op_type!r} is not registered in paddle_tpu_torch; known "
            f"ops: {sorted(_REGISTRY)}") from None


def has_op(op_type: str) -> bool:
    return op_type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)


def _parse_slot(spec: str):
    """Slot spec mini-language: "X" required single, "Bias?" optional
    single, "X*" variadic list."""
    if spec.endswith("*"):
        return spec[:-1], "list"
    if spec.endswith("?"):
        return spec[:-1], "optional"
    return spec, "single"


def primitive(op_type: str, inputs: Sequence[str] = ("X",),
              outputs: Sequence[str] = ("Out",), no_grad: bool = False,
              stop_grad_slots: Sequence[str] = (),
              seq_transparent: bool = False, host_rng: bool = False):
    """Decorator: register a function of (ctx, *input_slots) -> output
    value(s) as an op emitter.  The function receives one positional arg
    per input slot (a tensor, None for a missing optional, or a list for
    a variadic slot) and returns one value per output slot (a tuple if
    several).

    ``seq_transparent=True``: a SeqArray input reaches the function as
    its ``.data``, and every output is re-wrapped with the lengths of the
    first SeqArray input — how elementwise ops inherit the sequence
    structure of their input.

    ``host_rng=True``: the op draws its random numbers on the host from
    ``ctx.seed`` as a Python int, so a captured step cannot hold it."""
    in_specs = [_parse_slot(s) for s in inputs]
    out_names = list(outputs)

    def deco(fn):
        def emit(ctx: EmitCtx, ins: Dict[str, list]) -> Dict[str, list]:
            from .lod import SeqArray

            args = []
            lengths = None
            for name, kind in in_specs:
                vals = ins.get(name, [])
                if seq_transparent:
                    unwrapped = []
                    for v in vals:
                        if isinstance(v, SeqArray):
                            if lengths is None:
                                lengths = v.lengths
                            v = v.data
                        unwrapped.append(v)
                    vals = unwrapped
                if kind == "list":
                    args.append(list(vals))
                elif kind == "optional":
                    args.append(vals[0] if vals else None)
                else:
                    if not vals:
                        raise ValueError(
                            f"op {op_type}: missing required input slot "
                            f"{name}")
                    args.append(vals[0])
            result = fn(ctx, *args)
            if len(out_names) == 1:
                result = (result,)
            elif not isinstance(result, tuple):
                raise ValueError(f"op {op_type}: expected tuple of "
                                 f"{len(out_names)} outputs")
            out = {}
            for slot, val in zip(out_names, result):
                vals = list(val) if isinstance(val, list) else [val]
                if lengths is not None:
                    vals = [v if isinstance(v, SeqArray)
                            else SeqArray(v, lengths) for v in vals]
                out[slot] = vals
            return out

        register(OpInfo(type=op_type, emit=emit, no_grad=no_grad,
                        stop_grad_slots=stop_grad_slots, host_rng=host_rng,
                        doc=inspect.getdoc(fn) or ""))
        return fn

    return deco
