"""Desc-level automatic differentiation — the port of
``paddle_tpu/fluid/backward.py``, unchanged in what it emits: walk the
block's ops in reverse, emit one ``*_grad`` OpDesc per differentiable
forward op, insert ``sum`` ops where several consumers contribute to one
variable's gradient (``assign`` where there is one), seed d(loss)/d(loss)
with ``fill_constant``, and return the ``(parameter, gradient)`` pairs.

The grad ops need no hand-written emitters: ``lowering.py`` takes each
one's vector-Jacobian product through the autograd graph its forward op
kept (ops may still register a ``*_grad`` emitter of their own, as
``lookup_table`` does).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core.registry import (GRAD_SUFFIX, get_op_info, grad_var_name, has_op)
from .core.types import is_float_dtype
from .framework import Block, Operator, Parameter, Variable

__all__ = ["append_backward"]


def _differentiable_input_slots(op: Operator, block: Block,
                                no_grad: Set[str]):
    """Which (slot, var) pairs of a forward op should receive gradients."""
    info = get_op_info(op.type)
    out = []
    for slot, names in op.desc.inputs.items():
        if slot in info.stop_grad_slots:
            continue
        for pos, name in enumerate(names):
            if not name or name in no_grad:
                continue
            try:
                var = block.var(name)
            except KeyError:
                continue
            if var.stop_gradient or not is_float_dtype(var.dtype):
                continue
            out.append((slot, pos, name))
    return out


def _make_grad_var(block: Block, fwd_name: str, grad_name: str):
    """Declare the grad variable mirroring its forward var's metadata."""
    if grad_name in block.vars:
        return block.vars[grad_name]
    try:
        fwd = block.var(fwd_name)
        return block.create_var(name=grad_name, dtype=fwd.dtype,
                                shape=list(fwd.shape) if fwd.shape else None,
                                lod_level=fwd.lod_level)
    except KeyError:
        return block.create_var(name=grad_name)


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks: Optional[Sequence] = None,
                    ) -> List[Tuple[Parameter, Variable]]:
    """Append grad ops for every op contributing to ``loss``; returns
    (param, grad) pairs — mirror of reference backward.py:338.

    ``callbacks``: callables ``cb(block, op)`` invoked after each op this
    pass appends (the reference's _append_backward_ops_ hook) — how
    ``Optimizer.minimize`` applies per-var ``error_clip``
    (``clip.error_clip_callback``) to gradients as they are produced."""
    block = loss.block
    program = block.program
    no_grad = set(no_grad_set or ())
    callbacks = list(callbacks or ())

    def emit(type, inputs=None, outputs=None, attrs=None, **kw):
        op = block.append_op(type, inputs, outputs, attrs, **kw)
        for cb in callbacks:
            cb(block, op)
        return op

    fwd_ops = list(block.ops)

    # seed d(loss)/d(loss) = 1 (reference fill_constant at backward.py:365)
    loss_grad = grad_var_name(loss.name)
    _make_grad_var(block, loss.name, loss_grad)
    emit(
        "fill_constant", outputs={"Out": block.vars[loss_grad]},
        attrs={"shape": list(loss.shape or []), "value": 1.0,
               "dtype": loss.dtype})

    # pending[var] = list of grad contribution var-names not yet summed
    pending: Dict[str, List[str]] = defaultdict(list)
    pending[loss.name].append(loss_grad)
    finalized: Dict[str, str] = {}

    def finalize(name: str) -> Optional[str]:
        """Collapse contributions for forward var `name` into its canonical
        grad var (inserting the fan-in `sum` op like backward.py:134).
        Single contributions are `assign`ed to the canonical name — XLA
        elides the copy, and every var's gradient is findable at
        grad_var_name(var)."""
        if name in finalized:
            return finalized[name]
        contribs = pending.get(name, [])
        if not contribs:
            return None
        canon = grad_var_name(name)
        if canon in contribs:
            pass  # seed grad (loss) already carries the canonical name
        else:
            _make_grad_var(block, name, canon)
            if len(contribs) == 1:
                emit("assign",
                     inputs={"X": block.vars[contribs[0]]},
                     outputs={"Out": block.vars[canon]})
            else:
                emit("sum",
                     inputs={"X": [block.vars[c] for c in contribs]},
                     outputs={"Out": block.vars[canon]})
        finalized[name] = canon
        return canon

    for op in reversed(fwd_ops):
        info = get_op_info(op.type) if has_op(op.type) else None
        if info is not None and info.no_grad:
            continue
        # available output grads for this op
        grad_inputs: Dict[str, List[Variable]] = {}
        any_grad = False
        for slot, names in op.desc.outputs.items():
            gnames = []
            for n in names:
                g = finalize(n) if n else None
                if g is not None:
                    any_grad = True
                    gnames.append(g)
                else:
                    gnames.append(None)
            if any(g is not None for g in gnames):
                # partial within-slot grads: materialize zeros for the holes
                fixed = []
                for n, g in zip(names, gnames):
                    if g is None:
                        z = grad_var_name(n) + "@ZERO"
                        _make_grad_var(block, n, z)
                        emit("fill_zeros_like",
                             inputs={"X": block.var(n)},
                             outputs={"Out": block.vars[z]})
                        g = z
                    fixed.append(g)
                grad_inputs[slot + GRAD_SUFFIX] = [block.vars[g] for g in fixed]
        if not any_grad:
            continue

        targets = _differentiable_input_slots(op, block, no_grad)
        if not targets:
            continue

        g_inputs = {slot: [block.var(n) for n in names if n]
                    for slot, names in op.desc.inputs.items()}
        g_inputs.update(grad_inputs)
        # grad outputs stay POSITIONALLY aligned with the forward slot's
        # entries ("" = hole for a non-differentiable entry) so the generic
        # vjp emitter can pair gradients by position
        g_outputs: Dict[str, List] = defaultdict(list)
        for slot, pos, name in targets:
            aligned = g_outputs[slot + GRAD_SUFFIX]
            want = len(op.desc.inputs[slot])
            if not aligned:
                aligned.extend([""] * want)
            gname = f"{grad_var_name(name)}@RENAME@{len(pending[name])}"
            _make_grad_var(block, name, gname)
            pending[name].append(gname)
            aligned[pos] = block.vars[gname]
        # drop trailing holes (keeps single-entry slots tidy)
        for slot in list(g_outputs):
            while g_outputs[slot] and g_outputs[slot][-1] == "":
                g_outputs[slot].pop()
        emit(op.type + "_grad", inputs=g_inputs,
             outputs=dict(g_outputs), attrs=dict(op.desc.attrs),
             infer_shape=False)

    # finalize leaves (vars with no producer op in this block: parameters,
    # data vars) so grad_var_name(v) always resolves
    for name in list(pending):
        finalize(name)

    # collect (param, grad)
    params_grads: List[Tuple[Parameter, Variable]] = []
    params = (block.all_parameters() if parameter_list is None
              else [block.var(p) for p in parameter_list])
    for p in params:
        if isinstance(p, Parameter) and not p.trainable:
            continue
        if p.name in no_grad:
            continue
        g = finalize(p.name)
        if g is None:
            continue
        params_grads.append((p, block.vars[g]))
    program._bump_version()
    return params_grads
