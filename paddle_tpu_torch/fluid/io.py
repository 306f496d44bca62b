"""Program IO — the port of ``paddle_tpu/fluid/io.py``, cut to
``prune_program``, the inference slice ``FullRerunDecoder`` runs.  The
reference's save / load of tensors, checkpoints and inference models are
not ported."""

from __future__ import annotations

from typing import List

from .framework import Program, Variable

__all__ = ["prune_program"]


def prune_program(program: Program, targets: List[Variable]) -> Program:
    """A copy of ``program`` (``clone(for_test=True)``) whose global
    block keeps only the ops ``targets`` need, as the reference's
    ``Program.prune`` slices it.  Training-only ops (those that touch an
    ``@GRAD`` var: every grad op and optimizer update) go first, unless
    a target is itself a gradient; then a backward walk keeps each op
    that writes a needed var and marks its inputs needed."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = {t.name if isinstance(t, Variable) else str(t) for t in targets}
    want_grads = any(n.endswith("@GRAD") for n in needed)

    def touches_grad(od) -> bool:
        return any(n and n.endswith("@GRAD")
                   for ns in list(od.inputs.values())
                   + list(od.outputs.values()) for n in ns)

    descs = (block.desc.ops if want_grads else
             [od for od in block.desc.ops if not touches_grad(od)])
    keep = []
    for od in reversed(descs):
        outs = {n for ns in od.outputs.values() for n in ns}
        if outs & needed:
            keep.append(od)
            needed |= {n for ns in od.inputs.values() for n in ns if n}
    kept = {id(od) for od in keep}
    block.desc.ops = [od for od in block.desc.ops if id(od) in kept]
    block.ops = [op for op in block.ops if id(op.desc) in kept]
    pruned._bump_version()
    return pruned
