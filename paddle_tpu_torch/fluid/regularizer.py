"""Weight-decay regularizers — the port of
``paddle_tpu/fluid/regularizer.py`` (analog of
python/paddle/v2/fluid/regularizer.py): decay terms are
appended to gradients as real ops before the optimizer ops, with the
reference's names and op order."""

from __future__ import annotations

__all__ = ["append_regularization_ops", "L1Decay", "L2Decay",
           "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, helper):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, helper):
        decay = helper.create_tmp_variable(param.dtype)
        helper.append_op("scale", {"X": param}, {"Out": decay},
                         {"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, helper):
        sign = helper.create_tmp_variable(param.dtype)
        helper.append_op("sign", {"X": param}, {"Out": sign})
        decay = helper.create_tmp_variable(param.dtype)
        helper.append_op("scale", {"X": sign}, {"Out": decay},
                         {"scale": self._coeff})
        return decay


def grad_is_selected_rows(grad) -> bool:
    """True if `grad` is produced by a sparse lookup_table_grad (directly or
    through a sum fan-in) — i.e. its runtime value is a SelectedRows, which
    elementwise ops cannot consume."""
    producers = {}
    for op in grad.block.ops:
        for names in op.desc.outputs.values():
            for n in names:
                producers[n] = op

    def check(name, depth=0):
        op = producers.get(name)
        if op is None or depth > 8:
            return False
        if op.type == "lookup_table_grad":
            return bool(op.desc.attrs.get("is_sparse"))
        if op.type in ("sum", "assign"):   # fan-in / finalize passthrough
            return any(check(n, depth + 1)
                       for ns in op.desc.inputs.values() for n in ns)
        return False

    return check(grad.name)


def append_regularization_ops(parameters_and_grads, regularization=None,
                              main_program=None):
    """reference regularizer.py:15 — param-level regularizer wins over the
    optimizer-level default.  Sparse (SelectedRows) grads skip
    regularization with a warning, matching the reference, which has no
    SelectedRows weight-decay kernel either."""
    from .layer_helper import LayerHelper

    out = []
    for param, grad in parameters_and_grads:
        regularizer = getattr(param, "regularizer", None) or regularization
        if grad is None or regularizer is None:
            out.append((param, grad))
            continue
        if grad_is_selected_rows(grad):
            import warnings

            warnings.warn(
                f"regularization on sparse-grad parameter {param.name!r} "
                "is not applied (SelectedRows grads have no dense decay "
                "path); use is_sparse=False if decay is required",
                stacklevel=2)
            out.append((param, grad))
            continue
        helper = LayerHelper("regularization", main_program=main_program)
        decay = regularizer.append_regularization_op(param, grad, helper)
        new_grad = helper.create_tmp_variable(grad.dtype)
        helper.append_op("elementwise_add", {"X": grad, "Y": decay},
                         {"Out": new_grad})
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
