"""Gradient / error clipping — the port of ``paddle_tpu/fluid/clip.py``
(analog of python/paddle/v2/fluid/clip.py: ErrorClipByValue:40,
GradientClipByValue:101, GradientClipByNorm:122,
GradientClipByGlobalNorm).  Clip ops are appended to the program between
backward and the optimizer ops, so they run inside the same captured
step."""

from __future__ import annotations

__all__ = ["ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "append_gradient_clip_ops",
           "error_clip_callback", "set_gradient_clip"]


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Per-var ERROR clipping — reference clip.py:40.  Attached to a
    forward Variable (``var.error_clip = ErrorClipByValue(max=...)``),
    it clips that var's GRADIENT as it is produced during
    ``append_backward`` — bounding the error signal flowing upstream
    from that point, where GradientClip* only bounds what reaches the
    optimizer.  The clip op runs in the step like every other backward
    op."""

    def __init__(self, max, min=None):
        max = float(max)
        if min is None:
            min = -max
        self.max, self.min = max, float(min)
        if self.min >= self.max:
            raise ValueError(f"ErrorClipByValue: min must be < max "
                             f"(got min={self.min}, max={self.max})")

    def append_clip_op(self, block, grad_name):
        gv = block.vars[grad_name]
        block.append_op("clip", {"X": gv}, {"Out": gv},
                        {"min": self.min, "max": self.max})


def error_clip_callback(block, op):
    """append_backward callback (reference clip.py:66, wired by
    Optimizer.minimize): for each canonical ``@GRAD`` output the newly
    appended op produces, apply the FORWARD var's ``error_clip``.
    Intermediate ``@RENAME@``/``@ZERO`` contribution pieces are skipped —
    the clip lands once, on the summed gradient the rest of the
    backward pass consumes."""
    from .core.registry import GRAD_SUFFIX

    for name in op.output_names:
        if not name or not name.endswith(GRAD_SUFFIX):
            continue
        fwd_name = name[: -len(GRAD_SUFFIX)]
        try:
            fwd_var = block.var(fwd_name)
        except KeyError:
            continue
        clip = getattr(fwd_var, "error_clip", None)
        if clip is None:
            continue
        if not isinstance(clip, BaseErrorClipAttr):
            raise TypeError(
                f"Variable {fwd_name!r}.error_clip must be a "
                f"BaseErrorClipAttr, got {type(clip).__name__}")
        clip.append_clip_op(block, name)


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad, helper):
        raise NotImplementedError


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def create_operators(self, param, grad, helper):
        out = helper.create_tmp_variable(grad.dtype)
        helper.append_op("clip", {"X": grad}, {"Out": out},
                         {"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad, helper):
        out = helper.create_tmp_variable(grad.dtype)
        helper.append_op("clip_by_norm", {"X": grad}, {"Out": out},
                         {"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Two-pass: accumulate squared norms across params, then scale each grad
    by clip_norm / max(global_norm, clip_norm) (reference clip.py)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def process_context(self, context, param, grad):
        context.setdefault("sum_squares", []).append(grad)

    def create_operators(self, param, grad, helper, scale_var=None):
        out = helper.create_tmp_variable(grad.dtype)
        helper.append_op("elementwise_mul", {"X": grad, "Y": scale_var},
                         {"Out": out})
        return param, out


_default_clip = None


def set_gradient_clip(clip):
    global _default_clip
    _default_clip = clip


def append_gradient_clip_ops(param_grads, main_program=None):
    from .layer_helper import LayerHelper

    helper = LayerHelper("gradient_clip", main_program=main_program)
    context = {}
    attrs = []
    for p, g in param_grads:
        clip = getattr(p, "gradient_clip_attr", None) or _default_clip
        if clip is not None:
            from .regularizer import grad_is_selected_rows

            if grad_is_selected_rows(g):
                raise NotImplementedError(
                    f"gradient clipping on sparse-grad parameter "
                    f"{p.name!r} (embedding is_sparse=True) is not "
                    f"supported — SelectedRows grads cannot flow through "
                    f"clip ops; build the embedding with is_sparse=False")
        attrs.append(clip)
        if clip is not None:
            clip.process_context(context, p, g)

    scale_var = None
    if any(isinstance(c, GradientClipByGlobalNorm) for c in attrs):
        squares = []
        for g in context.get("sum_squares", []):
            sq = helper.create_tmp_variable(g.dtype)
            helper.append_op("squared_l2_norm", {"X": g}, {"Out": sq})
            squares.append(sq)
        total = helper.create_tmp_variable("float32")
        helper.append_op("sum", {"X": squares}, {"Out": total})
        gnorm = helper.create_tmp_variable("float32")
        helper.append_op("sqrt", {"X": total}, {"Out": gnorm})
        clip_norm = next(c.clip_norm for c in attrs
                         if isinstance(c, GradientClipByGlobalNorm))
        maxed = helper.create_tmp_variable("float32")
        helper.append_op("clip", {"X": gnorm}, {"Out": maxed},
                         {"min": clip_norm, "max": 3.4e38})
        scale_var = helper.create_tmp_variable("float32")
        helper.append_op("elementwise_div", {"X": _const(helper, clip_norm),
                                             "Y": maxed}, {"Out": scale_var})

    out = []
    for (p, g), clip in zip(param_grads, attrs):
        if g is None or clip is None:
            out.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            out.append(clip.create_operators(p, g, helper, scale_var))
        else:
            out.append(clip.create_operators(p, g, helper))
    return out


def _const(helper, value):
    v = helper.create_tmp_variable("float32")
    helper.append_op("fill_constant", {}, {"Out": v},
                     {"shape": [], "value": float(value), "dtype": "float32"})
    return v
