"""Learning-rate decay schedules — the port of
``paddle_tpu/fluid/learning_rate_decay.py`` (analog of
python/paddle/v2/fluid/learning_rate_decay.py): each schedule is emitted
as ops reading the global step counter, so the decayed rate is computed
inside the captured step (no host round trip a step)."""

from __future__ import annotations

import math

from . import layers
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["create_global_counter", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay"]

GLOBAL_STEP_NAME = "@global_step@"


def create_global_counter(name: str = GLOBAL_STEP_NAME,
                          begin: float = 0.0) -> Variable:
    """Persistable step counter, incremented once per executor step (the
    reference's global_step / increment op pattern)."""
    helper = LayerHelper("global_counter")
    block = default_main_program().global_block()
    if name in block.vars:
        return block.vars[name]
    counter = helper.create_global_variable(shape=[1], dtype="float32",
                                            persistable=True, name=name)
    helper.set_variable_initializer(counter, ConstantInitializer(begin))
    helper.append_op("scale", {"X": counter}, {"Out": counter},
                     {"scale": 1.0, "bias": 1.0})
    return counter


def _step() -> Variable:
    return create_global_counter()


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps) — reference
    learning_rate_decay.py exponential_decay."""
    g = _step()
    div = layers.scale(g, scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    factor = layers.elementwise_pow(
        layers.fill_constant([1], "float32", decay_rate), div)
    return layers.scale(factor, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    g = _step()
    div = layers.scale(g, scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    return layers.scale(
        layers.exp(layers.scale(div, scale=-decay_rate)),
        scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    g = _step()
    div = layers.scale(g, scale=1.0 / decay_steps)
    if staircase:
        div = layers.floor(div)
    denom = layers.scale(div, scale=decay_rate, bias=1.0)
    return layers.elementwise_div(
        layers.fill_constant([1], "float32", float(learning_rate)), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    g = _step()
    if cycle:
        ratio = layers.scale(g, scale=1.0 / decay_steps)
        ceil = layers.ceil(layers.elementwise_max(
            ratio, layers.fill_constant([1], "float32", 1e-12)))
        decay_steps_var = layers.scale(ceil, scale=float(decay_steps))
        capped = g
    else:
        decay_steps_var = layers.fill_constant([1], "float32",
                                               float(decay_steps))
        capped = layers.elementwise_min(
            g, layers.fill_constant([1], "float32", float(decay_steps)))
    frac = layers.elementwise_div(capped, decay_steps_var)
    base = layers.scale(frac, scale=-1.0, bias=1.0)
    powed = layers.elementwise_pow(
        base, layers.fill_constant([1], "float32", float(power)))
    return layers.scale(powed,
                        scale=float(learning_rate) - end_learning_rate,
                        bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """Step function over global_step (reference piecewise_decay) —
    computed with masks instead of a Switch sub-block."""
    assert len(boundaries) + 1 == len(values)
    g = _step()
    lr = layers.fill_constant([1], "float32", float(values[0]))
    for b, v in zip(boundaries, values[1:]):
        past = layers.cast(
            layers.elementwise_max(
                layers.sign(layers.scale(g, bias=-float(b))),
                layers.fill_constant([1], "float32", 0.0)), "float32")
        lr = layers.elementwise_add(
            layers.elementwise_mul(
                lr, layers.scale(past, scale=-1.0, bias=1.0)),
            layers.scale(past, scale=float(v)))
    return lr
