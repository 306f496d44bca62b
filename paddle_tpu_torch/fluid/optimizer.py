"""Optimizer front end — the port of ``paddle_tpu/fluid/optimizer.py``,
cut to the ``Optimizer`` base and Adam.

``minimize`` keeps the two-phase contract: ``append_backward`` for the
(param, grad) pairs, then one update op per parameter plus its
accumulators (persistable vars with startup-program init ops).  Names
and op order are the reference's, so the optimized program serializes
alike.  Gradient clipping, regularizers, ZeRO-style moment sharding and
the other optimizers (Adagrad, Adamax, ...) are not ported.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import unique_name
from .backward import append_backward
from .framework import (Block, Parameter, Program, Variable,
                        default_main_program)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "Adam", "AdamOptimizer", "SGD", "SGDOptimizer",
           "Momentum", "MomentumOptimizer", "Adagrad", "AdagradOptimizer"]


class Optimizer:
    """Base optimizer."""

    def __init__(self, learning_rate, regularization=None,
                 global_step: Optional[Variable] = None,
                 shard_moments_over: Optional[str] = None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        if regularization is not None:
            raise NotImplementedError("Optimizer(regularization=...): "
                                      "regularizers are not ported to "
                                      "paddle_tpu_torch")
        if global_step is not None:
            raise NotImplementedError("Optimizer(global_step=...) is not "
                                      "ported to paddle_tpu_torch")
        if shard_moments_over is not None:
            raise NotImplementedError("Optimizer(shard_moments_over=...): "
                                      "meshes are not ported to "
                                      "paddle_tpu_torch")
        self._learning_rate = learning_rate
        self._learning_rate_map: Dict[int, Variable] = {}
        # accumulators[name][param_name] = Variable
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)
        self.helper: Optional[LayerHelper] = None

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self, program: Program):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        if id(program) in self._learning_rate_map:
            return
        lr = self.helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            shape=[1], dtype="float32", persistable=True)
        self.helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[id(program)] = lr

    def _global_learning_rate(self, program: Optional[Program] = None):
        return self._learning_rate_map[id(program or default_main_program())]

    def _create_param_lr(self, param_and_grad) -> Variable:
        """Per-parameter learning-rate multiplier (ParamAttr
        ``learning_rate``) as a ``scale`` of the global rate."""
        param = param_and_grad[0]
        base = self._global_learning_rate()
        mult = (param.optimize_attr or {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return base
        out = self.helper.create_tmp_variable("float32")
        self.helper.append_op("scale", {"X": base}, {"Out": out},
                              {"scale": float(mult)})
        return out

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter,
                         fill_value: float = 0.0, shape=None,
                         dtype: str = "float32") -> Variable:
        if param.name in self._accumulators[name]:
            raise ValueError(f"accumulator {name} already exists for "
                             f"{param.name}")
        acc_shape = list(shape) if shape is not None else list(param.shape)
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=acc_shape, dtype=dtype, persistable=True)
        self.helper.set_variable_initializer(
            var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    # -- hooks for subclasses ------------------------------------------------
    def _create_accumulators(self, block: Block, parameters):
        pass

    def _append_optimize_op(self, block: Block, param_and_grad):
        raise NotImplementedError

    # -- main entry ----------------------------------------------------------
    def create_optimization_pass(self, parameters_and_grads, loss,
                                 startup_program=None):
        program = loss.block.program
        # anchor the helper on the loss's program, not the ambient default
        self.helper = LayerHelper(self.__class__.__name__,
                                  main_program=program,
                                  startup_program=startup_program)
        self._create_accumulators(loss.block,
                                  [p for p, g in parameters_and_grads])
        self._create_global_learning_rate(program)
        return [self._append_optimize_op(loss.block, pg)
                for pg in parameters_and_grads if pg[1] is not None]

    def minimize(self, loss: Variable, startup_program: Optional[Program] = None,
                 parameter_list=None, no_grad_set=None
                 ) -> Tuple[list, List[Tuple[Parameter, Variable]]]:
        """Backward, then the optimization pass.  A parameter with a
        gradient clip attr raises: clipping is not ported."""
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        for p, _g in params_grads:
            if getattr(p, "gradient_clip_attr", None) is not None \
                    or getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"parameter {p.name!r}: gradient clipping and "
                    f"regularizers are not ported to paddle_tpu_torch")
        optimize_ops = self.create_optimization_pass(params_grads, loss,
                                                     startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, pg):
        return self.helper.append_op(
            "sgd",
            {"Param": pg[0], "Grad": pg[1],
             "LearningRate": self._create_param_lr(pg)},
            {"ParamOut": pg[0]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        v = self._get_accumulator("velocity", pg[0])
        return self.helper.append_op(
            "momentum",
            {"Param": pg[0], "Grad": pg[1], "Velocity": v,
             "LearningRate": self._create_param_lr(pg)},
            {"ParamOut": pg[0], "VelocityOut": v},
            {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, pg):
        p = pg[0]
        return self.helper.append_op(
            "adam",
            {"Param": p, "Grad": pg[1],
             "LearningRate": self._create_param_lr(pg),
             "Moment1": self._get_accumulator("moment1", p),
             "Moment2": self._get_accumulator("moment2", p),
             "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
             "Beta2Pow": self._get_accumulator("beta2_pow_acc", p)},
            {"ParamOut": p,
             "Moment1Out": self._get_accumulator("moment1", p),
             "Moment2Out": self._get_accumulator("moment2", p),
             "Beta1PowOut": self._get_accumulator("beta1_pow_acc", p),
             "Beta2PowOut": self._get_accumulator("beta2_pow_acc", p)},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})


def _unported(name: str):
    class _Unported(Optimizer):
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(f"{name} is not ported to "
                                      f"paddle_tpu_torch (SGD, Momentum "
                                      f"and Adam are)")

    _Unported.__name__ = _Unported.__qualname__ = name
    return _Unported


AdagradOptimizer = _unported("AdagradOptimizer")

Adam = AdamOptimizer
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
