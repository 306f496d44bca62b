"""Optimizer front end — the port of ``paddle_tpu/fluid/optimizer.py``
(analog of python/paddle/v2/fluid/optimizer.py: Optimizer base :29,
minimize :220, SGD / Momentum / Adagrad / Adam / Adamax / DecayedAdagrad
at :244-544; Adadelta / RMSProp / Ftrl exist as ops).

``minimize`` keeps the reference's contract: ``append_backward`` with the
error-clip callback for the (param, grad) pairs, then the gradient
clips, the regularizers, and one update op per parameter plus its
accumulators (persistable vars with startup-program init ops), the
optimizer's finishing ops and the global step's increment.  Names and op
order are the reference's, so the optimized program serializes alike.
ModelAverage and ZeRO-style moment sharding (``shard_moments_over``) are
not ported and raise.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import (Block, Parameter, Program, Variable,
                        default_main_program)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "Adagrad", "AdagradOptimizer", "Adam", "AdamOptimizer",
           "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer",
           "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer",
           "ModelAverage"]


class Optimizer:
    """Base optimizer (reference optimizer.py:29)."""

    def __init__(self, learning_rate, regularization=None,
                 global_step: Optional[Variable] = None,
                 shard_moments_over: Optional[str] = None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        if shard_moments_over is not None:
            raise NotImplementedError("Optimizer(shard_moments_over=...): "
                                      "meshes are not ported to "
                                      "paddle_tpu_torch")
        self._global_step = global_step
        self.regularization = regularization
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

    def _finish_update(self, block: Block):
        pass

    def _increment_global_step(self, block: Block):
        self.helper.append_op(
            "scale", {"X": self._global_step}, {"Out": self._global_step},
            {"scale": 1.0, "bias": 1.0, "bias_after_scale": True})

    # -- main entry ----------------------------------------------------------
    def create_optimization_pass(self, parameters_and_grads, loss,
                                 startup_program=None):
        """reference optimizer.py:160."""
        program = loss.block.program
        # anchor the helper on the loss's program, not the ambient default —
        # layers may have been built with an explicit main_program
        self.helper = LayerHelper(self.__class__.__name__,
                                  main_program=program,
                                  startup_program=startup_program)
        self._create_accumulators(loss.block,
                                  [p for p, g in parameters_and_grads])
        self._create_global_learning_rate(program)

        optimize_ops = []
        for pg in parameters_and_grads:
            if pg[1] is None:
                continue
            optimize_ops.append(self._append_optimize_op(loss.block, pg))
        self._finish_update(loss.block)
        if self._global_step is not None:
            self._increment_global_step(loss.block)
        return optimize_ops

    def minimize(self, loss: Variable, startup_program: Optional[Program] = None,
                 parameter_list=None, no_grad_set=None
                 ) -> Tuple[list, List[Tuple[Parameter, Variable]]]:
        """reference optimizer.py:220 — backward, then the gradient clips
        and regularizers, then the optimization pass.
        error_clip_callback rides the backward walk (reference
        optimizer.py:225 passes the same callback), so per-var
        ``error_clip`` attrs clip gradients the moment they finalize."""
        program = loss.block.program
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       callbacks=[error_clip_callback])
        params_grads = append_gradient_clip_ops(params_grads, program)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization, program)
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        m = self._get_accumulator("moment", pg[0])
        return self.helper.append_op(
            "adagrad",
            {"Param": pg[0], "Grad": pg[1], "Moment": m,
             "LearningRate": self._create_param_lr(pg)},
            {"ParamOut": pg[0], "MomentOut": m},
            {"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, pg):
        p = pg[0]
        return self.helper.append_op(
            "adamax",
            {"Param": p, "Grad": pg[1],
             "LearningRate": self._create_param_lr(pg),
             "Moment": self._get_accumulator("moment", p),
             "InfNorm": self._get_accumulator("inf_norm", p),
             "Beta1Pow": self._get_accumulator("beta1_pow_acc", p)},
            {"ParamOut": p,
             "MomentOut": self._get_accumulator("moment", p),
             "InfNormOut": self._get_accumulator("inf_norm", p)},
            {"beta1": self._beta1, "beta2": self._beta2,
             "epsilon": self._epsilon})

    def _finish_update(self, block):
        for p, acc in self._accumulators["beta1_pow_acc"].items():
            self.helper.append_op("scale", {"X": acc}, {"Out": acc},
                                  {"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        m = self._get_accumulator("moment", pg[0])
        return self.helper.append_op(
            "decayed_adagrad",
            {"Param": pg[0], "Grad": pg[1], "Moment": m,
             "LearningRate": self._create_param_lr(pg)},
            {"ParamOut": pg[0], "MomentOut": m},
            {"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p = pg[0]
        ag = self._get_accumulator("avg_squared_grad", p)
        au = self._get_accumulator("avg_squared_update", p)
        return self.helper.append_op(
            "adadelta",
            {"Param": p, "Grad": pg[1], "AvgSquaredGrad": ag,
             "AvgSquaredUpdate": au},
            {"ParamOut": p, "AvgSquaredGradOut": ag,
             "AvgSquaredUpdateOut": au},
            {"rho": self._rho, "epsilon": self._epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)

    def _append_optimize_op(self, block, pg):
        p = pg[0]
        m = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        return self.helper.append_op(
            "rmsprop",
            {"Param": p, "Grad": pg[1], "Moment": m, "MeanSquare": ms,
             "LearningRate": self._create_param_lr(pg)},
            {"ParamOut": p, "MomentOut": m, "MeanSquareOut": ms},
            {"decay": self._rho, "epsilon": self._epsilon,
             "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p = pg[0]
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return self.helper.append_op(
            "ftrl",
            {"Param": p, "Grad": pg[1], "SquaredAccumulator": sq,
             "LinearAccumulator": lin,
             "LearningRate": self._create_param_lr(pg)},
            {"ParamOut": p, "SquaredAccumOut": sq, "LinearAccumOut": lin},
            {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """Polyak parameter averaging (reference ModelAverage, its
    ``average_accumulates`` op): not ported."""

    def __init__(self, average_window_rate: float = 0.15,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000,
                 main_program: Optional[Program] = None,
                 startup_program: Optional[Program] = None, **kw):
        raise NotImplementedError("ModelAverage (and its "
                                  "average_accumulates op) is not ported "
                                  "to paddle_tpu_torch")

    def apply(self, executor, need_restore: bool = True):
        raise NotImplementedError("ModelAverage is not ported to "
                                  "paddle_tpu_torch")

    def restore(self, executor):
        raise NotImplementedError("ModelAverage is not ported to "
                                  "paddle_tpu_torch")


# short aliases (reference exposes both)
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
