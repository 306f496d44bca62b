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
``ModelAverage`` appends its ``average_accumulates`` ops to the training
program and builds its apply / restore programs as the reference does.
ZeRO-style moment sharding (``shard_moments_over``) is not ported and
raises.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import (Block, Parameter, Program, Variable,
                        default_main_program, default_startup_program)
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
    """Polyak parameter averaging over a trailing window — the port of
    the reference's ModelAverage (paddle/parameter/AverageOptimizer.h:23,
    used by the NMT/SRL recipes via v2 ``settings(... average_window)``;
    doc/design/parameter_average.md).

    Build it AFTER the real optimizer's ``minimize``, inside the same
    program/startup guards::

        optimizer.Momentum(...).minimize(cost)
        model_avg = optimizer.ModelAverage(average_window_rate=0.15,
                                           min_average_window=100,
                                           max_average_window=10000)
        ...train (the accumulation runs inside the training step)...
        with model_avg.apply(exe):      # params <- windowed average
            infer / save                 # (backed up first)
        # params restored on exit; model_avg.restore(exe) for manual use

    Per parameter it keeps three fp32 sums (partial window / precision
    flush / last full window) and three counters, maintained by one
    ``average_accumulates`` op appended to the training program, which
    runs inside the captured training step like any optimizer
    accumulator.

    ``apply`` and ``restore`` run programs of their own in the global
    scope, as the reference's do (``fluid.scope_guard`` puts the
    training scope there): they replace the parameters' tensors in it,
    and the training step's next replay copies the new values into the
    buffers its graph holds (``Executor``: a var the scope replaced is
    copied in)."""

    def __init__(self, average_window_rate: float = 0.15,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000,
                 main_program: Optional[Program] = None,
                 startup_program: Optional[Program] = None, **kw):
        super().__init__(0.0, **kw)
        self._avg_rate = float(average_window_rate)
        self._min_win = int(min_average_window)
        self._max_win = int(max_average_window)
        program = main_program or default_main_program()
        startup = startup_program or default_startup_program()
        self.helper = LayerHelper("model_average", main_program=program,
                                  startup_program=startup)
        block = program.global_block()
        self._params = [v for v in block.vars.values()
                        if isinstance(v, Parameter) and v.trainable]
        if not self._params:
            raise ValueError("ModelAverage: no trainable parameters — "
                             "build it after the layers (and minimize)")
        for p in self._params:
            self._add_accumulator("sum_1", p)
            self._add_accumulator("sum_2", p)
            self._add_accumulator("sum_3", p)
            self._add_accumulator("num_accumulates", p, shape=[1],
                                  dtype="int64")
            self._add_accumulator("old_num_accumulates", p, shape=[1],
                                  dtype="int64")
            self._add_accumulator("num_updates", p, shape=[1],
                                  dtype="int64")
            self._append_average_accumulate_op(p)
        self._apply_program = Program()
        self._restore_program = Program()
        self._build_apply_restore()

    def _append_average_accumulate_op(self, param):
        names = {n: self._get_accumulator(n, param)
                 for n in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                           "old_num_accumulates", "num_updates")}
        self.helper.append_op(
            "average_accumulates",
            {"Param": param, "InSum1": names["sum_1"],
             "InSum2": names["sum_2"], "InSum3": names["sum_3"],
             "InNumAccumulates": names["num_accumulates"],
             "InOldNumAccumulates": names["old_num_accumulates"],
             "InNumUpdates": names["num_updates"]},
            {"OutSum1": names["sum_1"], "OutSum2": names["sum_2"],
             "OutSum3": names["sum_3"],
             "OutNumAccumulates": names["num_accumulates"],
             "OutOldNumAccumulates": names["old_num_accumulates"],
             "OutNumUpdates": names["num_updates"]},
            {"average_window": self._avg_rate,
             "min_average_window": self._min_win,
             "max_average_window": self._max_win})

    def _build_apply_restore(self):
        """Two tiny programs sharing the training scope by var NAME:
        apply backs each param up and writes the windowed average over
        it; restore copies the backup back (reference AverageOptimizer
        apply()/restore() traversal callbacks).  Before any update the
        count is 0 and the sums are all zero — then the gate min(cnt,1)
        keeps the RAW param instead of zeroing the model."""
        ab = self._apply_program.global_block()
        rb = self._restore_program.global_block()
        for p in self._params:
            accs = {n: self._get_accumulator(n, p)
                    for n in ("sum_1", "sum_2", "sum_3",
                              "num_accumulates", "old_num_accumulates")}
            backup_name = unique_name.generate(f"{p.name}_backup")
            # the backup lives in the SCOPE (created by apply's assign);
            # declared in both programs, persistable so it survives runs
            for blk, prog in ((ab, self._apply_program),
                              (rb, self._restore_program)):
                blk.create_var(name=p.name, shape=list(p.shape),
                               dtype=p.dtype, persistable=True)
                blk.create_var(name=backup_name, shape=list(p.shape),
                               dtype=p.dtype, persistable=True)
            for n, v in accs.items():
                ab.create_var(name=v.name, shape=list(v.shape),
                              dtype=v.dtype, persistable=True)
            pa, ba = ab.vars[p.name], ab.vars[backup_name]
            ab.append_op("assign", {"X": pa}, {"Out": ba}, {})
            total = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_total"),
                dtype="float32")
            ab.append_op("sum", {"X": [ab.vars[accs["sum_1"].name],
                                       ab.vars[accs["sum_2"].name],
                                       ab.vars[accs["sum_3"].name]]},
                         {"Out": total}, {})
            cnt = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_cnt"),
                dtype="int64")
            ab.append_op("sum",
                         {"X": [ab.vars[accs["num_accumulates"].name],
                                ab.vars[accs["old_num_accumulates"].name]]},
                         {"Out": cnt}, {})
            cntf = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_cntf"),
                dtype="float32")
            ab.append_op("cast", {"X": cnt}, {"Out": cntf},
                         {"in_dtype": "int64", "out_dtype": "float32"})
            one = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_one"),
                dtype="float32")
            ab.append_op("fill_constant", {}, {"Out": one},
                         {"shape": [1], "value": 1.0, "dtype": "float32"})
            denom = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_den"),
                dtype="float32")
            ab.append_op("elementwise_max", {"X": cntf, "Y": one},
                         {"Out": denom}, {})
            avg = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_val"),
                dtype="float32")
            ab.append_op("elementwise_div", {"X": total, "Y": denom},
                         {"Out": avg}, {})
            # gate = min(cnt, 1): 0 before any update, 1 after —
            # param <- gate*avg + (1-gate)*param
            gate = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_gate"),
                dtype="float32")
            ab.append_op("elementwise_min", {"X": cntf, "Y": one},
                         {"Out": gate}, {})
            gated = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_gated"),
                dtype="float32")
            ab.append_op("elementwise_mul", {"X": avg, "Y": gate},
                         {"Out": gated}, {})
            inv = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_inv"),
                dtype="float32")
            ab.append_op("scale", {"X": gate}, {"Out": inv},
                         {"scale": -1.0, "bias": 1.0,
                          "bias_after_scale": True})
            keep = ab.create_var(
                name=unique_name.generate(f"{p.name}_avg_keep"),
                dtype="float32")
            ab.append_op("elementwise_mul", {"X": ba, "Y": inv},
                         {"Out": keep}, {})
            ab.append_op("elementwise_add", {"X": gated, "Y": keep},
                         {"Out": pa}, {})
            rb.append_op("assign", {"X": rb.vars[backup_name]},
                         {"Out": rb.vars[p.name]}, {})

    def apply(self, executor, need_restore: bool = True):
        """Context manager: swap params to their windowed averages in the
        current scope; restore originals on exit (unless need_restore
        is False — then call restore() manually)."""
        import contextlib

        outer = self

        @contextlib.contextmanager
        def ctx():
            executor.run(outer._apply_program, fetch_list=[])
            try:
                yield
            finally:
                if need_restore:
                    outer.restore(executor)

        return ctx()

    def restore(self, executor):
        executor.run(self._restore_program, fetch_list=[])


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
