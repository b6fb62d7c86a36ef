"""Optimizers: build backward and update ops into the program.

The JAX package's static-graph optimizers, as far as the training paths
need them: the ``Optimizer`` base (learning-rate var, accumulators,
``backward`` / ``apply_gradients`` / ``minimize``), SGD, Momentum, Adam
and AdamW. The
programs they build are the JAX package's to the byte. Regularization and
gradient clipping are not ported yet and raise; the eager (dygraph)
path is not ported.
"""
from __future__ import annotations

from typing import Dict

from .backward import append_backward
from .framework import Variable, default_main_program, unique_name
from .layers.tensor import create_global_var

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW",
           "AdamWOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var = None
        self.type = getattr(self, "type", "sgd")

    # -- learning rate ---------------------------------------------------
    def _create_lr_var(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
        elif self._lr_var is None:
            self._lr_var = create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name.generate("learning_rate"))
        return self._lr_var

    # -- accumulators ----------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        v = create_global_var(
            shape or list(param.shape), fill_value, dtype or param.dtype,
            persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"))
        acc[param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block, params_grads):
        pass

    # -- op emission (subclass hook) -------------------------------------
    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- public API ------------------------------------------------------
    def backward(self, loss, parameter_list=None, no_grad_set=None,
                 callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        block = default_main_program().current_block()
        for p, _ in params_grads:
            if self.regularization is not None or \
                    getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"regularization (on {p.name!r}) is not ported yet")
        self._create_lr_var()
        self._create_accumulators(block, [p for p, _ in params_grads])
        opt_ops = []
        for p, g in params_grads:
            opt_ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        return opt_ops

    def minimize(self, loss, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, parameter_list, no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


def _lr_input(self, param):
    """The learning-rate var an update op reads for `param`."""
    scale = 1.0
    if getattr(param, "optimize_attr", None):
        scale = param.optimize_attr.get("learning_rate", 1.0)
    if scale != 1.0:
        raise NotImplementedError(
            f"a per-parameter learning rate (ParamAttr.learning_rate="
            f"{scale} on {param.name!r}) needs the scale op, which is not "
            f"ported yet")
    return self._lr_var


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name]}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Velocity": [v.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov}, infer_shape=False)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None):
        super().__init__(learning_rate, regularization)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                  shape=[1])

    def _adam_io(self, p, g):
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow", p)
        b2p = self._get_accumulator("beta2_pow", p)
        ins = {"Param": [p.name], "Grad": [g.name], "Moment1": [m1.name],
               "Moment2": [m2.name], "Beta1Pow": [b1p.name],
               "Beta2Pow": [b2p.name],
               "LearningRate": [_lr_input(self, p).name]}
        outs = {"ParamOut": [p.name], "Moment1Out": [m1.name],
                "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                "Beta2PowOut": [b2p.name]}
        return ins, outs


class AdamOptimizer(_AdamBase):
    type = "adam"

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ins, outs = self._adam_io(p, g)
        return block.append_op(
            "adam", inputs=ins, outputs=outs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)


class AdamWOptimizer(_AdamBase):
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ins, outs = self._adam_io(p, g)
        return block.append_op(
            "adamw", inputs=ins, outputs=outs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "coeff": self._coeff},
            infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
