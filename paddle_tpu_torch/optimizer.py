"""Optimizers: build backward and update ops into the program.

The JAX package's static-graph optimizers: the ``Optimizer`` base (the
learning-rate var, accumulators, ``backward`` / ``apply_gradients`` /
``apply_optimize`` / ``minimize`` with the JAX package's signatures),
SGD, Momentum, LarsMomentum, Adagrad, DecayedAdagrad, Adam, AdamW, Lamb,
Adamax, Adadelta, RMSProp, Ftrl, Dpsgd and DGCMomentum (dense momentum,
as in the JAX package), and the wrappers ExponentialMovingAverage,
ModelAverage and LookaheadOptimizer. ``apply_gradients`` runs the
regularizer first (the parameter's own before the optimizer's), then
the process-wide gradient clip (``clip.set_gradient_clip``), then the
update ops; a ``ParamAttr(learning_rate=...)`` reads a ``scale`` of the
LR var. The programs they build are the JAX package's to the byte.

Not ported yet: the eager (dygraph) path, with the TypeError the JAX
package raises for a dygraph ``LearningRateDecay`` passed to a static
optimizer (both come with the dygraph slice).
RecomputeOptimizer rewrites the forward into recompute segments at its
checkpoints before the backward (parallel/recompute.py);
PipelineOptimizer records its cut points and forwards ``minimize``, the
whole of its JAX behaviour. GradientMergeOptimizer accumulates k steps' gradients and applies the
inner optimizer inside a ``conditional_block``.
"""
from __future__ import annotations

from typing import Dict

import torch

from .backward import append_backward
from .clip import get_gradient_clip
from .core.scope import global_scope
from .framework import (Variable, default_main_program,
                        default_startup_program, unique_name)
from .layers.tensor import create_global_var

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "Adagrad", "AdagradOptimizer",
    "DecayedAdagrad", "DecayedAdagradOptimizer", "Adam", "AdamOptimizer",
    "AdamW", "AdamWOptimizer", "Adamax", "AdamaxOptimizer", "Adadelta",
    "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer", "Ftrl",
    "FtrlOptimizer", "Lamb", "LambOptimizer", "Dpsgd", "DpsgdOptimizer",
    "DGCMomentum", "DGCMomentumOptimizer", "ExponentialMovingAverage",
    "ModelAverage", "LookaheadOptimizer", "GradientMergeOptimizer",
    "RecomputeOptimizer", "PipelineOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var = None
        self.type = getattr(self, "type", "sgd")

    # -- learning rate ---------------------------------------------------
    def _create_lr_var(self):
        from .dygraph.learning_rate_scheduler import LearningRateDecay
        if isinstance(self._learning_rate, LearningRateDecay):
            raise TypeError(
                "dygraph LearningRateDecay objects only work inside "
                "dygraph.guard(); static-graph programs use "
                "layers.learning_rate_scheduler.* (exponential_decay, "
                "piecewise_decay, ...)")
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
        elif self._lr_var is None:
            self._lr_var = create_global_var(
                [1], float(self._learning_rate), "float32", persistable=True,
                name=unique_name.generate("learning_rate"))
        return self._lr_var

    @property
    def learning_rate_var(self):
        return self._create_lr_var()

    def current_step_lr(self):
        return self._create_lr_var()

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
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """The regularizer's ops (the parameter's own, else the
        optimizer's), then the gradient clip's, then the update ops."""
        block = default_main_program().current_block()
        out = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            if reg is not None:
                g = reg.append_regularization_op(p, g)
            out.append((p, g))
        params_grads = out
        clip = get_gradient_clip()
        if clip is not None:
            params_grads = clip.apply(params_grads)
        self._create_lr_var()
        self._create_accumulators(block, [p for p, _ in params_grads])
        opt_ops = []
        for p, g in params_grads:
            opt_ops.append(self._append_optimize_op(block, (p, g)))
        self._finish_update(block, params_grads)
        return opt_ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from . import dygraph
        if dygraph.enabled():
            return self._minimize_dygraph(parameter_list, no_grad_set)
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    # -- eager (dygraph) path --------------------------------------------
    def _minimize_dygraph(self, parameter_list, no_grad_set=None):
        """One eager update after loss.backward() filled param.grad:
        parameters named in no_grad_set, untrainable ones and those
        without a gradient are skipped; the LR object steps once; then
        the regularizer, the clip and the update rule, in float32, each
        result copied into the parameter in its own dtype. Returns ([],
        [(param, clipped gradient)])."""
        if parameter_list is None:
            raise ValueError(
                "minimize in dygraph mode needs parameter_list "
                "(e.g. model.parameters())")
        skip = {getattr(v, "name", v) for v in (no_grad_set or ())}
        lr = self._dygraph_step_lr()
        state = self.__dict__.setdefault("_dy_state", {})
        with torch.no_grad():
            pgs = []
            for p in parameter_list:
                if not getattr(p, "trainable", True) or p.grad is None \
                        or p.name in skip:
                    continue
                w = p.value.float()
                g = p.grad.float()
                if self.regularization is not None:
                    g = g + self._eager_regularization(w)
                pgs.append((p, w, g))
            pgs = self._eager_clip(pgs)
            for p, w, g in pgs:
                new = self._dygraph_update(w, g, lr,
                                           state.setdefault(p.name, {}))
                p.value.copy_(new)
        return [], [(p, g) for p, _, g in pgs]

    def _eager_regularization(self, w):
        from .regularizer import L1DecayRegularizer, L2DecayRegularizer
        reg = self.regularization
        if isinstance(reg, L2DecayRegularizer):
            return reg.coeff * w
        if isinstance(reg, L1DecayRegularizer):
            return reg.coeff * torch.sign(w)
        raise NotImplementedError(
            f"dygraph regularization for {type(reg).__name__}")

    def _eager_clip(self, pgs):
        from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                           GradientClipByValue)
        clip = get_gradient_clip()
        if clip is None or not pgs:
            return pgs
        if isinstance(clip, GradientClipByValue):
            lo = clip.min if clip.min is not None else -clip.max
            return [(p, w, torch.clamp(g, lo, clip.max)) for p, w, g in pgs]
        if isinstance(clip, GradientClipByNorm):
            out = []
            for p, w, g in pgs:
                n = torch.linalg.vector_norm(g).double()
                s = clip.clip_norm / torch.clamp_min(n, clip.clip_norm)
                out.append((p, w, g * s.to(g.dtype)))
            return out
        if isinstance(clip, GradientClipByGlobalNorm):
            sq = torch.stack([torch.sum(g * g).double() for _, _, g in pgs])
            gn = torch.sqrt(torch.sum(sq))
            s = clip.clip_norm / torch.clamp_min(gn, clip.clip_norm)
            return [(p, w, g * s.to(g.dtype)) for p, w, g in pgs]
        raise NotImplementedError(
            f"dygraph gradient clip for {type(clip).__name__}")

    def _dygraph_step_lr(self) -> float:
        from .dygraph.learning_rate_scheduler import LearningRateDecay
        if isinstance(self._learning_rate, LearningRateDecay):
            return self._learning_rate.step()
        return float(self._learning_rate)

    def _dygraph_update(self, w, g, lr, state):
        raise NotImplementedError(
            f"{type(self).__name__} has no eager (dygraph) update rule; "
            f"train it through the static-graph path or use "
            f"SGD/Momentum/Adagrad/Adam/AdamW in dygraph mode")


def _lr_input(self, param):
    """The learning-rate var an update op reads for `param`: a `scale`
    of the optimizer's by ParamAttr(learning_rate=...) where that is not
    1."""
    lr = self._lr_var
    scale = 1.0
    if getattr(param, "optimize_attr", None):
        scale = param.optimize_attr.get("learning_rate", 1.0)
    if scale != 1.0:
        from .layers.nn import scale as scale_layer
        return scale_layer(lr, scale=scale)
    return lr


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _dygraph_update(self, w, g, lr, state):
        return w - lr * g

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

    def _dygraph_update(self, w, g, lr, state):
        v = state.get("velocity")
        v = g if v is None else self._momentum * v + g
        state["velocity"] = v
        if self._use_nesterov:
            return w - lr * (g + self._momentum * v)
        return w - lr * v

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


class LarsMomentumOptimizer(MomentumOptimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, momentum, **kw)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _dygraph_update(self, w, g, lr, state):
        # LARS: a layer-wise local rate from the float32 norms, taken in
        # float64 as the JAX package's Python floats take it
        wn = torch.linalg.vector_norm(w).double()
        gn = torch.linalg.vector_norm(g).double()
        wd = self._lars_weight_decay
        local_lr = torch.where(
            wn > 0, lr * self._lars_coeff * wn /
            torch.clamp_min(gn + wd * wn, 1e-12), torch.full_like(wn, lr))
        v = state.get("velocity")
        step = local_lr.to(g.dtype) * (g + wd * w)
        v = step if v is None else self._momentum * v + step
        state["velocity"] = v
        return w - v

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Velocity": [v.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [v.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._init_acc)

    def _dygraph_update(self, w, g, lr, state):
        acc = state.get("moment")
        acc = (torch.full_like(g, self._init_acc) if acc is None else acc) \
            + g * g
        state["moment"] = acc
        return w - lr * g / (torch.sqrt(acc) + self._epsilon)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment": [m.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon}, infer_shape=False)


class DecayedAdagradOptimizer(AdagradOptimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, epsilon=epsilon, **kw)
        self._decay = decay

    def _dygraph_update(self, w, g, lr, state):
        acc = state.get("moment")
        acc = torch.zeros_like(g) if acc is None else acc
        acc = self._decay * acc + (1 - self._decay) * g * g
        state["moment"] = acc
        return w - lr * g / (torch.sqrt(acc) + self._epsilon)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment": [m.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class _AdamBase(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                  shape=[1])

    def _dygraph_adam_step(self, w, g, lr, state):
        """Adam's bias-corrected step direction; the moments and the
        step count live in `state` (m1, m2, t)."""
        t = state.get("t", 0) + 1
        m1 = state.get("m1")
        m2 = state.get("m2")
        m1 = (1 - self._beta1) * g if m1 is None else \
            self._beta1 * m1 + (1 - self._beta1) * g
        m2 = (1 - self._beta2) * g * g if m2 is None else \
            self._beta2 * m2 + (1 - self._beta2) * g * g
        state.update(m1=m1, m2=m2, t=t)
        mh = m1 / (1 - self._beta1 ** t)
        vh = m2 / (1 - self._beta2 ** t)
        return mh / (torch.sqrt(vh) + self._epsilon)

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

    def _append_adam_op(self, block, op_type, pg, **attrs):
        ins, outs = self._adam_io(*pg)
        return block.append_op(
            op_type, inputs=ins, outputs=outs,
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, **attrs}, infer_shape=False)


class AdamOptimizer(_AdamBase):
    type = "adam"

    def _dygraph_update(self, w, g, lr, state):
        return w - lr * self._dygraph_adam_step(w, g, lr, state)

    def _append_optimize_op(self, block, pg):
        return self._append_adam_op(block, "adam", pg)


class AdamWOptimizer(_AdamBase):
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _dygraph_update(self, w, g, lr, state):
        # decoupled weight decay: applied to the parameter
        return w - lr * (self._dygraph_adam_step(w, g, lr, state)
                         + self._coeff * w)

    def _append_optimize_op(self, block, pg):
        return self._append_adam_op(block, "adamw", pg,
                                    coeff=self._coeff)


class LambOptimizer(_AdamBase):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, pg):
        return self._append_adam_op(block, "lamb", pg,
                                    weight_decay=self._weight_decay)


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow", p)
        op = block.append_op(
            "adamax",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment": [m.name], "InfNorm": [inf.name],
                    "Beta1Pow": [b1p.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)
        # beta1_pow is updated outside the op, by a scale op
        block.append_op("scale", inputs={"X": [b1p.name]},
                        outputs={"Out": [b1p.name]},
                        attrs={"scale": self._beta1}, infer_shape=False)
        return op


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sg = self._get_accumulator("avg_squared_grad", p)
        su = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "AvgSquaredGrad": [sg.name],
                    "AvgSquaredUpdate": [su.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [sg.name],
                     "AvgSquaredUpdateOut": [su.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)
            if self._centered:
                self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ms = self._get_accumulator("mean_square", p)
        mom = self._get_accumulator("momentum", p)
        ins = {"Param": [p.name], "Grad": [g.name],
               "MeanSquare": [ms.name], "Moment": [mom.name],
               "LearningRate": [_lr_input(self, p).name]}
        outs = {"ParamOut": [p.name], "MeanSquareOut": [ms.name],
                "MomentOut": [mom.name]}
        if self._centered:
            mg = self._get_accumulator("mean_grad", p)
            ins["MeanGrad"] = [mg.name]
            outs["MeanGradOut"] = [mg.name]
        return block.append_op(
            "rmsprop", inputs=ins, outputs=outs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power}, infer_shape=False)


class DpsgdOptimizer(Optimizer):
    type = "dpsgd"

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "dpsgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [_lr_input(self, p).name]},
            outputs={"ParamOut": [p.name]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma}, infer_shape=False)


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression's API over dense momentum, as in the JAX
    package: no top-k sparsification (the ramp-up and sparsity arguments
    are taken and not read)."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0,
                 **kw):
        kw.pop("rampup_step", None)
        kw.pop("sparsity", None)
        super().__init__(learning_rate, momentum, **kw)


def _restore(backups):
    scope = global_scope()
    for pname, val in backups.items():
        scope.set(pname, val)
    backups.clear()


class ExponentialMovingAverage:
    """EMA of the trainable parameters: shadow vars (starting at 0)
    updated in the step program by `update()`; apply() / restore() swap
    them in for evaluation."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadows = {}
        self._backups = {}

    def update(self):
        block = default_main_program().current_block()
        params = [p for p in block.program.all_parameters() if p.trainable]
        for p in params:
            shadow = create_global_var(
                list(p.shape), 0.0, p.dtype, persistable=True,
                name=unique_name.generate(f"{p.name}_ema"))
            self._shadows[p.name] = shadow
            # shadow = decay * shadow + (1 - decay) * param, as graph ops
            block.append_op(
                "scale", inputs={"X": [shadow.name]},
                outputs={"Out": [shadow.name]},
                attrs={"scale": self._decay}, infer_shape=False)
            tmp = block.create_var(
                name=unique_name.generate("ema_tmp"), shape=p.shape,
                dtype=p.dtype)
            block.append_op(
                "scale", inputs={"X": [p.name]},
                outputs={"Out": [tmp.name]},
                attrs={"scale": 1.0 - self._decay}, infer_shape=False)
            block.append_op(
                "elementwise_add", inputs={"X": [shadow.name],
                                           "Y": [tmp.name]},
                outputs={"Out": [shadow.name]}, infer_shape=False)

    def apply(self, executor, need_restore=True):
        # a copy: the optimizers update parameters in place, and that must
        # not reach the shadow
        scope = global_scope()
        for pname, shadow in self._shadows.items():
            self._backups[pname] = scope.get(pname)
            scope.set(pname, scope.get(shadow.name).clone())

    def restore(self, executor):
        _restore(self._backups)


class ModelAverage(Optimizer):
    """Running average of the trainable parameters: a sum and a count a
    parameter, added to in the step program by `attach()`; apply() /
    restore() swap the averages in for evaluation."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(0.0, **kw)
        self._sums = {}
        self._backups = {}

    def _attach(self, block, params):
        for p in params:
            if p.name in self._sums:
                continue
            s = create_global_var(
                list(p.shape), 0.0, p.dtype, persistable=True,
                name=unique_name.generate(f"{p.name}_avg_sum"))
            n = create_global_var(
                [1], 0.0, "float32", persistable=True,
                name=unique_name.generate(f"{p.name}_avg_n"))
            self._sums[p.name] = (s, n)
            block.append_op("elementwise_add",
                            inputs={"X": [s.name], "Y": [p.name]},
                            outputs={"Out": [s.name]}, infer_shape=False)
            block.append_op("increment", inputs={"X": [n.name]},
                            outputs={"Out": [n.name]},
                            attrs={"step": 1.0}, infer_shape=False)

    def attach(self, program=None):
        prog = program or default_main_program()
        block = prog.current_block()
        self._attach(block, [p for p in prog.all_parameters()
                             if p.trainable])

    def apply(self, executor, need_restore=True):
        scope = global_scope()
        for pname, (s, n) in self._sums.items():
            self._backups[pname] = scope.get(pname)
            cnt = float(scope.get(n.name).reshape(-1)[0])
            if cnt > 0:
                scope.set(pname, scope.get(s.name) / cnt)

    def restore(self, executor):
        _restore(self._backups)


class LookaheadOptimizer:
    """k-step lookahead around an inner optimizer: every k steps the slow
    weights move alpha of the way to the fast ones and the fast weights
    reset to the slow ones. Branch-free, as in the JAX package: sync_mask
    = 1 - sign(step / k - floor(step / k)) gates both updates in the one
    step program. The slow weights start as copies of the parameters
    (an assign in the startup program)."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not (0.0 <= alpha <= 1.0 and k >= 1):
            raise ValueError(f"Lookahead needs 0 <= alpha <= 1 and k >= 1, "
                             f"not alpha={alpha}, k={k}")
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from .layers.learning_rate_scheduler import \
            autoincreased_step_counter
        from .layers.nn import sign
        from .layers.tensor import cast
        opt_ops, params_grads = self.inner.minimize(loss, startup_program)
        block = default_main_program().current_block()
        step = autoincreased_step_counter(counter_name="@LOOKAHEAD_STEP@")
        fstep = cast(step, "float32")
        # frac = step/k - floor(step/k); sync_mask = 1 - sign(frac)
        inv_k = fstep * (1.0 / self.k)
        floor_v = block.create_var(name=unique_name.generate("la_floor"),
                                   shape=(1,), dtype="float32")
        block.append_op("floor", inputs={"X": [inv_k.name]},
                        outputs={"Out": [floor_v.name]}, infer_shape=False)
        frac = inv_k - block.var(floor_v.name)
        mask = sign(frac) * -1.0 + 1.0  # [1]: 1.0 at sync steps, else 0.0
        sp = (startup_program or default_startup_program()).global_block()
        for p, _ in params_grads:
            slow = create_global_var(
                list(p.shape), 0.0, p.dtype, persistable=True,
                name=unique_name.generate(f"{p.name}_slow"))
            sp.append_op("assign", inputs={"X": [p.name]},
                         outputs={"Out": [slow.name]}, infer_shape=False)
            # slow += mask * alpha * (fast - slow)
            tmp = block.create_var(name=unique_name.generate("la_tmp"),
                                   shape=p.shape, dtype=p.dtype)
            block.append_op("elementwise_sub",
                            inputs={"X": [p.name], "Y": [slow.name]},
                            outputs={"Out": [tmp.name]}, infer_shape=False)
            block.append_op("scale", inputs={"X": [tmp.name]},
                            outputs={"Out": [tmp.name]},
                            attrs={"scale": self.alpha}, infer_shape=False)
            block.append_op("elementwise_mul",
                            inputs={"X": [tmp.name], "Y": [mask.name]},
                            outputs={"Out": [tmp.name]},
                            attrs={"axis": 0}, infer_shape=False)
            block.append_op("elementwise_add",
                            inputs={"X": [slow.name], "Y": [tmp.name]},
                            outputs={"Out": [slow.name]}, infer_shape=False)
            # fast += mask * (slow - fast)
            diff = block.create_var(name=unique_name.generate("la_diff"),
                                    shape=p.shape, dtype=p.dtype)
            block.append_op("elementwise_sub",
                            inputs={"X": [slow.name], "Y": [p.name]},
                            outputs={"Out": [diff.name]}, infer_shape=False)
            block.append_op("elementwise_mul",
                            inputs={"X": [diff.name], "Y": [mask.name]},
                            outputs={"Out": [diff.name]},
                            attrs={"axis": 0}, infer_shape=False)
            block.append_op("elementwise_add",
                            inputs={"X": [p.name], "Y": [diff.name]},
                            outputs={"Out": [p.name]}, infer_shape=False)
        return opt_ops, params_grads


class RecomputeOptimizer:
    """Activation recomputation wrapper (reference optimizer.py:3313):
    minimize() first rewrites the forward into `recompute_segment`
    sub-blocks at the marked checkpoints (parallel/recompute.py); each
    segment runs under torch.utils.checkpoint, so its grad op computes
    it again and its inner activations are not kept."""

    def __init__(self, optimizer):
        self.inner = optimizer
        self._checkpoints = []

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, **kw):
        return self.inner.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self.inner.apply_gradients(params_grads)

    def load(self, state):
        raise NotImplementedError(
            "load() is unsupported (matches reference RecomputeOptimizer)")

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if self._checkpoints:
            from .parallel.recompute import rewrite_program_for_recompute
            rewrite_program_for_recompute(
                loss.block.program, self._checkpoints, keep_names=[loss])
        return self.inner.minimize(loss, startup_program, parameter_list,
                                   no_grad_set)


class PipelineOptimizer:
    """Pipeline-parallel sectioning (reference optimizer.py:3020): records
    the cut points and forwards minimize, as the JAX package does (its
    GPipe schedule is a function API beside the Program path:
    parallel/pipeline.py)."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0):
        self.inner = optimizer
        self.cut_list = cut_list or []

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self.inner.minimize(loss, startup_program, parameter_list,
                                   no_grad_set)


class GradientMergeOptimizer:
    """Gradient accumulation over k steps: every step adds each gradient
    to a persistable buffer (``acc += grad``); every k-th step the inner
    optimizer's update, on the buffer (divided by k with `avg`), and the
    buffers' reset run inside one conditional_block on
    ``every_n_steps(k)``. The block is skipped on the other steps, so the
    parameters and the optimizer's state are not touched there (the
    updates write in place only when the block runs): the k steps give
    the inner optimizer's step on a k-times larger batch."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self.inner.backward(loss, startup_program, parameter_list,
                                   no_grad_set, callbacks)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import nn as nn_layers
        from .layers.control_flow import _CondBlockGuard
        from .layers.learning_rate_scheduler import every_n_steps

        params_grads = self.inner.backward(
            loss, startup_program, parameter_list, no_grad_set)
        if self.k_steps <= 1:
            return self.inner.apply_gradients(params_grads), params_grads

        block = default_main_program().current_block()
        cond = every_n_steps(
            self.k_steps,
            counter_name=unique_name.generate("@GRADIENT_MERGE_STEP@"))
        merged = []
        for p, g in params_grads:
            acc = create_global_var(
                list(p.shape), 0.0, p.dtype, persistable=True,
                name=unique_name.generate(f"{p.name}_gradient_merge"))
            block.append_op(  # acc += grad
                "elementwise_add", inputs={"X": [acc.name], "Y": [g.name]},
                outputs={"Out": [acc.name]}, attrs={"axis": -1},
                infer_shape=False)
            merged.append((p, acc))

        with _CondBlockGuard(cond):
            applied = []
            for p, acc in merged:
                eff = nn_layers.scale(acc, scale=1.0 / self.k_steps) \
                    if self.avg else acc
                applied.append((p, eff))
            opt_ops = self.inner.apply_gradients(applied)
            sub = default_main_program().current_block()
            for _, acc in merged:
                sub.append_op(  # reset the buffer after the update
                    "scale", inputs={"X": [acc.name]},
                    outputs={"Out": [acc.name]},
                    attrs={"scale": 0.0, "bias": 0.0}, infer_shape=False)
        return opt_ops, params_grads


# the fluid short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
Dpsgd = DpsgdOptimizer
DGCMomentum = DGCMomentumOptimizer
