"""Dygraph learning-rate decay objects (reference:
python/paddle/fluid/dygraph/learning_rate_scheduler.py — LearningRateDecay
base + PiecewiseDecay/NaturalExpDecay/ExponentialDecay/InverseTimeDecay/
PolynomialDecay/CosineDecay/NoamDecay).

Pass an instance as `learning_rate=` to any optimizer; each
optimizer.minimize() in dygraph mode advances the schedule one step and
uses the returned float. Pure host math — the eager update consumes a
scalar, no LR var lives in a Program."""
from __future__ import annotations

import math

__all__ = ["LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineDecay", "NoamDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = begin
        self.step_size = step

    def step(self) -> float:
        """Return the current LR, then advance one schedule step."""
        lr = self()
        self.step_num += self.step_size
        return lr

    def __call__(self) -> float:
        raise NotImplementedError


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def __call__(self):
        for b, v in zip(self.boundaries, self.values):
            if self.step_num < b:
                return float(v)
        return float(self.values[len(self.boundaries)])


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0, self.ds, self.dr = learning_rate, decay_steps, decay_rate
        self.staircase = staircase

    def __call__(self):
        t = self.step_num / self.ds
        if self.staircase:
            t = math.floor(t)
        return float(self.lr0 * math.exp(-self.dr * t))


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0, self.ds, self.dr = learning_rate, decay_steps, decay_rate
        self.staircase = staircase

    def __call__(self):
        t = self.step_num / self.ds
        if self.staircase:
            t = math.floor(t)
        return float(self.lr0 * self.dr ** t)


class InverseTimeDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0, self.ds, self.dr = learning_rate, decay_steps, decay_rate
        self.staircase = staircase

    def __call__(self):
        t = self.step_num / self.ds
        if self.staircase:
            t = math.floor(t)
        return float(self.lr0 / (1.0 + self.dr * t))


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0 = learning_rate
        self.ds = decay_steps
        self.end_lr = end_learning_rate
        self.power = power
        self.cycle = cycle

    def __call__(self):
        step = self.step_num
        ds = self.ds
        if self.cycle:
            mult = max(1.0, math.ceil(step / ds) or 1.0)
            ds = ds * mult
        else:
            step = min(step, ds)
        frac = (1.0 - step / ds) ** self.power
        return float((self.lr0 - self.end_lr) * frac + self.end_lr)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1):
        super().__init__(begin, step)
        self.lr0 = learning_rate
        self.spe = step_each_epoch
        self.epochs = epochs

    def __call__(self):
        epoch = self.step_num // self.spe
        return float(self.lr0 * 0.5 *
                     (math.cos(epoch * math.pi / self.epochs) + 1.0))


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1):
        super().__init__(begin, step)
        self.d_model = d_model
        self.warmup = warmup_steps

    def __call__(self):
        n = max(self.step_num, 1)
        return float(self.d_model ** -0.5 *
                     min(n ** -0.5, n * self.warmup ** -1.5))
