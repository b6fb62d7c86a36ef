"""fluid.average — WeightedAverage: a host-side running weighted mean
over fetched numpy values (epoch-level loss and accuracy reports)."""
from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        # elementwise: an ndarray value accumulates per element
        # (epoch-averaging a fetched per-sample vector)
        arr = np.asarray(value, dtype=np.float64)
        self.numerator = self.numerator + arr * weight
        self.denominator += weight

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        out = self.numerator / self.denominator
        return float(out) if np.ndim(out) == 0 else out
