"""Weighted averaging across fetched batch values
(python/paddle/fluid/average.py parity).

Counterpart of ``paddle_tpu/average.py`` (numpy only, a copy)."""

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage(object):
    """Accumulate (value, weight) pairs; eval() = weighted mean. The
    typical use is averaging per-batch losses weighted by batch size."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        """Accumulate a scalar or array value (upstream accepts matrices
        and averages element-wise)."""
        value = np.asarray(value, dtype=np.float64)
        w = float(weight)
        self.numerator = self.numerator + value * w
        self.denominator += w

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "WeightedAverage.eval() before any add() (zero weight)")
        out = self.numerator / self.denominator
        return float(out) if np.ndim(out) == 0 else out
