"""Learning-rate schedules (copy of ``commefficient_tpu/utils/schedules.py``).

Host-side callables of a (possibly fractional) epoch count.
"""

from __future__ import annotations

import numpy as np


class PiecewiseLinear:
    """Linear interpolation through (knot, value) pairs; clamped outside."""

    def __init__(self, knots, vals):
        self.knots = np.asarray(knots, dtype=np.float64)
        self.vals = np.asarray(vals, dtype=np.float64)

    def __call__(self, t):
        return float(np.interp(t, self.knots, self.vals))


def cifar_lr_schedule(lr_scale: float, pivot_epoch: float, num_epochs: float):
    """0 -> lr_scale at pivot -> 0 at end (ref cv_train.py:393-395)."""
    return PiecewiseLinear([0, pivot_epoch, num_epochs], [0, lr_scale, 0])
