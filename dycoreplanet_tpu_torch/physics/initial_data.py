"""Initial and boundary data of the shell aqua-planet runs (numpy, host).

Counterpart of the JAX package's ``physics/initial_data.py`` for the 3D
shell: the temperature IC is the sum of two Gaussian bumps at radii
R0 + 0.35 dR (x-axis) and R0 + 0.65 dR (y-axis) with isotropic precision
20/(dR/2), not rotated in 3D (reference:
boussinesq_model_data.tpp:15-147). Velocity starts at rest. Evaluated
once on the host in float64 and cast by the caller.
"""

from __future__ import annotations

import math

import numpy as np


def _gaussian(p: np.ndarray, center: np.ndarray, precision_diag: float,
              dim: int) -> np.ndarray:
    """det(C)^(1/2) exp(-1/2 (p-c)^T C (p-c)) / (2 pi)^(dim/2) with
    C = precision_diag * I (a precision matrix, as in the reference)."""
    d = p - center
    quad = precision_diag * np.sum(d * d, axis=-1)
    det_sqrt = precision_diag ** (dim / 2.0)
    return det_sqrt * np.exp(-0.5 * quad) / math.sqrt((2.0 * math.pi) ** dim)


class TemperatureInitialValues:
    """Double-Gaussian shell IC (3D: centers on the x/y axes, unrotated).
    ``width_scale`` > 1 widens the bumps keeping the peak value (the
    documented `ic width scale` deviation knob, PARITY.md)."""

    def __init__(self, dim: int, R0: float, R1: float,
                 width_scale: float = 1.0):
        if dim != 3:
            raise NotImplementedError(
                "2D annulus data is not ported yet (ROADMAP.md: annulus "
                "and cuboid geometries)")
        self.dim = dim
        dR = R1 - R0
        self.precision = 20.0 / (dR / 2.0) / float(width_scale) ** 2
        self.amp = float(width_scale) ** dim
        self.center1 = np.zeros(dim)
        self.center1[0] = R0 + dR * 0.35
        self.center2 = np.zeros(dim)
        self.center2[1] = R0 + dR * 0.65

    def __call__(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        return self.amp * (
            _gaussian(p, self.center1, self.precision, self.dim)
            + _gaussian(p, self.center2, self.precision, self.dim))

