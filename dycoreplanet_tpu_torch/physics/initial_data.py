"""Initial and boundary data of the aqua-planet runs (numpy, host).

Counterpart of the JAX package's ``physics/initial_data.py``: on the
shell and the annulus the temperature IC is the sum of two Gaussian
bumps at radii R0 + 0.35 dR (x-axis) and R0 + 0.65 dR (y-axis) with
isotropic precision 20/(dR/2); the 2D centers are rotated twice by
pi/3, the 3D ones not (reference: boussinesq_model_data.tpp:15-147). On
the cuboid it is one Gaussian at the domain centre
(boussinesq_model_data.tpp:168-196). Velocity starts at rest. Evaluated
once on the host in float64 and cast by the caller.
"""

from __future__ import annotations

import math

import numpy as np


def rotation_matrix_2d(alpha: float) -> np.ndarray:
    """2D rotation (reference: boussinesq_model_data.tpp:26-32)."""
    c, s = math.cos(alpha), math.sin(alpha)
    return np.asarray([[c, -s], [s, c]])


def _gaussian(p: np.ndarray, center: np.ndarray, precision_diag: float,
              dim: int) -> np.ndarray:
    """det(C)^(1/2) exp(-1/2 (p-c)^T C (p-c)) / (2 pi)^(dim/2) with
    C = precision_diag * I (a precision matrix, as in the reference)."""
    d = p - center
    quad = precision_diag * np.sum(d * d, axis=-1)
    det_sqrt = precision_diag ** (dim / 2.0)
    return det_sqrt * np.exp(-0.5 * quad) / math.sqrt((2.0 * math.pi) ** dim)


class TemperatureInitialValues:
    """Double-Gaussian IC of the shell (3D: centers on the x/y axes,
    unrotated) and the annulus (2D: the reference's ``R * c * R^T`` on a
    vector, which deal.II evaluates as R (R c), a rotation by 2 pi/3).
    ``width_scale`` > 1 widens the bumps keeping the peak value (the
    documented `ic width scale` deviation knob, PARITY.md)."""

    def __init__(self, dim: int, R0: float, R1: float,
                 width_scale: float = 1.0):
        if dim not in (2, 3):
            raise ValueError(f"no {dim}D temperature IC")
        self.dim = dim
        dR = R1 - R0
        self.precision = 20.0 / (dR / 2.0) / float(width_scale) ** 2
        self.amp = float(width_scale) ** dim
        self.center1 = np.zeros(dim)
        self.center1[0] = R0 + dR * 0.35
        self.center2 = np.zeros(dim)
        self.center2[1] = R0 + dR * 0.65
        if dim == 2:
            R = rotation_matrix_2d(math.pi / 3.0)
            self.center1 = R @ (R @ self.center1)
            self.center2 = R @ (R @ self.center2)

    def __call__(self, p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        return self.amp * (
            _gaussian(p, self.center1, self.precision, self.dim)
            + _gaussian(p, self.center2, self.precision, self.dim))



class TemperatureInitialValuesCuboid:
    """The cuboid's single Gaussian at ``center`` (reference:
    boussinesq_model_data.tpp:168-196): precision 1/(0.1 diameter)^2,
    and the reference's divisor 2 sqrt((2 pi)^2) = 4 pi whatever the
    dimension (tpp:189-192)."""

    def __init__(self, dim: int, center, diameter: float):
        self.dim = dim
        self.center = np.asarray(center, np.float64)
        self.precision = 1.0 / (0.1 * diameter) ** 2

    def __call__(self, p: np.ndarray) -> np.ndarray:
        d = np.asarray(p, np.float64) - self.center
        quad = self.precision * np.sum(d * d, axis=-1)
        det_sqrt = self.precision ** (self.dim / 2.0)
        return det_sqrt * np.exp(-0.5 * quad) / (2.0 * (2.0 * math.pi))
