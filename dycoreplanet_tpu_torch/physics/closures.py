"""Pointwise physics closures (numpy, host): the gravity of the cuboid
(-g e_z) and of the shell (radial; reference:
core_model_data.tpp:86-106). Counterpart of the JAX package's
``physics/closures.py``; the Coriolis term lives in ``ops/vector.py`` as
there."""

from __future__ import annotations

import numpy as np


def vertical_gravity_vector(p: np.ndarray, gravity_constant: float
                            ) -> np.ndarray:
    """-g e_z of the cuboid (reference: core_model_data.tpp:86-95).
    ``p``: (..., dim) points; e_z is the last coordinate."""
    g = np.zeros_like(np.asarray(p, np.float64))
    g[..., -1] = -gravity_constant
    return g


def gravity_vector(p: np.ndarray, gravity_constant: float) -> np.ndarray:
    """The shell's radial gravity (reference: core_model_data.tpp:97-106):
    -g p / r for r > 1 and -g p / sqrt(r) for r <= 1. ``p``: (..., dim)
    nondimensional points."""
    p = np.asarray(p, np.float64)
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    safe_r = np.where(r > 0, r, 1.0)
    scale = np.where(r > 1.0, 1.0 / safe_r, 1.0 / np.sqrt(safe_r))
    return -gravity_constant * p * scale


def radial_gravity_scalar(r: np.ndarray, gravity_constant: float
                          ) -> np.ndarray:
    """Signed radial gravity (component along +e_r): -g for r > 1 and
    -g sqrt(r) for r <= 1."""
    g0 = gravity_constant
    return np.where(r > 1.0, -g0, -g0 * np.sqrt(r))
