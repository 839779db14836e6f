"""Pointwise physics closures of the shell (numpy, host): the radial
gravity of the reference (core_model_data.tpp:97-106). Counterpart of
the JAX package's ``physics/closures.py``; the Coriolis term lives in
``ops/vector.py`` as there."""

from __future__ import annotations

import numpy as np


def radial_gravity_scalar(r: np.ndarray, gravity_constant: float
                          ) -> np.ndarray:
    """Signed radial gravity (component along +e_r): -g for r > 1 and
    -g sqrt(r) for r <= 1."""
    g0 = gravity_constant
    return np.where(r > 1.0, -g0, -g0 * np.sqrt(r))
