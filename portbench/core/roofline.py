"""The yardstick of the kernels' roofline shares: the card's peaks and
the bytes each hand kernel's work needs, from the cell's shapes alone.

A kernel's least time is the bytes its inputs and outputs need, each
read or written once, at the card's memory bandwidth (every kernel here
is bound by bytes: its operations take a small fraction of that time at
the float32 peak). The counts name the work, not one implementation, so
that a later kernel that does the same work is held to the same bound
(the arithmetic of the port's ``chip_smoke.py`` ``bound`` and
``ops/tridiag.py`` ``values_moved``).
"""

from __future__ import annotations

import math
from typing import Sequence

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# fields of the cell grid each kernel's step work reads and writes once
FIELDS = {
    # K2: u (3), the 3 face velocities, T, p read; rhs_u (3), T_adv written
    "K2": 8 + 4,
    # K1: rhs_u (3), rhs_T, T0 read; u* (3), T, 3 faces, rhs_phi written
    "K1": 5 + 8,
    # K5: u* (3), 3 faces, phi, p read; u (3), 3 faces, p written
    "K5": 8 + 7,
}


def field_bytes(kernel: str, shape: Sequence[int], itemsize: int) -> int:
    """Bytes one launch of K1, K2 or K5 needs on a grid of ``shape``."""
    return FIELDS[kernel] * math.prod(shape) * itemsize


def tridiag_bytes(shape: Sequence[int], components: int,
                  itemsize: int) -> int:
    """Bytes one radial tridiagonal solve of the annulus's direct
    Helmholtz step needs for ``components`` fields: per phi mode column
    (real and imaginary parts, n_phi // 2 + 1 modes each) and radial row
    the right-hand side and the mode's diagonal read and the solution
    written, and the two off-diagonals once per radial row."""
    nr, nphi = shape
    columns = components * 2 * (nphi // 2 + 1)
    return (3 * nr * columns + 2 * nr) * itemsize


def least_seconds(n_bytes: float) -> float:
    return n_bytes / PEAK_BYTES_PER_S
