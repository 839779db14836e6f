"""Boundary conditions as ghost-cell rules: a frozen copy of the port's
ops/bc.py. On a structured grid
every constraint of the reference (no-slip / no-normal-flux velocity,
Dirichlet temperature, reference: boussinesq_model.tpp:259-387) becomes
a ghost-layer fill, after which all stencils are dense slices.

Ghost rules (one per wall end of each non-periodic axis):
  NEUMANN    ghost = interior          (zero normal gradient)
  DIRICHLET  ghost = 2*value - interior (mirror through boundary value)
  ANTISYM    ghost = -interior          (zero boundary value)
  POLE       ghost = the same latitude ring at lon + pi (even nlon)
  POLE_FLIP  like POLE but negated (u_lat and u_lon: the local basis
             flips across the pole)
The CUDA kernels apply the same rules as index arithmetic
(csrc/shell_common.cuh).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch


class BC(enum.Enum):
    PERIODIC = "periodic"
    NEUMANN = "neumann"
    DIRICHLET = "dirichlet"
    ANTISYM = "antisym"
    POLE = "pole"
    POLE_FLIP = "pole_flip"


@dataclass(frozen=True)
class BCSpec:
    """BC at the (lo, hi) ends of one axis. ``value`` arrays must be
    broadcastable to the boundary slice shape."""

    lo: BC = BC.NEUMANN
    hi: BC = BC.NEUMANN
    lo_value: Union[float, np.ndarray, torch.Tensor] = 0.0
    hi_value: Union[float, np.ndarray, torch.Tensor] = 0.0


def _take(f: torch.Tensor, d: int, idx) -> torch.Tensor:
    sl = [slice(None)] * f.ndim
    sl[d] = idx
    return f[tuple(sl)]


def _as_tensor(value, like: torch.Tensor):
    if isinstance(value, (float, int)):
        return value
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def ghost(f: torch.Tensor, d: int, end: str, rule: BC, value,
          lon_axis: int = -1, k: int = 1) -> torch.Tensor:
    """One ghost slice (thickness 1) for axis ``d`` of ``f``, at distance
    k from the wall (reflection through the wall: the mirror partner of
    ghost k is interior cell k-1)."""
    n = f.shape[d]
    interior = (_take(f, d, slice(k - 1, k)) if end == "lo"
                else _take(f, d, slice(n - k, n - k + 1)))
    if rule == BC.NEUMANN:
        return interior
    if rule == BC.DIRICHLET:
        return 2.0 * _as_tensor(value, f) - interior
    if rule == BC.ANTISYM:
        return -interior
    if rule in (BC.POLE, BC.POLE_FLIP):
        shifted = torch.roll(interior, f.shape[lon_axis] // 2, dims=lon_axis)
        return -shifted if rule == BC.POLE_FLIP else shifted
    raise ValueError(f"ghost rule {rule} not valid for a wall axis")
