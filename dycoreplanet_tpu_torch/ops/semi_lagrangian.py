"""Semi-Lagrangian scalar transport (PyTorch).

Counterpart of the JAX package's ``ops/semi_lagrangian.py``: the
unconditionally stable transport option for the temperature, meant for
the sub-cycled temperature steps (``NSE solver interval`` > 1), where the
effective CFL is large.

Scheme: backward departure points in index space (displacement
``s_d = clip(dt * u_d / h_d, -K, K)`` cells along axis d, ``h_d`` the
cell's physical width, K = ``ghost_width``), then multilinear
interpolation of the BC-padded field (K ghost layers per axis, the
rules of ops/bc.py). The JAX package writes the interpolation as a sum
of (2K+1)^dim shifted slices times hat weights, ``hat(t) = max(0, 1 -
|t|)``, so that XLA fuses it into one pass without a gather. At most two
consecutive offsets per axis carry a nonzero weight, so here each cell
gathers only its 2^dim corners: the lower offset per axis is
``floor(-s_d)`` (kept inside the window), the weights are the same hat
values, and the corners are summed in the JAX function's lexicographic
order. On the card that is ~30 PyTorch kernels a call instead of ~400.

First-order departure points and linear interpolation: stable for any
dt, monotone (no new extrema), O(dx^2 + dt dx) accurate.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BCSpec, pad_axis_width


def center_spacing(geo: Geometry, d: int) -> np.ndarray:
    """Physical width of each cell along axis d (cell-shaped): the
    distance across its lower face (the JAX package's
    ``_center_spacing``)."""
    m = np.asarray(geo.face_dist[d])
    if not geo.axes[d].periodic and m.shape[d] == geo.axes[d].n + 1:
        sl = [slice(None)] * m.ndim
        sl[d] = slice(0, -1)
        m = m[tuple(sl)]
    return np.broadcast_to(m, geo.cell_shape)


def make_tables(h64: np.ndarray, K: int, device, dtype):
    """The tables of the interpolation on cells of shape h64.shape[1:]
    (``h64``: the cells' widths, (dim, *cells)) from a field padded by K
    per axis: (cell widths, flat index of each cell in the padded field,
    the padded field's strides (dim, 1, ...) and the corner offsets
    (2^dim, 1, ...), both int64), on ``device``."""
    n = h64.shape[1:]
    padded = [s + 2 * K for s in n]
    strides = np.array([int(np.prod(padded[d + 1:])) for d in range(len(n))],
                       np.int64)
    base = np.zeros(n, np.int64)
    for d in range(len(n)):
        shape = [1] * len(n)
        shape[d] = n[d]
        base = base + (np.arange(n[d]) + K).reshape(shape) * strides[d]
    corners = np.array([int(np.dot(c, strides)) for c in
                        itertools.product((0, 1), repeat=len(n))], np.int64)
    one = (1,) * len(n)
    return (torch.as_tensor(h64, dtype=dtype, device=device),
            torch.as_tensor(base, device=device),
            torch.as_tensor(strides.reshape((-1,) + one), device=device),
            torch.as_tensor(corners.reshape((-1,) + one), device=device))


def interpolate(u: torch.Tensor, p: torch.Tensor, dt, tables, K: int
                ) -> torch.Tensor:
    """The departure-point interpolation of ``p``, a field padded by K
    ghost layers per axis, with the cell velocities ``u`` (dim, *cells)
    and ``tables`` (``make_tables``) for those cells: the transported
    field, (*cells)."""
    h, base, strides, corners = tables
    dim = u.shape[0]
    s = torch.clamp(dt * u / h, -K, K)
    # the lower of the two offsets with a nonzero hat weight, kept in
    # the window [-K, K - 1] (at s = -K the upper one carries 1)
    lo = torch.clamp(torch.floor(-s), -K, K - 1)
    w_lo = torch.clamp(1.0 - torch.abs(s + lo), min=0.0)
    w_hi = torch.clamp(1.0 - torch.abs(s + (lo + 1.0)), min=0.0)
    idx = base + (lo.to(torch.int64) * strides).sum(0)
    vals = p.reshape(-1)[idx[None] + corners]
    # the product weights of the 2^dim corners, axis 0 outermost
    # (the JAX function's order: ((w_0 * w_1) * w_2))
    w = torch.stack([w_lo, w_hi], 1)          # (dim, 2, *cells)
    wc = w[0]
    for d in range(1, dim):
        wc = wc.unsqueeze(d) * w[d].reshape((1,) * d + tuple(w[d].shape))
    terms = wc.reshape((-1,) + tuple(u.shape[1:])) * vals
    out = terms[0]
    for c in range(1, terms.shape[0]):
        out = out + terms[c]
    return out


class SemiLagrangian:
    """Callable (u, f, dt) -> f at the backward departure points x - dt u,
    for one geometry, one set of ghost rules ``specs`` (one per axis, None
    for a periodic one) and ``ghost_width`` K: ``pad`` and then
    ``interpolate``. The cell widths and the cells' flat indices into the
    padded field are device tensors made once per (device, dtype), so
    that a call makes no host copy (it runs inside a CUDA graph's
    capture). ``calls`` counts the calls (a graph replay makes none)."""

    def __init__(self, geo: Geometry, specs: Sequence[Optional[BCSpec]],
                 ghost_width: int = 2):
        self.geo = geo
        self.specs = list(specs)
        self.K = int(ghost_width)
        self._h64 = np.stack([center_spacing(geo, d) for d in range(geo.dim)])
        self._dev = {}
        self.calls = 0

    def tables(self, device, dtype):
        """``make_tables`` for the geometry's cells on ``device``, made
        once."""
        key = (str(device), dtype)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = make_tables(self._h64, self.K, device, dtype)
        return t

    def pad(self, f: torch.Tensor) -> torch.Tensor:
        """``f`` with K ghost layers per axis, wall axes first: a Dirichlet
        value is shaped for the unpadded slice of the later axes."""
        geo = self.geo
        for d in range(geo.dim):
            f = pad_axis_width(f, d, self.specs[d], geo.axes[d].periodic,
                               self.K)
        return f

    def __call__(self, u: torch.Tensor, f: torch.Tensor, dt) -> torch.Tensor:
        """``u`` (dim, *cells) cell velocities, ``f`` (*cells): the
        transported field (not a tendency)."""
        self.calls += 1
        return interpolate(u, self.pad(f), dt,
                           self.tables(f.device, f.dtype), self.K)


def semi_lagrangian_transport(geo: Geometry, u: torch.Tensor,
                              f: torch.Tensor,
                              specs: Sequence[Optional[BCSpec]], dt, *,
                              ghost_width: int = 2) -> torch.Tensor:
    """f evaluated at the backward departure points x - dt u (the JAX
    package's ``semi_lagrangian_transport``): displacements clamped to
    ``ghost_width`` cells per axis."""
    return SemiLagrangian(geo, specs, ghost_width)(u, f, dt)
