"""The seeded inputs of a cell, made on the device: the benchmark's own,
handed alike to the program and to the reference.

A traffic file names its rule under ``seed_rule``:

* ``developed_flow``: the shell's developed-flow seed of the JAX repo's
  bench (a copy of the port's ``models/presets.py``
  ``seed_developed_flow``): a zonal jet u_lon = 0.1 cos(lat) (1 + 0.3
  sin(3 (lon + a)) sin(pi s)), u_lat = 0.005 cos(lat) sin(2 lon),
  p = 0.01 sin(lat) cos(2 lon) s, T the initial temperature plus
  1e-3 cos(lat) sin(2 lon + b) sin(pi s), s the radial fraction;
* ``prm_initial``: the configuration's own initial state (u = 0, p = 0,
  T the initial temperature) plus 1e-3 sin(3 phi + b) sin(pi s).

The phases a, b come from the seed; nothing else does, so every seed
gives the same shapes and the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.model import Fields, Reference


def phases(seed: int):
    """Two phases in [0, 2 pi) drawn from ``seed`` (any whole number)."""
    rng = np.random.default_rng(abs(int(seed)))
    a, b = rng.uniform(0.0, 2.0 * math.pi, size=2)
    return float(a), float(b)


def _axis(geo, d, device):
    return torch.as_tensor(np.asarray(geo.axes[d].centers),
                           dtype=torch.float64, device=device)


def make_inputs(ref: Reference, rule: str, seed: int,
                dtype: torch.dtype) -> Fields:
    """The seeded state of rule ``rule`` on ``ref``'s grid and device, in
    the working ``dtype``; the face velocities interpolated from the
    cell velocity in that dtype."""
    geo, dev = ref.geo, ref.device
    a, b = phases(seed)
    rc = _axis(geo, 0, dev)
    s = (rc - rc[0]) / max(float(rc[-1] - rc[0]), 1e-30)
    T0 = ref.T_init.to(torch.float64)
    if rule == "developed_flow":
        if geo.kind != "shell":
            raise ValueError("developed_flow seeds the shell")
        lat = _axis(geo, 1, dev)[None, :, None]
        lon = _axis(geo, 2, dev)[None, None, :]
        s3 = s[:, None, None]
        amp = 0.1
        u = torch.zeros((3,) + geo.cell_shape, dtype=torch.float64,
                        device=dev)
        u[2] = amp * torch.cos(lat) * (1.0 + 0.3 * torch.sin(3 * (lon + a))
                                       * torch.sin(math.pi * s3))
        u[1] = 0.05 * amp * torch.cos(lat) * torch.sin(2 * lon)
        p = (0.01 * torch.sin(lat) * torch.cos(2 * lon) * s3).expand(
            geo.cell_shape)
        T = T0 + 1e-3 * (torch.cos(lat) * torch.sin(2 * lon + b)
                         * torch.sin(math.pi * s3))
    elif rule == "prm_initial":
        if geo.kind != "annulus":
            raise ValueError("prm_initial seeds the annulus")
        phi = _axis(geo, 1, dev)[None, :]
        u = torch.zeros((2,) + geo.cell_shape, dtype=torch.float64,
                        device=dev)
        p = torch.zeros(geo.cell_shape, dtype=torch.float64, device=dev)
        T = T0 + 1e-3 * (torch.sin(3 * phi + b)
                         * torch.sin(math.pi * s[:, None]))
    else:
        raise ValueError(f"unknown seed rule {rule!r}")
    u = u.to(dtype).contiguous()
    return Fields(u, tuple(f.contiguous() for f in ref.faces(u)),
                  p.to(dtype).contiguous(), T.to(dtype).contiguous())
