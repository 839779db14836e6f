"""K3: the pre-Poisson projection head (faces + divergence + Poisson
right-hand side) as a hand-written CUDA kernel, with its plain version.

Replaces the Pallas kernel ``ShellProjectionPallas._build_faces_div``
(dycoreplanet_tpu/ops/pallas_stencil.py:842), which the JAX model calls
on the steps that bypass the fused Richardson kernel
(models/boussinesq.py ``_project_velocity``). Kernel source:
csrc/projection.cu; the per-cell device code is shared with K1's
projection head (csrc/shell_common.cuh).

Bound: device-memory traffic — u* (3 fields) read, three faces and
rhs_raw written: 7 fields, ~29 MB at 32x128x256 f32. Design: one thread
per cell, ghosts by index arithmetic, fixed-order block sums of rhs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import stencil as st

# bytes that bound the kernel: fields read once plus fields written once
FIELDS_MOVED = 7
# floating-point operations per cell (faces, fluxes, divergence, rhs)
OPS_PER_CELL = 25


def apply_wall_face_values(geo: Geometry, uf: torch.Tensor, d: int
                           ) -> torch.Tensor:
    """Zero normal velocity on the lo wall face of a wall axis (entry 0
    of the cell-shaped faces; the hi wall face is implicit)."""
    if geo.axes[d].periodic:
        return uf
    zero = torch.zeros_like(st._sl(uf, d, slice(0, 1)))
    return torch.cat([zero, st._sl(uf, d, slice(1, None))], dim=d)


def faces_div_plain(geo: Geometry, u_specs, u_star: torch.Tensor, dt):
    """Plain PyTorch version: (uf0, uf1, uf2, rhs_raw, rhs_sum)."""
    uf = [apply_wall_face_values(
        geo, st.to_faces(geo, u_star[c], c, u_specs[c][c]), c)
        for c in range(3)]
    vol = st.metric(geo, "vol", 0, u_star)
    rhs_raw = -vol * st.divergence(geo, uf) / dt
    return uf[0], uf[1], uf[2], rhs_raw, torch.sum(rhs_raw).reshape(1)


class ShellProjection:
    """``faces_div(u_star, dt) -> (uf0, uf1, uf2, rhs_raw, rhs_sum)``;
    the caller subtracts ``rhs_sum / n_cells`` (compatibility). CPU
    tensors take the plain version; CUDA tensors launch the kernel."""

    def __init__(self, geo: Geometry, u_specs):
        self.geo = geo
        self.u_specs = u_specs
        ch = kl.shell_channels(geo)
        self._M64 = np.stack([ch[k] for k in (
            "vol", "ar_lo", "ar_hi", "alat_lo", "alat_hi", "alon")])
        self._M = {}
        self._fn = {}
        self.launches = 0

    def plain(self, u_star: torch.Tensor, dt):
        return faces_div_plain(self.geo, self.u_specs, u_star, dt)

    def faces_div(self, u_star: torch.Tensor, dt):
        if u_star.device.type == "cpu":
            return self.plain(u_star, dt)
        nr, nlat, nlon = self.geo.cell_shape
        dev, dtype = kl.require_cuda(
            "faces_div", {"u_star": (u_star, (3, nr, nlat, nlon))})
        key = (str(dev), dtype)
        if key not in self._M:
            self._M[key] = torch.as_tensor(self._M64, dtype=dtype,
                                           device=dev).contiguous()
        sfx = kl.suffix(dtype)
        fn = self._fn.get(sfx)
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("projection.cu", f"dp_faces_div_{sfx}",
                         [I, I, I, P, P, D, P, P, P, P, P, P, P])
            self._fn[sfx] = fn
        f0, f1, f2, rhs = (torch.empty((nr, nlat, nlon), dtype=dtype,
                                       device=dev) for _ in range(4))
        nblk = (nr * nlat * nlon + 255) // 256
        parts = torch.empty(nblk, dtype=dtype, device=dev)
        total = torch.empty(1, dtype=dtype, device=dev)
        p = kl.ptr
        kl.check(fn(nr, nlat, nlon, p(self._M[key]), p(u_star), float(dt),
                    p(f0), p(f1), p(f2), p(rhs), p(parts), p(total),
                    kl.stream_of(u_star)), "faces_div kernel")
        self.launches += 1
        return f0, f1, f2, rhs, total
