"""The two projection stages around the Poisson solve as hand-written
CUDA kernels, each with its plain version (kernel source:
csrc/projection.cu).

K3, ``faces_div``: the pre-Poisson head (faces + divergence + Poisson
right-hand side). Replaces the Pallas kernel
``ShellProjectionPallas._build_faces_div``
(dycoreplanet_tpu/ops/pallas_stencil.py:842), which the JAX model calls
on the steps that bypass the fused Richardson kernel
(models/boussinesq.py ``_project_velocity``); the per-cell device code
is shared with K1's projection head (csrc/shell_common.cuh). Bound:
u* (3 fields) read, three faces and rhs_raw written: 7 fields, ~29 MB
at 32x128x256 f32.

K5, ``correct``: the post-Poisson correction (faces and cell velocity
minus dt grad phi, p + phi). Replaces the Pallas kernel
``ShellProjectionPallas._build_correct`` (pallas_stencil.py:920); the
JAX model computes the same chain in plain jnp, and every projection of
the port runs the kernel. Bound: 8 fields read (u* 3, phi, 3 faces, p)
and 7 written (u 3, 3 faces, p): 15 fields, ~62.9 MB at 32x128x256 f32.

Design of both: one thread per cell, ghosts by index arithmetic; K3
takes fixed-order block sums of rhs.

Both take float32, float64 or bfloat16 fields. The bfloat16 forms
compute in float32 and round each output once; K3's sum of rhs is then
float32 (rhs before its rounding). Their plain versions do the same: the
float32 plain version on the widened inputs, each output rounded once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC

# bytes that bound each kernel: fields read once plus fields written once
FIELDS_MOVED = 7
CORRECT_FIELDS_MOVED = 15
# floating-point operations per cell (faces, fluxes, divergence, rhs)
OPS_PER_CELL = 25
# (mean subtraction, six face gradients, three faces, three cell
# gradients and velocities, pressure)
CORRECT_OPS_PER_CELL = 30


def apply_wall_face_values(geo: Geometry, uf: torch.Tensor, d: int
                           ) -> torch.Tensor:
    """Zero normal velocity on the lo wall face of a wall axis (entry 0
    of the cell-shaped faces; the hi wall face is implicit)."""
    if geo.axes[d].periodic:
        return uf
    zero = torch.zeros_like(st._sl(uf, d, slice(0, 1)))
    return torch.cat([zero, st._sl(uf, d, slice(1, None))], dim=d)


def cell_to_faces(geo: Geometry, u_specs, u: torch.Tensor):
    """Face-normal velocities of a collocated field, wall faces 0."""
    return [apply_wall_face_values(
        geo, st.to_faces(geo, u[c], c, u_specs[c][c]), c)
        for c in range(geo.dim)]


def faces_div_plain(geo: Geometry, u_specs, u_star: torch.Tensor, dt):
    """Plain PyTorch version of K3, in any geometry (the JAX model's jnp
    chain off the shell): (*faces, rhs_raw, rhs_sum)."""
    uf = cell_to_faces(geo, u_specs, u_star)
    vol = st.metric(geo, "vol", 0, u_star)
    rhs_raw = -vol * st.divergence(geo, uf) / dt
    return (*uf, rhs_raw, torch.sum(rhs_raw).reshape(1))


def correct_plain(geo: Geometry, p_specs, u_star: torch.Tensor, uf,
                  phi: torch.Tensor, pres: torch.Tensor, dt, phi_mean,
                  incremental: bool):
    """Plain PyTorch version of K5, in any geometry: (u_new, *faces,
    p_new)."""
    phi = phi - phi_mean
    new_faces = []
    for d in range(geo.dim):
        gphi = st.grad_left_faces(geo, phi, d, p_specs[d])
        new_faces.append(apply_wall_face_values(geo, uf[d] - dt * gphi, d))
    gradphi_c = torch.stack([
        st.centered_gradient(geo, phi, d, p_specs[d])
        for d in range(geo.dim)])
    u_new = u_star - dt * gradphi_c
    p_new = pres + phi if incremental else phi
    return (u_new, *new_faces, p_new)


class ShellProjection:
    """The shell's projection kernels:

      ``faces_div(u_star, dt) -> (uf0, uf1, uf2, rhs_raw, rhs_sum)`` [K3];
        the caller subtracts ``rhs_sum / n_cells`` (compatibility);
      ``correct(u_star, uf, phi, pres, dt, phi_mean)
        -> (u_new, f0, f1, f2, p_new)`` [K5], ``phi_mean`` a one-element
        tensor (the volume mean of phi, subtracted inside).

    CPU tensors take the plain versions; CUDA tensors launch the
    kernels. ``faces_div_count`` and ``correct_count`` count each
    kernel's launches."""

    def __init__(self, geo: Geometry, u_specs, p_specs, incremental: bool):
        ch = kl.shell_channels(geo)         # raises off the lat-lon shell
        rules = (p_specs[0].lo, p_specs[0].hi, p_specs[1].lo, p_specs[1].hi)
        if rules != (BC.NEUMANN, BC.NEUMANN, BC.POLE, BC.POLE):
            raise ValueError("the correction kernel takes Neumann radial "
                             "walls and pole ghosts for the pressure")
        self.geo = geo
        self.u_specs = u_specs
        self.p_specs = p_specs
        self.incremental = bool(incremental)
        self._M64 = {
            "faces_div": np.stack([ch[k] for k in (
                "vol", "ar_lo", "ar_hi", "alat_lo", "alat_hi", "alon")]),
            "correct": np.stack([ch[k] for k in (
                "dr_lo", "dr_hi", "dlat_lo", "dlat_hi", "dlon")]),
        }
        self._M = {}
        self._fn = {}
        self.faces_div_count = kl.LaunchCount()
        self.correct_count = kl.LaunchCount()

    def plain(self, u_star: torch.Tensor, dt):
        if u_star.dtype == torch.bfloat16:
            *out, total = self.plain(u_star.float(), dt)
            return (*kl.narrow(out), total)
        return faces_div_plain(self.geo, self.u_specs, u_star, dt)

    def correct_plain(self, u_star, uf, phi, pres, dt, phi_mean):
        if u_star.dtype == torch.bfloat16:
            return kl.narrow(self.correct_plain(
                *kl.widen((u_star, uf, phi, pres)), dt, phi_mean.float()))
        return correct_plain(self.geo, self.p_specs, u_star, uf, phi, pres,
                             dt, phi_mean, self.incremental)

    def _prepare(self, which, dev, dtype, argtypes):
        """(metric channels on the device, bound entry point)."""
        key = (which, str(dev), dtype)
        if key not in self._M:
            self._M[key] = torch.as_tensor(
                self._M64[which], dtype=kl.compute_dtype(dtype),
                device=dev).contiguous()
        sfx = kl.suffix(dtype)
        fn = self._fn.get((which, sfx))
        if fn is None:
            fn = kl.bind("projection.cu", f"dp_{which}_{sfx}", argtypes)
            self._fn[(which, sfx)] = fn
        return self._M[key], fn

    def faces_div(self, u_star: torch.Tensor, dt):
        if u_star.device.type == "cpu":
            return self.plain(u_star, dt)
        nr, nlat, nlon = self.geo.cell_shape
        dev, dtype = kl.require_cuda(
            "faces_div", {"u_star": (u_star, (3, nr, nlat, nlon))})
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        M, fn = self._prepare("faces_div", dev, dtype,
                              [I, I, I, P, P, D, P, P, P, P, P, P, P])
        f0, f1, f2, rhs = (torch.empty((nr, nlat, nlon), dtype=dtype,
                                       device=dev) for _ in range(4))
        nblk = (nr * nlat * nlon + 255) // 256
        cdt = kl.compute_dtype(dtype)
        parts = torch.empty(nblk, dtype=cdt, device=dev)
        total = torch.empty(1, dtype=cdt, device=dev)
        p = kl.ptr
        kl.check(fn(nr, nlat, nlon, p(M), p(u_star), float(dt),
                    p(f0), p(f1), p(f2), p(rhs), p(parts), p(total),
                    kl.stream_of(u_star)), "faces_div kernel")
        self.faces_div_count.launches += 1
        return f0, f1, f2, rhs, total

    def correct(self, u_star: torch.Tensor, uf, phi: torch.Tensor,
                pres: torch.Tensor, dt, phi_mean: torch.Tensor):
        if u_star.device.type == "cpu":
            return self.correct_plain(u_star, uf, phi, pres, dt, phi_mean)
        cells = self.geo.cell_shape
        pm = phi_mean.reshape(1)
        dev, dtype = kl.require_cuda("correct", {
            "u_star": (u_star, (3,) + cells), "phi": (phi, cells),
            "uf0": (uf[0], cells), "uf1": (uf[1], cells),
            "uf2": (uf[2], cells), "pres": (pres, cells),
            "phi_mean": (pm, (1,))})
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        M, fn = self._prepare("correct", dev, dtype,
                              [I, I, I] + [P] * 8 + [D, I] + [P] * 6)
        u_new = torch.empty_like(u_star)
        f0, f1, f2, p_new = (torch.empty_like(phi) for _ in range(4))
        p = kl.ptr
        kl.check(fn(*cells, p(M), p(u_star), p(phi), p(uf[0]), p(uf[1]),
                    p(uf[2]), p(pres), p(pm), float(dt),
                    int(self.incremental), p(u_new), p(f0), p(f1), p(f2),
                    p(p_new), kl.stream_of(u_star)), "correct kernel")
        self.correct_count.launches += 1
        return u_new, f0, f1, f2, p_new
