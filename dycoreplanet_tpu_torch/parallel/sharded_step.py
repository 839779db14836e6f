"""The plain PyTorch rest of the shell step on a mesh: what the JAX
package leaves to GSPMD around its sharded kernels (the right-hand side
of the temperature solve, the face and cell correction of the
projection, the volume means, the divergence spot-check and the packed
diagnostics' reductions; in a temperature substep the Jacobi-Richardson
temperature solve). The temperature transport on the mesh is
parallel/sharded_transport.py.

Each stencil runs the port's plain operator on the shard padded by one
cell from its neighbours (``halo.pad_block``: lat rows from the
neighbours or, on the edge lat shards, the pole closure; lon columns
periodic), with the padded block's geometry (``mesh.shard_geometry``),
and is cropped: the operator's own edge rules and wraps touch only the
pad, so every owned cell sees the values and metric of the single-device
step. What the single-device operator applies at a wall face it reaches
only through the pad is applied here by the shard that owns the face
(the pole lat face, on the bottom lat shard). Sums and maxima over the
mesh are fixed-order (``halo.psum``, ``halo.pmax``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.projection import correct_plain
from dycoreplanet_tpu_torch.parallel.halo import pad_block, pmax, psum
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, Sharded, block, build, crop, local_shape, shard_geometry)


class ShardedShellStep:
    """Per-shard geometries and constants of a model's mesh step, and the
    step's plain stages on Sharded fields."""

    def __init__(self, model, mesh: Mesh):
        geo = model.geo
        self.mesh = mesh
        self.local = local_shape(geo, mesh)
        _, nl, no = self.local
        self.first = mesh.distinct_devices()[0]
        self.offsets = {(a, b): (a * nl, b * no)
                        for a in range(mesh.shape["lat"])
                        for b in range(mesh.shape["lon"])}
        # owned and one-cell-padded geometries of every shard
        self.geo = {ab: shard_geometry(geo, j0, nl, k0, no)
                    for ab, (j0, k0) in self.offsets.items()}
        self.geo_pad = {ab: shard_geometry(geo, j0, nl, k0, no, pad=1)
                        for ab, (j0, k0) in self.offsets.items()}
        self.vol = self.cut(model.vol, model.torch_dtype)
        self.T_lap_offset = self.cut(model.T_lap_offset, model.torch_dtype)
        self.diameter = self.cut(model.diameter, model.torch_dtype)
        self.T_diag = self.cut(model.T_diag, model.torch_dtype)
        self.total_vol = psum(self.vol.map(torch.sum), mesh)

    def cut(self, a: np.ndarray, dtype) -> Sharded:
        """A global (..., nlat, nlon) host array cut onto the mesh."""
        _, nl, no = self.local

        def one(i, j):
            j0, k0 = self.offsets[i, j]
            return torch.as_tensor(block(a, j0, nl, k0, no), dtype=dtype,
                                   device=self.mesh.device(i, j))

        return build(self.mesh, one)

    # ------------------------------------------------------------------
    def total(self, parts: Sharded) -> torch.Tensor:
        """The fixed-order sum of every shard's partial, on the first
        device."""
        return psum(parts, self.mesh)[self.first]

    def volume_mean(self, f: Sharded) -> Dict[torch.device, torch.Tensor]:
        """st.volume_mean over the mesh, on every device."""
        num = psum(f.map(lambda x, w: torch.sum(x * w.expand(x.shape)),
                         self.vol), self.mesh)
        return {d: num[d] / self.total_vol[d] for d in num}

    def correct(self, p_specs, u_star: Sharded, uf: Sequence[Sharded],
                phi: Sharded, pres: Sharded, dt, incremental: bool
                ) -> Tuple[Sharded, Tuple[Sharded, ...], Sharded]:
        """correct_plain on every shard (phi's volume mean subtracted):
        (u_new, faces, p_new)."""
        mesh = self.mesh
        phi_mean = self.volume_mean(phi)
        phi_p = pad_block(phi, mesh, 1, sign=1.0)     # p's POLE ghosts
        z = lambda x: F.pad(x, (1, 1, 1, 1))

        def one(a, b):
            u_new, *faces, p_new = correct_plain(
                self.geo_pad[a, b], p_specs, z(u_star[a, b]),
                [z(f[a, b]) for f in uf], phi_p[a, b], z(pres[a, b]), dt,
                phi_mean[mesh.device(a, b)], incremental)
            faces = [crop(f, 1).contiguous() for f in faces]
            if a == 0:      # the pole lat face (global face 0)
                faces[1][:, 0] = 0.0
            return (crop(u_new, 1).contiguous(), faces,
                    crop(p_new, 1).contiguous())

        out = build(mesh, one)
        faces = tuple(out.map(lambda o: o[1][d]) for d in range(3))
        return out.map(lambda o: o[0]), faces, out.map(lambda o: o[2])

    def divergence(self, faces: Sequence[Sharded]) -> Sharded:
        """st.divergence of the face velocities on every shard: the next
        lat row's and lon column's faces from the neighbours (zero past
        the pole, where the face has no area)."""
        fp = [pad_block(f, self.mesh, 1) for f in faces]
        return build(self.mesh, lambda a, b: crop(st.divergence(
            self.geo_pad[a, b], [f[a, b] for f in fp]), 1))

    def face_flux2(self, faces: Sequence[Sharded]) -> torch.Tensor:
        """sum_d sum((area_l * face)^2) over the mesh (the spot-check's
        round-off floor)."""
        def one(a, b):
            out = None
            for d in range(3):
                f = faces[d][a, b]
                t = torch.sum((st.metric(self.geo[a, b], "area_l", d, f)
                               * f) ** 2)
                out = t if out is None else out + t
            return out
        return self.total(build(self.mesh, one))

    def weak_laplacian(self, x: Sharded, specs) -> Sharded:
        """st.weak_laplacian of a scalar on every shard, from the shard
        padded by one cell (the pole ghosts: the ring at lon + pi, the
        POLE rule of ``specs``' lat axis)."""
        xp = pad_block(x, self.mesh, 1, sign=1.0)
        return build(self.mesh, lambda a, b: crop(st.weak_laplacian(
            self.geo_pad[a, b], xp[a, b], specs), 1))

    def temperature_solve(self, specs_hom, rhs_T: Sharded, kT, x0: Sharded,
                          iters: int, rtol: float):
        """(vol - kT weak_lap_hom) T = rhs_T by ``iters`` Jacobi-Richardson
        sweeps on the shards (solvers/fixed.py ``richardson_solve``: the
        residual tracked exactly, one exchange an apply), the residual and
        b norms from the fixed-order sums: (T, iterations, residual norm,
        converged), the norm and the verdict on the first device."""
        vol = self.vol
        diag = vol.map(lambda v, d: v + kT * d, self.T_diag)

        def op(x):
            return x.map(lambda t, v, w: v * t - kT * w, vol,
                         self.weak_laplacian(x, specs_hom))

        x = x0
        r = rhs_T.map(torch.sub, op(x))
        for _ in range(iters):
            dx = r.map(torch.div, diag)
            x = x.map(torch.add, dx)
            r = r.map(torch.sub, op(dx))
        eps = torch.finfo(rhs_T[0, 0].dtype).eps
        rnorm = torch.sqrt(self.total(r.map(lambda t: torch.sum(t * t))))
        bnorm = torch.sqrt(self.total(rhs_T.map(lambda t: torch.sum(t * t))))
        return x, iters, rnorm, rnorm <= max(rtol, 16.0 * eps) * bnorm

    def max(self, f: Sharded) -> torch.Tensor:
        return pmax(f.map(torch.max), self.mesh)

    def min(self, f: Sharded) -> torch.Tensor:
        return -pmax(f.map(lambda x: -torch.min(x)), self.mesh)
