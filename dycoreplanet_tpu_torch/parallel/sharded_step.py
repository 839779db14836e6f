"""The plain PyTorch rest of the shell step on a mesh: what the JAX
package leaves to GSPMD around its sharded kernels (the right-hand side
of the temperature solve, the face and cell correction of the
projection, the volume means, the divergence spot-check and the packed
diagnostics' reductions), and the operators of the plain solves that
run where K1o does not (escalated and all-CG steps, Richardson momentum
beside CG temperature, temperature substeps, ``prepare_sharded(mesh,
kernels=False)``): the momentum Helmholtz, temperature and Poisson
operators, the Jacobi diagonals, the faces and Poisson right-hand side
of K3's plain version, and the Krylov loops' inner product; the blocks
of the coupled solves (the centred gradient, the cell-to-face average,
the compact face gradient, the curl, the means). The model's solves
(models/boussinesq.py) run the one Richardson, CG and GMRES loop of
solvers/ on these, as on one device. The temperature transport on the
mesh is parallel/sharded_transport.py's (semi-Lagrangian) or
parallel/sharded_pallas.py's ``ShardedPlainForcing`` (Eulerian).

Each stencil runs the port's plain operator on the shard padded by one
cell from its neighbours (``halo.pad_block``: lat rows from the
neighbours or, on the edge lat shards, the pole closure; lon columns
periodic), with the padded block's geometry (``mesh.shard_geometry``),
and is cropped: the operator's own edge rules and wraps touch only the
pad, so every owned cell sees the values and metric of the single-device
step. What the single-device operator applies at a wall face it reaches
only through the pad is applied here by the shard that owns the face
(the pole lat face, on the bottom lat shard). A velocity pads with
its pole sign pattern (u_r as a scalar, the tangential components
sign-flipped: ``sharded_pallas._flip_vec``). Sums and maxima over the
mesh are fixed-order (``halo.psum``, ``halo.pmax``).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.ops.projection import (
    apply_wall_face_values, cell_to_faces, correct_plain)
from dycoreplanet_tpu_torch.parallel.halo import pad_block, pmax, psum
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, Sharded, block, build, crop, local_shape, shard_geometry)
from dycoreplanet_tpu_torch.parallel.sharded_pallas import _flip_vec
from dycoreplanet_tpu_torch.solvers.cg import _dot


class ShardedShellStep:
    """Per-shard geometries of a shell on a mesh and the step's plain
    stages on Sharded fields; with a ``model``, its constants cut to the
    shards too (without, the geometry-and-specs form the multigrid
    levels take: the stencils alone)."""

    def __init__(self, geo, mesh: Mesh, model=None, dtype=None):
        self.global_geo = geo
        self.model = model
        self.mesh = mesh
        self.local = local_shape(geo, mesh)
        self.n_cells = float(geo.n_cells)
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
        self._like = {}
        if model is None:
            return
        # the constants in the working dtype, or (``like``) in another
        self.dtype = model.torch_dtype if dtype is None else dtype
        c = lambda a: self.cut(a, self.dtype)  # noqa: E731
        self.vol = c(model.vol)
        self.T_lap_offset = c(model.T_lap_offset)
        self.diameter = c(model.diameter)
        self.T_diag = c(model.T_diag)
        self.helm_diags = c(model.helm_diags)
        self.poisson_diag = c(model.poisson_diag)
        self.total_vol = psum(self.vol.map(torch.sum), mesh)
        self._like[self.dtype] = self

    def like(self, dtype) -> "ShardedShellStep":
        """These stages with their constants in ``dtype`` (made once): a
        bfloat16 model's plain stages compute in float32."""
        out = self._like.get(dtype)
        if out is None:
            out = self._like[dtype] = ShardedShellStep(
                self.global_geo, self.mesh, self.model, dtype)
        return out

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

    def dot(self, x: Sharded, y: Sharded) -> torch.Tensor:
        """The Krylov loops' inner product on the mesh: every shard's
        ``_dot`` (float32 at the least), summed in a fixed order on the
        first device."""
        return self.total(x.map(_dot, y))

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

    def vector_laplacian(self, u: Sharded, u_specs) -> Sharded:
        """st.weak_laplacian of each velocity component on every shard
        (the momentum Helmholtz operator's), from the shard padded by one
        cell with the pole sign pattern of u_specs' lat rules."""
        up = pad_block(u, self.mesh, 1, sign=u.map(_flip_vec))
        return build(self.mesh, lambda a, b: crop(torch.stack([
            st.weak_laplacian(self.geo_pad[a, b], up[a, b][c], u_specs[c])
            for c in range(3)]), 1))

    def faces_div(self, u_specs, u_star: Sharded, dt):
        """K3's plain version on the mesh (ops/projection.py
        ``faces_div_plain``): the face velocities of u* (``cell_faces``)
        and the Poisson right-hand side -vol div(U*) / dt less its
        compatibility shift, the fixed-order total over the mesh /
        n_cells: (faces, rhs_phi)."""
        faces = self.cell_faces(u_specs, u_star)
        return faces, self.poisson_rhs(faces, dt)

    def cell_faces(self, u_specs, u: Sharded) -> Tuple[Sharded, ...]:
        """ops/projection.py ``cell_to_faces`` of a cell velocity (or any
        vector field with the velocity's pole rule) on every shard (the
        pole lat face 0, written by the bottom lat shard)."""
        up = pad_block(u, self.mesh, 1, sign=u.map(_flip_vec))

        def one(a, b):
            faces = [crop(f, 1).contiguous() for f in cell_to_faces(
                self.geo_pad[a, b], u_specs, up[a, b])]
            if a == 0:      # the pole lat face (global face 0)
                faces[1][:, 0] = 0.0
            return faces

        out = build(self.mesh, one)
        return tuple(out.map(lambda o: o[d]) for d in range(3))

    def gradient(self, x: Sharded, specs) -> Sharded:
        """The stacked st.centered_gradient of a scalar (the POLE rule of
        ``specs``' lat axis) on every shard."""
        xp = pad_block(x, self.mesh, 1, sign=1.0)
        return build(self.mesh, lambda a, b: crop(torch.stack([
            st.centered_gradient(self.geo_pad[a, b], xp[a, b], d, specs[d])
            for d in range(3)]), 1).contiguous())

    def grad_faces(self, x: Sharded, specs) -> Tuple[Sharded, ...]:
        """st.grad_left_faces of a scalar along each axis on every shard
        (the wall faces as the single-device stencil gives them: the
        caller's ``wall_faces`` zeroes them)."""
        xp = pad_block(x, self.mesh, 1, sign=1.0)
        out = build(self.mesh, lambda a, b: [
            crop(st.grad_left_faces(self.geo_pad[a, b], xp[a, b], d,
                                    specs[d]), 1).contiguous()
            for d in range(3)])
        return tuple(out.map(lambda o: o[d]) for d in range(3))

    def curl(self, u: Sharded, u_specs) -> Sharded:
        """ops/vector.py ``curl_3d`` on every shard, from the shard padded
        by one cell with the pole sign pattern (the vorticity crosses the
        pole as the velocity does: its tangential components flip)."""
        up = pad_block(u, self.mesh, 1, sign=u.map(_flip_vec))
        return build(self.mesh, lambda a, b: crop(vec.curl_3d(
            self.geo_pad[a, b], up[a, b], u_specs), 1).contiguous())

    def less_mean(self, x: Sharded) -> Sharded:
        """x less its unweighted cell mean (the fixed-order total /
        n_cells)."""
        return x - self.total(x.map(torch.sum)) / self.n_cells

    def less_volume_mean(self, x: Sharded) -> Sharded:
        """x less its volume mean."""
        mean = self.volume_mean(x)
        return build(self.mesh, lambda a, b: x[a, b]
                     - mean[self.mesh.device(a, b)])

    def poisson_rhs(self, faces: Sequence[Sharded], dt) -> Sharded:
        """-vol div(faces) / dt less its compatibility shift (the
        fixed-order total over the mesh / n_cells)."""
        rhs_raw = self.divergence(faces).map(lambda d, v: -v * d / dt,
                                             self.vol)
        total = self.total(rhs_raw.map(torch.sum))
        return rhs_raw - total / self.n_cells

    def wall_faces(self, faces: Sequence[Sharded]) -> Tuple[Sharded, ...]:
        """ops/projection.py ``apply_wall_face_values`` on the mesh: the
        radial wall face on every shard, the pole lat face (global face
        0) on the bottom lat shard."""
        f0 = faces[0].map(lambda t: apply_wall_face_values(
            self.geo[0, 0], t, 0))
        f1 = build(self.mesh, lambda a, b: apply_wall_face_values(
            self.geo[a, b], faces[1][a, b], 1) if a == 0 else faces[1][a, b])
        return (f0, f1, faces[2])

    def max(self, f: Sharded) -> torch.Tensor:
        return pmax(f.map(torch.max), self.mesh)

    def min(self, f: Sharded) -> torch.Tensor:
        return -pmax(f.map(lambda x: -torch.min(x)), self.mesh)
