"""The plain PyTorch rest of the step on a mesh: what the JAX
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

One class serves every geometry's layout (parallel/mesh.py): the
shell's ("lat", "lon"), the box's ("y", "x"), the annulus's ("phi",) and
the slab's ("x",). Each stencil runs the port's plain operator on the
shard padded by one cell from its neighbours (``halo.pad_block``: the
shell's lat rows from the neighbours or, on the edge lat shards, the
pole closure; every other sharded axis from its periodic ring), with
the padded block's geometry (``mesh.shard_geometry``), and is cropped:
the operator's own edge rules and wraps touch only the pad, so every
owned cell sees the values and metric of the single-device step. What
the single-device operator applies at a wall face it reaches only
through the pad is applied here by the shard that owns the face (the
shell's pole lat face, on the bottom lat shard); the vertical wall faces
lie in every shard. On the shell a velocity pads with its pole sign
pattern (u_r as a scalar, the tangential components sign-flipped:
``sharded_pallas._flip_vec``). Sums and maxima over the mesh are
fixed-order (``halo.psum``, ``halo.pmax``) and replicated: on a mesh
that spans processes every rank reads the same bits, on its own device
(``self.first``), and builds the tables of its own shards alone.
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
    Mesh, Sharded, block, build, crop, local_offsets, local_shape,
    shard_geometry)
from dycoreplanet_tpu_torch.parallel.sharded_pallas import _flip_vec
from dycoreplanet_tpu_torch.solvers.cg import _dot


class ShardedStep:
    """Per-shard geometries of a grid on its mesh and the step's plain
    stages on Sharded fields; with a ``model``, its constants cut to the
    shards too (without, the geometry-and-specs form the multigrid
    levels take: the stencils alone)."""

    def __init__(self, geo, mesh: Mesh, model=None, dtype=None):
        self.global_geo = geo
        self.model = model
        self.mesh = mesh
        self.local = local_shape(geo, mesh)
        self.dim = geo.dim
        self.n_cells = float(geo.n_cells)
        nl, no = self.local[-2:]
        self.first = mesh.own_device
        self.offsets = local_offsets(geo, mesh)
        self.pads = mesh.pads(1)
        # the shell's lat rows: a pole face on the bottom lat shard and
        # the velocity's pole sign pattern
        self.pole = mesh.rows == "pole"
        # owned and one-cell-padded geometries of this process's shards
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
        self._like[self.dtype] = self

    def like(self, dtype) -> "ShardedStep":
        """These stages with their constants in ``dtype`` (made once): a
        bfloat16 model's plain stages compute in float32."""
        out = self._like.get(dtype)
        if out is None:
            out = self._like[dtype] = ShardedStep(
                self.global_geo, self.mesh, self.model, dtype)
        return out

    def cut(self, a: np.ndarray, dtype) -> Sharded:
        """A global (..., n1, n2) host array cut onto the mesh."""
        nl, no = self.local[-2:]

        def one(i, j):
            j0, k0 = self.offsets[i, j]
            return torch.as_tensor(block(a, j0, nl, k0, no,
                                         rows=self.mesh.rows), dtype=dtype,
                                   device=self.mesh.device(i, j))

        return build(self.mesh, one)

    def _vec_sign(self, u: Sharded):
        """A velocity's pad sign: the shell's pole pattern, else none (a
        periodic ring has no sign)."""
        return u.map(_flip_vec) if self.pole else None

    def _crop(self, x: torch.Tensor) -> torch.Tensor:
        return crop(x, self.pads).contiguous()

    # ------------------------------------------------------------------
    def total(self, parts: Sharded) -> torch.Tensor:
        """The fixed-order sum of every shard's partial, on this process's
        first device (the same bits on every rank)."""
        return psum(parts, self.mesh)[self.first]

    def dot(self, x: Sharded, y: Sharded) -> torch.Tensor:
        """The Krylov loops' inner product on the mesh: every shard's
        ``_dot`` (float32 at the least), summed in a fixed order on the
        first device."""
        return self.total(x.map(_dot, y))

    def volume_mean(self, f: Sharded) -> Dict[torch.device, torch.Tensor]:
        """st.volume_mean over the mesh, on every device: the geometry's
        volumes in f's dtype, as on one device."""
        def parts(a, b):
            x = f[a, b]
            w = st.metric(self.geo[a, b], "vol", 0, x).expand(x.shape)
            return torch.stack([torch.sum(x * w), torch.sum(w)])

        tot = psum(build(self.mesh, parts), self.mesh)
        return {d: t[0] / t[1] for d, t in tot.items()}

    def correct(self, p_specs, u_star: Sharded, uf: Sequence[Sharded],
                phi: Sharded, pres: Sharded, dt, incremental: bool
                ) -> Tuple[Sharded, Tuple[Sharded, ...], Sharded]:
        """correct_plain on every shard (phi's volume mean subtracted):
        (u_new, faces, p_new)."""
        mesh = self.mesh
        phi_mean = self.volume_mean(phi)
        phi_p = pad_block(phi, mesh, 1, sign=1.0)     # p's POLE ghosts
        pr, pc = self.pads
        z = lambda x: F.pad(x, (pc, pc, pr, pr))      # noqa: E731

        def one(a, b):
            u_new, *faces, p_new = correct_plain(
                self.geo_pad[a, b], p_specs, z(u_star[a, b]),
                [z(f[a, b]) for f in uf], phi_p[a, b], z(pres[a, b]), dt,
                phi_mean[mesh.device(a, b)], incremental)
            faces = [self._crop(f) for f in faces]
            if self.pole and a == 0:   # the pole lat face (global face 0)
                faces[1][:, 0] = 0.0
            return self._crop(u_new), faces, self._crop(p_new)

        out = build(mesh, one)
        faces = tuple(out.map(lambda o: o[1][d]) for d in range(self.dim))
        return out.map(lambda o: o[0]), faces, out.map(lambda o: o[2])

    def divergence(self, faces: Sequence[Sharded]) -> Sharded:
        """st.divergence of the face velocities on every shard: the next
        row's and column's faces from the neighbours (on the shell zero
        past the pole, where the face has no area)."""
        fp = [pad_block(f, self.mesh, 1) for f in faces]
        return build(self.mesh, lambda a, b: crop(st.divergence(
            self.geo_pad[a, b], [f[a, b] for f in fp]), self.pads))

    def face_flux2(self, faces: Sequence[Sharded]) -> torch.Tensor:
        """sum_d sum((area_l * face)^2) over the mesh (the spot-check's
        round-off floor)."""
        def one(a, b):
            out = None
            for d in range(self.dim):
                f = faces[d][a, b]
                t = torch.sum((st.metric(self.geo[a, b], "area_l", d, f)
                               * f) ** 2)
                out = t if out is None else out + t
            return out
        return self.total(build(self.mesh, one))

    def weak_laplacian(self, x: Sharded, specs) -> Sharded:
        """st.weak_laplacian of a scalar on every shard, from the shard
        padded by one cell (on the shell the pole ghosts: the ring at lon
        + pi, the POLE rule of ``specs``' lat axis)."""
        xp = pad_block(x, self.mesh, 1, sign=1.0)
        return build(self.mesh, lambda a, b: crop(st.weak_laplacian(
            self.geo_pad[a, b], xp[a, b], specs), self.pads))

    def vector_laplacian(self, u: Sharded, u_specs) -> Sharded:
        """st.weak_laplacian of each velocity component on every shard
        (the momentum Helmholtz operator's), from the shard padded by one
        cell (on the shell with the pole sign pattern of u_specs' lat
        rules)."""
        up = pad_block(u, self.mesh, 1, sign=self._vec_sign(u))
        return build(self.mesh, lambda a, b: crop(torch.stack([
            st.weak_laplacian(self.geo_pad[a, b], up[a, b][c], u_specs[c])
            for c in range(self.dim)]), self.pads))

    def faces_div(self, u_specs, u_star: Sharded, dt):
        """K3's plain version on the mesh (ops/projection.py
        ``faces_div_plain``): the face velocities of u* (``cell_faces``)
        and the Poisson right-hand side -vol div(U*) / dt less its
        compatibility shift, the fixed-order total over the mesh /
        n_cells: (faces, rhs_phi)."""
        faces = self.cell_faces(u_specs, u_star)
        return faces, self.poisson_rhs(faces, dt, metric=True)

    def cell_faces(self, u_specs, u: Sharded) -> Tuple[Sharded, ...]:
        """ops/projection.py ``cell_to_faces`` of a cell velocity (or any
        vector field with the velocity's pole rule) on every shard (on the
        shell the pole lat face 0, written by the bottom lat shard)."""
        up = pad_block(u, self.mesh, 1, sign=self._vec_sign(u))

        def one(a, b):
            faces = [self._crop(f) for f in cell_to_faces(
                self.geo_pad[a, b], u_specs, up[a, b])]
            if self.pole and a == 0:   # the pole lat face (global face 0)
                faces[1][:, 0] = 0.0
            return faces

        out = build(self.mesh, one)
        return tuple(out.map(lambda o: o[d]) for d in range(self.dim))

    def gradient(self, x: Sharded, specs) -> Sharded:
        """The stacked st.centered_gradient of a scalar (the POLE rule of
        ``specs``' lat axis on the shell) on every shard."""
        xp = pad_block(x, self.mesh, 1, sign=1.0)
        return build(self.mesh, lambda a, b: self._crop(torch.stack([
            st.centered_gradient(self.geo_pad[a, b], xp[a, b], d, specs[d])
            for d in range(self.dim)])))

    def grad_faces(self, x: Sharded, specs) -> Tuple[Sharded, ...]:
        """st.grad_left_faces of a scalar along each axis on every shard
        (the wall faces as the single-device stencil gives them: the
        caller's ``wall_faces`` zeroes them)."""
        xp = pad_block(x, self.mesh, 1, sign=1.0)
        out = build(self.mesh, lambda a, b: [
            self._crop(st.grad_left_faces(self.geo_pad[a, b], xp[a, b], d,
                                          specs[d]))
            for d in range(self.dim)])
        return tuple(out.map(lambda o: o[d]) for d in range(self.dim))

    def curl(self, u: Sharded, u_specs) -> Sharded:
        """ops/vector.py ``curl_3d`` on every shard (the shell and the
        box), from the shard padded by one cell, on the shell with the
        pole sign pattern (the vorticity crosses the pole as the velocity
        does: its tangential components flip)."""
        up = pad_block(u, self.mesh, 1, sign=self._vec_sign(u))
        return build(self.mesh, lambda a, b: self._crop(vec.curl_3d(
            self.geo_pad[a, b], up[a, b], u_specs)))

    def less_mean(self, x: Sharded) -> Sharded:
        """x less its unweighted cell mean (the fixed-order total /
        n_cells)."""
        return x - self.total(x.map(torch.sum)) / self.n_cells

    def less_volume_mean(self, x: Sharded) -> Sharded:
        """x less its volume mean."""
        mean = self.volume_mean(x)
        return build(self.mesh, lambda a, b: x[a, b]
                     - mean[self.mesh.device(a, b)])

    def poisson_rhs(self, faces: Sequence[Sharded], dt,
                    metric: bool = False) -> Sharded:
        """-vol div(faces) / dt less its compatibility shift (the
        fixed-order total over the mesh / n_cells): vol the model's
        volumes in the stages' dtype (the mimetic step's, as one device
        weighs by its ``_vol_t``), or with ``metric`` the geometry's in
        the faces' dtype (K3's plain version, ``faces_div_plain``)."""
        div = self.divergence(faces)
        vol = (build(self.mesh, lambda a, b: st.metric(
            self.geo[a, b], "vol", 0, div[a, b])) if metric else self.vol)
        rhs_raw = div.map(lambda d, v: -v * d / dt, vol)
        total = self.total(rhs_raw.map(torch.sum))
        return rhs_raw - total / self.n_cells

    def wall_faces(self, faces: Sequence[Sharded]) -> Tuple[Sharded, ...]:
        """ops/projection.py ``apply_wall_face_values`` on the mesh: the
        vertical wall face on every shard (none on the fully periodic
        box), the shell's pole lat face (global face 0) on the bottom lat
        shard; the periodic sharded axes have no wall."""
        out = [faces[0].map(lambda t: apply_wall_face_values(
            self.global_geo, t, 0))]
        if self.pole:
            out.append(build(self.mesh, lambda a, b: apply_wall_face_values(
                self.geo[a, b], faces[1][a, b], 1) if a == 0
                else faces[1][a, b]))
        return tuple(out) + tuple(faces[len(out):])

    def max(self, f: Sharded) -> torch.Tensor:
        return pmax(f.map(torch.max), self.mesh)

    def min(self, f: Sharded) -> torch.Tensor:
        return -pmax(f.map(lambda x: -torch.min(x)), self.mesh)
