"""The implicit stage on a mesh: K1o, the Richardson kernel in its
operands halo mode, on every shard (counterpart of the JAX package's
``parallel/sharded_richardson.py``).

Each shard runs the same fused solves and projection head on its inputs
extended by GH = max(iters) + 1 cells in lat and lon, recomputing the
iterates redundantly on the shrinking extended region as the kernel
does along the radius. The ghosts come from one stacked exchange of the
five input fields per direction, lon (periodic) first, so that the lat
ghosts carry the corner columns the iterated stencil needs. No pole
exchange: the lat pole faces have zero area, so the zero rows past a
pole (a non-periodic exchange's) cross into nothing. The shards' five
sums are added in a fixed order (``halo.psum``) for the residual norms
and the Poisson right-hand side's compatibility shift.
"""

from __future__ import annotations

from typing import Optional

import torch

from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson
from dycoreplanet_tpu_torch.parallel.halo import halo_pad, psum
from dycoreplanet_tpu_torch.parallel.mesh import Mesh, Sharded, build


class ShardedShellRichardson:
    """ShellRichardson on a ("lat", "lon") mesh: ``__call__(rhs_u, rhs_T,
    T0, dt)`` on Sharded fields -> (u_star, T_new, (uf0, uf1, uf2,
    rhs_phi), (rnorm_u, bnorm_u, rnorm_T, bnorm_T)), the fields Sharded,
    the norms 0-d tensors on this process's first device (the same bits
    on every rank of a process mesh)."""

    def __init__(self, kern: ShellRichardson, mesh: Mesh):
        if kern.halo_mode != "operands":
            raise ValueError("ShardedShellRichardson runs the operands mode")
        self.kern = kern
        self.mesh = mesh
        self.iters_u = kern.iters_u
        self.iters_T = kern.iters_T

    def __call__(self, rhs_u: Sharded, rhs_T: Sharded, T0: Sharded, dt):
        GH = self.kern.GH
        mesh = self.mesh
        _, nl, no = self.kern.local_shape
        # one stacked exchange per direction; lon (periodic) first so the
        # lat ghosts carry the corner columns
        st5 = rhs_u.map(lambda u, r, t: torch.cat([u, r[None], t[None]]),
                        rhs_T, T0)
        st5 = halo_pad(st5, mesh, "lon", 3, width=GH, periodic=True)
        st5 = halo_pad(st5, mesh, "lat", 2, width=GH, periodic=False)
        out = build(mesh, lambda a, b: self.kern.call_operands(
            st5[a, b][:3], st5[a, b][3], st5[a, b][4], dt,
            (a * nl, b * no)))
        tot = psum(out.map(lambda o: o[6]), mesh)
        norms = torch.sqrt(tot[mesh.own_device][:4])
        n_cells = float(self.kern.geo.n_cells)
        pick = lambda i: out.map(lambda o: o[i])
        rhs_phi = build(mesh, lambda a, b: out[a, b][5]
                        - tot[mesh.device(a, b)][4] / n_cells)
        # the global pole lat face is 0 (the single-device head's wall
        # face, JAX :86-88): the bottom lat shard's kernel writes it
        return (pick(0), pick(1), (pick(2), pick(3), pick(4), rhs_phi),
                (norms[0], norms[1], norms[2], norms[3]))


def make_sharded_richardson(model, mesh: Mesh
                            ) -> Optional[ShardedShellRichardson]:
    """The sharded fused implicit stage, or None where its gates fail (the
    JAX factory's: the shell; neither coupled nor direct; fixed solver
    iters > 0; a mesh that divides the grid; a ghost depth H = max(iters)
    + 1 within one radial block and within one shard)."""
    geo = model.geo
    p = model.params
    if geo.kind != "shell":
        return None
    if (p.numerics.momentum_solver == "coupled" or p.use_FEEC_solver
            or model.helmholtz_direct is not None
            or p.numerics.fixed_solver_iters <= 0):
        return None
    if not {"lat", "lon"} <= set(mesh.axis_names):
        return None
    nr, nlat, nlon = geo.cell_shape
    A, B = int(mesh.shape["lat"]), int(mesh.shape["lon"])
    if nlat % A or nlon % B:
        return None
    iters_T = p.numerics.fixed_solver_iters
    iters_u = model.momentum_iters
    H = max(iters_u, iters_T) + 1
    blk = next((b for b in (8, 16) if nr % b == 0), nr)
    if H > blk or nlat // A < H or nlon // B < H:
        return None  # ghost depth must fit one block / one shard
    kern = ShellRichardson(
        geo, one_over_Re=model.one_over_Re, one_over_Pe=model.one_over_Pe,
        nse_interval=p.NSE_solver_interval, helm_diags=model.helm_diags,
        T_diag=model.T_diag, iters_u=iters_u, iters_T=iters_T,
        u_specs=model.u_specs, T_specs_hom=model.T_specs_hom,
        halo_mode="operands", local_shape=(nr, nlat // A, nlon // B))
    return ShardedShellRichardson(kern, mesh)
