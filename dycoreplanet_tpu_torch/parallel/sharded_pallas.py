"""The forcing on a mesh: K2o, the forcing kernel in its operands halo
mode, on every shard, or K2mo, the same without the fused temperature
transport, for a semi-Lagrangian model (counterpart of the JAX
package's ``parallel/sharded_pallas.py``).

Each shard runs the same kernel with its lat and lon ghost layers as
operands (ops/forcing.py ``halo_shapes``), fetched from its neighbours
by ``parallel.halo``. The pole ghost rows of the two edge lat shards are
the boundary ring at lon + pi (``halo.half_turn``), the tangential
components sign-flipped (``_flip_vec``'s pattern), both rows of a side
the same ring. The lat face velocity of the next shard's first row is
zero past the top pole (a non-periodic exchange gives zeros there).

``ShardedPlainForcing`` is the forcing of the models that have no
forcing kernel on one device either (the coupled solves, the rotational
form of the FEEC personality, and every geometry but the shell: the box,
the annulus, the slab), and their Eulerian temperature transport:
``Forcing`` on every shard's block padded by the same two cells along
each sharded axis, as K2o's plain version runs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dycoreplanet_tpu_torch.ops.forcing import Forcing, ShellForcing
from dycoreplanet_tpu_torch.parallel.halo import (
    col_halo, exchange_ghosts, lat_halo, pad_block)
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, Sharded, block, build, crop, local_offsets, local_shape)

# the pole sign pattern of a stacked [u_r, u_lat, u_lon] row (POLE for
# u_r, POLE_FLIP for the tangential components: the local basis flips
# across the pole), as a factor broadcast over (3, nr, rows, nlon)
_FLIP_VEC = (1.0, -1.0, -1.0)


_FLIP_BY = {}


def _flip_vec(like: torch.Tensor) -> torch.Tensor:
    """The pattern in ``like``'s dtype on its device, made once there (a
    tensor made from host values is a host-to-device copy, which waits
    for the device)."""
    key = (like.dtype, like.device)
    out = _FLIP_BY.get(key)
    if out is None:
        out = _FLIP_BY[key] = torch.tensor(
            _FLIP_VEC, dtype=like.dtype, device=like.device).reshape(
                3, 1, 1, 1)
    return out


def face_seams(u_faces, mesh: Mesh) -> dict:
    """The next shard's first lat face (zero past the top pole) and lon
    face, each a Sharded: HLf1, HOf2 of ops/forcing.py ``halo_shapes``."""
    _, HLf1 = exchange_ghosts(u_faces[1], mesh, "lat", 1, width=1,
                              periodic=False)
    _, HOf2 = exchange_ghosts(u_faces[2], mesh, "lon", 2, width=1,
                              periodic=True)
    return dict(HLf1=HLf1, HOf2=HOf2)


def transport_halos(u_faces, T: Sharded, mesh: Mesh) -> dict:
    """The ghosts of the Eulerian temperature transport on a mesh, each a
    Sharded: the face seams and two T rows each side (the pole ring at
    lon + pi, both rows the same) and columns (HLT, HOT)."""
    return dict(face_seams(u_faces, mesh),
                HLT=lat_halo(T, mesh, 2, sign=1.0), HOT=col_halo(T, mesh, 2))


def per_shard(named: dict, mesh: Mesh) -> Sharded:
    """A dict of Sharded operands as a Sharded of dicts, each operand
    contiguous."""
    return build(mesh, lambda a, b: {k: v[a, b].contiguous()
                                     for k, v in named.items()})


def forcing_halos(u: Sharded, u_faces, T: Sharded, pres: Sharded,
                  mesh: Mesh, advect_T: bool = True) -> Sharded:
    """Every shard's ghost operands of K2o, or without the transport of
    K2mo (no T ghosts, as in the JAX ``_local_step``), by the names of
    ops/forcing.py ``halo_shapes``, as a Sharded of dicts."""
    named = (transport_halos(u_faces, T, mesh) if advect_T
             else face_seams(u_faces, mesh))
    named.update(HLu=lat_halo(u, mesh, 2, sign=u.map(_flip_vec)),
                 HLp=lat_halo(pres, mesh, 1, sign=1.0),
                 HOu=col_halo(u, mesh, 2), HOp=col_halo(pres, mesh, 1))
    return per_shard(named, mesh)


class ShardedShellForcing:
    """The shell forcing on a ("lat", "lon") mesh: ``__call__(u, u_faces,
    T, pres, dt)`` on Sharded fields -> (rhs_u, T_adv), Sharded, or rhs_u
    alone without the transport (K2mo), as ShellForcing's on global
    arrays. ``kernels=False`` runs the kernel's plain version on every
    shard, whatever the device (the kernel-free mesh path the caller
    asked for, ``prepare_sharded(mesh, kernels=False)``)."""

    def __init__(self, base: ShellForcing, mesh: Mesh,
                 kernels: bool = True):
        nr, nlat, nlon = base.geo.cell_shape
        A, B = int(mesh.shape["lat"]), int(mesh.shape["lon"])
        if nlat % A or nlon % B:
            raise ValueError("grid not divisible by mesh")
        self.local = (nr, nlat // A, nlon // B)
        if self.local[1] < 2 or self.local[2] < 2:
            # width-2 ghost layers need >= 2 interior rows per shard
            raise ValueError(
                f"shard too thin for width-2 halos: local {self.local}")
        self.mesh = mesh
        self.kernels = bool(kernels)
        # per-shard kernel: identical physics, ghosts as operands
        self.kern = ShellForcing(
            base.geo, beta=base.beta, T_ref=base.T_ref,
            rho_background=base.rho_background, gravity=base.gravity,
            one_over_Re=base.one_over_Re, omega_hat=base.omega_hat,
            coriolis_mode=base.coriolis_mode, buoyancy=base.buoyancy,
            scheme=base.scheme, include_gradp=base.include_gradp,
            u_specs=base.u_specs, p_specs=base.p_specs,
            T_specs=base.T_specs, T_wall=base._T_wall,
            dt_T_factor=base.dt_T_factor, advect_T=base.advect_T,
            halo_mode="operands", local_shape=self.local)

    def __call__(self, u: Sharded, u_faces, T: Sharded, pres: Sharded, dt):
        halos = forcing_halos(u, u_faces, T, pres, self.mesh,
                              self.kern.advect_T)
        _, nl, no = self.local
        call = (self.kern.call_operands if self.kernels
                else self.kern.plain_operands)
        out = build(self.mesh, lambda a, b: call(
            u[a, b], tuple(f[a, b] for f in u_faces), T[a, b], pres[a, b],
            dt, halos[a, b], (a * nl, b * no)))
        if not self.kern.advect_T:
            return out
        return (out.map(lambda o: o[0]), out.map(lambda o: o[1]))


class ShardedPlainForcing:
    """``Forcing`` (either advection form) and its Eulerian transport on
    the geometry's mesh: what the JAX package leaves to GSPMD where no
    forcing kernel runs. Each shard runs ``Forcing.on_block`` on its block
    padded by two cells along each sharded axis (``halo.pad_block``: on
    the shell u with its pole sign pattern, p and T with the POLE rule,
    the face velocities zero past the poles; elsewhere the periodic
    rings), cropped; the buoyancy reads T at the cell alone. ``T_wall``
    is the model's host array of the Dirichlet wall value (None on the
    fully periodic box). Calling it is the transport, (u, u_faces, T,
    dt_T) -> T_adv as parallel/sharded_transport.py's transports
    (``calls`` counts the calls)."""

    def __init__(self, base: Forcing, T_wall, mesh: Mesh):
        nl, no = local_shape(base.geo, mesh)[-2:]
        self.pads = mesh.pads(2)
        if (self.pads[0] and nl < 2) or no < 2:
            raise ValueError(f"shard too thin for width-2 halos: local "
                             f"{(nl, no)}")
        self.mesh = mesh
        self.pole = mesh.rows == "pole"
        self.shards = {}
        for (a, b), (j0, k0) in local_offsets(base.geo, mesh).items():
            wall = None if T_wall is None else torch.as_tensor(
                block(T_wall, j0, nl, k0, no, 2, rows=mesh.rows),
                device=mesh.device(a, b))
            self.shards[a, b] = base.on_block(j0, nl, k0, no, 2, wall)
        self.calls = 0

    def explicit_forcing(self, u: Sharded, u_faces, pres: Sharded,
                         T: Sharded) -> Sharded:
        """``Forcing.explicit_forcing`` on every shard."""
        mesh = self.mesh
        pr, pc = self.pads
        up = pad_block(u, mesh, 2, sign=u.map(_flip_vec) if self.pole
                       else None)
        fp = [pad_block(f, mesh, 2) for f in u_faces]
        pp = pad_block(pres, mesh, 2, sign=1.0)
        return build(mesh, lambda a, b: crop(
            self.shards[a, b].explicit_forcing(
                up[a, b], [f[a, b] for f in fp], pp[a, b],
                F.pad(T[a, b], (pc, pc, pr, pr))), self.pads).contiguous())

    def __call__(self, u: Sharded, u_faces, T: Sharded, dt_T) -> Sharded:
        """T - dt_T u . grad T with the face velocities ``u_faces`` (``u``
        unused: the semi-Lagrangian transport's)."""
        self.calls += 1
        mesh = self.mesh
        Tp = pad_block(T, mesh, 2, sign=1.0)
        fp = [pad_block(f, mesh, 2) for f in u_faces]
        return build(mesh, lambda a, b: crop(
            self.shards[a, b].advected_temperature(
                [f[a, b] for f in fp], Tp[a, b], dt_T),
            self.pads).contiguous())
