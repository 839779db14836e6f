"""K2: the explicit forcing of the shell standard personality, with the
temperature transport fused in, and K2m, the same forcing without the
transport, as hand-written CUDA kernels beside their plain PyTorch
versions.

They replace the Pallas kernel ``ShellForcingPallas._build_call``
(dycoreplanet_tpu/ops/pallas_stencil.py:373) with ``advect_T`` true (K2)
and false (K2m: the semi-Lagrangian temperature path, where the
transport is ops/semi_lagrangian.py), and compute

    rhs_u = u + dt * ( -(adv u + curv u) + cor u + buoy T
                       + visc_curv u / Re - grad p )
    T_adv = T - dt_T * u . grad T        (K2 only; Dirichlet inner wall)

Kernel source: csrc/forcing.cu (``forcing_kernel<T, ADVECT_T>``). Bound:
device-memory traffic — u, the three face velocities, T and p read,
rhs_u and T_adv written: 12 fields, ~50 MB at 32x128x256 f32 (K2m: 11
fields, ~46 MB). Design (2.5-D): a block owns an 8 x 32 lat-lon tile and
marches along the radius over ``plan(shape)``'s chunk of planes, staging
each plane with its lateral ghosts in shared memory and keeping the
radial neighbours in registers; each face flux is computed once. K2m
stages u alone and reads T at the cell.

``Forcing`` is the plain version in any geometry: the annulus step runs
it as it is, and ``ShellForcing`` adds the kernels to it.

The kernels take float32, float64 or bfloat16 fields. The bfloat16 forms
(``__nv_bfloat16`` storage) widen each value as it is read, stage and
compute in float32, keep their tables in float32 and round each output
once; their plain version is the float32 plain version on the widened
inputs, each output rounded once.

``halo_mode="operands"`` is K2o, K2 on one shard of a mesh (the Pallas
kernel's operands mode, pallas_stencil.py:116-131, 280-319, 708-719;
driven by parallel/sharded_pallas.py), and with ``advect_T`` false
K2mo, K2m on one shard (pallas_stencil.py:499-514, 696-730: what a
semi-Lagrangian model runs on a mesh): the call takes the shard's block
and its lat and lon ghosts as the operands of ``halo_shapes`` (eight;
six without the transport, which needs no T ghost), pole closure
already applied, and the shard's global offset, from which the wrapper
cuts its metric, lat rows and T_wall. The kernels are
``forcing_kernel<T, true, true>`` and ``<T, false, true>``; the plain
version pads the block with the ghosts, runs ``Forcing`` on the padded
block's geometry (mesh.shard_geometry) and crops. A shard is a fraction
of the grid, so the operands mode takes its radial chunk from the shard
and the card (``plan_operands``: the fewest planes a resident slot
marches) and stages its rows as 16-byte copies
(``shared_bytes(..., operands=True)``: every staged row on a 16-byte
boundary).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.base import nondim
from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.ops.bc import BCSpec
from dycoreplanet_tpu_torch.parallel.mesh import (
    block, crop, row_rule, shard_geometry)

FIELDS_MOVED = 12
# floating-point operations per cell, counted from csrc/forcing.cu with
# MUSCL: 4 advected fields x ~81 (3 axes x 2 faces of limited
# reconstruction and flux, divergence form), div(u_f) 12, curvature 20,
# Coriolis 10, buoyancy 5, viscous curvature 61, grad p 20, the update 23
OPS_PER_CELL = 480
# K2m: u, the face velocities, T and p read, rhs_u written; 3 advected
# fields, the update without T's 5
MOMENTUM_FIELDS_MOVED = 11
MOMENTUM_OPS_PER_CELL = 390

TILE = (8, 32)          # csrc/forcing.cu TL, TO: one thread per tile cell
RADIAL_CHUNK = 16       # planes a block marches over


def shared_bytes(itemsize: int, advect_T: bool = True,
                 operands: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/forcing.cu
    Lay::SMEM_VALUES): two staged planes (u0, u1, u2 and, with the
    transport, T with halo 2, p with halo 1, the lat and lon face
    velocities, 13 metric rows), those fields' lat and lon face fluxes,
    and the tile's 4 lat rows. The operands mode's rows are TO + 8 wide
    (p's too, the lon faces' TO + 4), each region rounded up to 16
    bytes."""
    tl, to = TILE
    nf = 4 if advect_T else 3
    n_xl, n_xo = (tl + 1) * to, tl * (to + 1)
    if operands:
        r4 = lambda n: -(-n // 4) * 4  # noqa: E731
        plane = (nf * (tl + 4) * (to + 8) + r4((tl + 2) * (to + 8))
                 + r4(n_xl) + r4(tl * (to + 4)) + r4(13 * (tl + 1)))
    else:
        plane = (nf * (tl + 4) * (to + 4) + (tl + 2) * (to + 2) + n_xl
                 + n_xo + 13 * (tl + 1))
    return itemsize * (2 * plane + nf * (n_xl + n_xo) + 4 * tl)


def plan(shape):
    """(planes per block, tiles along (radial, lat, lon)) of one launch:
    block b owns radial chunk b // (n_lat_tiles * n_lon_tiles)."""
    nr, nlat, nlon = shape
    rs = min(RADIAL_CHUNK, nr)
    return rs, (-(-nr // rs), -(-nlat // TILE[0]), -(-nlon // TILE[1]))


def plan_operands(shape, sms: int, per_sm: int):
    """``plan`` of the operands mode on a shard of ``shape`` on a card of
    ``sms`` SMs, each holding ``per_sm`` blocks of the instance at once
    (slots = sms * per_sm): the radial chunk RS with the fewest planes a
    slot marches, ceil(blocks / slots) * RS, and of those the longest,
    whose blocks repeat the prologue least (scripts/probe_k1_k2.py:
    PERF.md §6, PR 10). A shard with fewer (plane, tile) pairs than
    slots gets one plane a block; at 32x128x256 (K2's grid) the rule
    gives K2's own 16."""
    nr, nlat, nlon = shape
    tiles = -(-nlat // TILE[0]) * -(-nlon // TILE[1])
    slots = sms * per_sm
    rs = min(range(1, nr + 1), key=lambda rs: (
        -(-(-(-nr // rs) * tiles) // slots) * rs, -rs))
    return rs, (-(-nr // rs), -(-nlat // TILE[0]), -(-nlon // TILE[1]))


_SCHEMES = {"muscl": 0, "upwind": 1, "centered": 2}


def halo_shapes(local_shape, advect_T: bool = True):
    """The operands mode's ghost operands and their shapes for a shard of
    (nr, nlat, nlon) cells: two lat rows each side of u and, with the
    transport, T, one of p, the next shard's first lat face (zero past
    the pole); the same columns along lon. Rows and columns are ordered
    [g_-w .. g_-1, g_+1 .. g_+w]."""
    nr, nl, no = local_shape
    out = {"HLu": (3, nr, 4, no), "HLp": (nr, 2, no), "HLf1": (nr, 1, no),
           "HOu": (3, nr, nl, 4), "HOp": (nr, nl, 2), "HOf2": (nr, nl, 1)}
    if advect_T:
        out.update(HLT=(nr, 4, no), HOT=(nr, nl, 4))
    return out


class _Shard(NamedTuple):
    """What the operands mode keeps for one shard."""
    plain: "Forcing"         # Forcing on the shard padded by two cells
    M: np.ndarray            # the metric's rows j0 .. j0 + nl (the last:
                             # the next shard's first, zero past the pole)
    lat: np.ndarray          # the lat rows j0 .. j0 + nl - 1
    T_wall: np.ndarray       # the shard's block of T_wall
    dev: dict                # (device, dtype) -> (M, lat, T_wall) tensors


class Forcing:
    """The explicit forcing and the Eulerian temperature transport in
    plain PyTorch, in any geometry: operation for operation the JAX
    package's jnp path (``BoussinesqModel._explicit_forcing`` and the
    Eulerian ``_advected_temperature``), which the JAX model runs off the
    shell and for the FEEC personality. The annulus step and the
    rotational (FEEC) step run it as it is; on the shell it is the plain
    version of K2 and K2m (``ShellForcing``, advective form only).

    ``advection_form``: "advective" (the standard personality: the
    scheme's face fluxes plus the curvature terms) or "rotational" (the
    FEEC personality: omega x u + grad(|u|^2 / 2), the kinetic energy
    with the pressure's boundary specs, as in the JAX model)."""

    def __init__(self, geo: Geometry, *, beta: float, T_ref: float,
                 rho_background: float, gravity: np.ndarray,
                 one_over_Re: float, omega_hat: float, coriolis_mode: str,
                 buoyancy: str, scheme: str, include_gradp: bool,
                 u_specs, p_specs, T_specs,
                 advection_form: str = "advective"):
        if advection_form not in ("advective", "rotational"):
            raise ValueError(f"unknown advection form {advection_form!r}")
        self.advection_form = advection_form
        self.geo = geo
        self.beta, self.T_ref = float(beta), float(T_ref)
        self.rho_background = float(rho_background)
        self.gravity = np.asarray(gravity)          # (dim, *cells)
        self.one_over_Re = float(one_over_Re)
        self.omega_hat = float(omega_hat)
        self.coriolis_mode = coriolis_mode
        self.buoyancy = buoyancy
        self.scheme = scheme
        self.include_gradp = bool(include_gradp)
        self.u_specs, self.p_specs, self.T_specs = u_specs, p_specs, T_specs
        self._plain_consts = {}

    def _constants(self, like: torch.Tensor):
        """(gravity, 1 - rho_background, beta) on ``like``'s device in its
        dtype, made once (before a CUDA graph's capture, by its warm-up)."""
        key = (str(like.device), like.dtype)
        out = self._plain_consts.get(key)
        if out is None:
            out = tuple(torch.as_tensor(np.asarray(v), dtype=like.dtype,
                                        device=like.device)
                        for v in (self.gravity, 1.0 - self.rho_background,
                                  self.beta))
            self._plain_consts[key] = out
        return out

    def explicit_forcing(self, u, u_faces, pres, T):
        """-adv u + cor u + buoy T + visc_curv u / Re - grad p."""
        geo = self.geo
        gravity, one_minus_rho_bg, beta = self._constants(T)
        if self.buoyancy == "perturbation":
            # rho(T) - rho_background as the JAX package's compiled step
            # forms it: XLA folds the two constants, (1 - rho_background)
            # - beta (T - T_ref), and contracts the product and the
            # difference into one fused multiply-add (addcmul's), so that
            # where T is exactly 0 (aqua_planet.prm's underflowed IC) the
            # round-off buoyancy is the same
            buoy = torch.addcmul(one_minus_rho_bg, T - self.T_ref, beta,
                                 value=-1.0)[None] * gravity
        else:
            rho = nondim.density_scaling(self.beta, T, self.T_ref)
            buoy = rho[None] * gravity
        if self.advection_form == "advective":
            div_u = st.divergence(geo, list(u_faces))
            adv = torch.stack([
                st.advect_scalar(geo, u_faces, u[c], self.u_specs[c],
                                 scheme=self.scheme, form="advective",
                                 div_u=div_u)
                for c in range(geo.dim)])
            adv = adv + vec.advection_curvature(geo, u)
        else:
            adv = vec.rotational_advection(geo, u, self.u_specs,
                                           self.p_specs)
        cor = vec.coriolis_acceleration(geo, u, self.omega_hat,
                                        self.coriolis_mode)
        visc_curv = self.one_over_Re * vec.vector_laplacian_curvature(
            geo, u, self.u_specs)
        forcing = -adv + cor + buoy + visc_curv
        if self.include_gradp:
            gradp = torch.stack([
                st.centered_gradient(geo, pres, d, self.p_specs[d])
                for d in range(geo.dim)])
            forcing = forcing - gradp
        return forcing

    def advected_temperature(self, u_faces, T, dt_T):
        """T - dt_T * u . grad T."""
        adv_T = st.advect_scalar(self.geo, u_faces, T, self.T_specs,
                                 scheme=self.scheme, form="advective")
        return T - dt_T * adv_T

    def on_block(self, j0: int, nl: int, k0: int, no: int, pad: int,
                 T_wall) -> "Forcing":
        """This forcing on rows j0 .. j0 + nl and columns k0 .. k0 + no of
        the grid's axes -2 and -1 padded by ``pad`` cells along each
        sharded axis (mesh.shard_geometry, its gravity cut alike), the
        Dirichlet wall value ``T_wall`` already cut to the padded block
        (None on the fully periodic box, which has no wall): a shard's
        plain forcing on a mesh."""
        T_specs = list(self.T_specs)
        if T_wall is not None:
            T_specs[0] = BCSpec(T_specs[0].lo, T_specs[0].hi,
                                lo_value=T_wall)
        return Forcing(shard_geometry(self.geo, j0, nl, k0, no, pad=pad),
                       beta=self.beta, T_ref=self.T_ref,
                       rho_background=self.rho_background,
                       gravity=block(self.gravity, j0, nl, k0, no, pad,
                                     rows=row_rule(self.geo)),
                       one_over_Re=self.one_over_Re,
                       omega_hat=self.omega_hat,
                       coriolis_mode=self.coriolis_mode,
                       buoyancy=self.buoyancy, scheme=self.scheme,
                       include_gradp=self.include_gradp,
                       u_specs=self.u_specs, p_specs=self.p_specs,
                       T_specs=T_specs, advection_form=self.advection_form)


class ShellForcing(Forcing):
    """Callable (u, u_faces, T, p, dt) -> (rhs_u, T_adv) with
    ``advect_T`` (K2), else -> rhs_u (K2m). CPU tensors take the plain
    version (``Forcing``'s); CUDA tensors launch the kernel. Takes
    ``Forcing``'s arguments, the lat-lon shell only."""

    def __init__(self, geo: Geometry, *, T_wall: np.ndarray,
                 dt_T_factor: float = 1.0, advect_T: bool = True,
                 halo_mode: str = "local", local_shape=None, **forcing):
        ch = kl.shell_channels(geo)         # raises off the lat-lon shell
        super().__init__(geo, **forcing)
        if self.advection_form != "advective":
            # the JAX package builds no forcing kernel for the rotational
            # form (ops/pallas_stencil.py:1048-1049)
            raise ValueError("the forcing kernels compute the advective "
                             "form only")
        if halo_mode not in ("local", "operands"):
            raise ValueError(f"unknown halo mode {halo_mode!r}")
        # "local": the whole grid; "operands": one shard of local_shape,
        # its ghosts as operands
        self.halo_mode = halo_mode
        self.local_shape = (tuple(local_shape) if halo_mode == "operands"
                            else geo.cell_shape)
        self._shards = {}        # offset -> the shard's plain Forcing
        self.advect_T = bool(advect_T)
        self.dt_T_factor = float(dt_T_factor)
        g_r = kl.lon_invariant(self.gravity[0], "gravity")
        # the kernel's lon-invariant tables (csrc/forcing.cu M_*): areas,
        # and the reciprocals of the volume, the face distances and the
        # radius, so that it multiplies where the plain version divides
        self._M64 = np.stack(
            [1.0 / ch["vol"]]
            + [ch[k] for k in ("ar_lo", "ar_hi", "alat_lo", "alat_hi", "alon")]
            + [1.0 / ch[k] for k in ("dr_lo", "dr_hi", "dlat_lo", "dlat_hi",
                                     "dlon", "rc")] + [g_r])
        lat = np.asarray(geo.axes[1].centers, np.float64)
        # cos, tan, lat (-> sin in the working dtype), 1 / cos
        self._lat64 = np.stack([np.cos(lat), np.tan(lat), lat,
                                1.0 / np.cos(lat)])
        self._T_wall = np.array(np.broadcast_to(np.asarray(T_wall),
                                                geo.cell_shape[1:]))
        self._dev = {}
        self._fn = {}
        self._card = {}          # (device, dtype) -> (SMs, blocks an SM)
        self.launches = 0

    def plain(self, u, u_faces, T, pres, dt):
        """Plain PyTorch version: (u + dt * forcing, T_adv), or u + dt *
        forcing without the transport."""
        if u.dtype == torch.bfloat16:
            return kl.narrow(self.plain(*kl.widen((u, u_faces, T, pres)),
                                        dt))
        rhs_u = u + dt * self.explicit_forcing(u, u_faces, pres, T)
        if not self.advect_T:
            return rhs_u
        return rhs_u, self.advected_temperature(u_faces, T,
                                                dt * self.dt_T_factor)

    def occupancy(self, dtype: torch.dtype) -> int:
        """Resident blocks an SM of this wrapper's kernel instance on the
        card (its transport and halo mode; CUDA's occupancy calculator at
        its launch's block size and shared memory)."""
        blocks = ctypes.c_int(0)
        fn = kl.bind("forcing.cu", f"dp_forcing_{kl.suffix(dtype)}_occupancy",
                     [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        kl.check(fn(int(self.advect_T), int(self.halo_mode == "operands"),
                    ctypes.byref(blocks)), "forcing occupancy")
        return blocks.value

    def operands_plan(self, device, dtype: torch.dtype):
        """(planes per block, grid of tiles, resident slots) of the
        operands mode's launch on ``device``: ``plan_operands`` of the
        shard with the card's SM count and this instance's resident
        blocks an SM, read once a device and dtype."""
        key = (str(device), dtype)
        card = self._card.get(key)
        if card is None:
            card = (torch.cuda.get_device_properties(
                device).multi_processor_count, self.occupancy(dtype))
            self._card[key] = card
        rs, grid = plan_operands(self.local_shape, *card)
        return rs, grid, card[0] * card[1]

    # ------------------------------------------------------------------
    def _launch(self, u, u_faces, T, pres, dt):
        dev, dtype = u.device, u.dtype
        key = (str(dev), dtype)
        consts = self._dev.get(key)
        if consts is None:
            lat = self._lat64.copy()
            # sin(lat) in the working dtype, as the JAX function takes it
            # (float32, the compute type, under bfloat16 fields); T_wall
            # in the fields' dtype
            lat[2] = np.sin(lat[2].astype(kl.NP_DTYPE[dtype]))
            cdt = kl.compute_dtype(dtype)
            consts = tuple(torch.as_tensor(a, dtype=t, device=dev)
                           .contiguous()
                           for a, t in ((self._M64, cdt), (lat, cdt),
                                        (self._T_wall, dtype)))
            self._dev[key] = consts
        M, lat, T_wall = consts
        sfx = kl.suffix(dtype)
        fn = self._fn.get(sfx)
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("forcing.cu", f"dp_forcing_{sfx}",
                         [I] * 5 + [P] * 9 + [D] * 7 + [I] * 4
                         + [P, P, P])
            self._fn[sfx] = fn
        rhs_u = torch.empty_like(u)
        T_adv = torch.empty_like(T) if self.advect_T else None
        p = kl.ptr
        shp = self.geo.cell_shape
        dtf = float(dt)
        kl.check(fn(int(self.advect_T), *shp, plan(shp)[0], p(u),
                    p(u_faces[0]), p(u_faces[1]), p(u_faces[2]), p(T),
                    p(pres), p(T_wall) if self.advect_T else None, p(M),
                    p(lat), dtf, dtf * self.dt_T_factor, self.beta,
                    self.T_ref,
                    self.rho_background, self.one_over_Re, self.omega_hat,
                    _SCHEMES[self.scheme],
                    int(self.coriolis_mode == "physical"),
                    int(self.buoyancy == "perturbation"),
                    int(self.include_gradp), p(rhs_u),
                    p(T_adv) if self.advect_T else None,
                    kl.stream_of(u)), "forcing kernel")
        return (rhs_u, T_adv) if self.advect_T else rhs_u

    # ------------------------------------------------------------------
    # operands mode (K2o): one shard of a mesh
    def build_local_halos(self, u, u_faces, T, pres):
        """The operands for the whole grid as one shard (a 1 x 1 mesh on
        u's device): lat ghosts from the pole closure, lon ghosts from the
        periodic wrap; the mesh path builds the same layout from its
        neighbours (parallel/sharded_pallas.py)."""
        from dycoreplanet_tpu_torch.parallel.mesh import Mesh, Sharded
        from dycoreplanet_tpu_torch.parallel.sharded_pallas import (
            forcing_halos)

        one = lambda x: Sharded([[x]])
        mesh = Mesh([[u.device]], ("lat", "lon"))
        return forcing_halos(one(u), tuple(one(f) for f in u_faces),
                             one(T), one(pres), mesh,
                             advect_T=self.advect_T)[0, 0]

    def _shard(self, offset) -> _Shard:
        """The shard's plain Forcing and kernel tables, made on first
        use."""
        sh = self._shards.get(offset)
        if sh is None:
            nr, nl, no = self.local_shape
            j0, k0 = offset
            fo = self.on_block(j0, nl, k0, no, 2,
                               block(self._T_wall, j0, nl, k0, no, 2))
            M = np.zeros(self._M64.shape[:2] + (nl + 1,))
            top = min(j0 + nl + 1, self.geo.cell_shape[1])
            M[:, :, :top - j0] = self._M64[:, :, j0:top]
            sh = _Shard(fo, M, self._lat64[:, j0:j0 + nl],
                        self._T_wall[j0:j0 + nl, k0:k0 + no], {})
            self._shards[offset] = sh
        return sh

    @staticmethod
    def _pad(x, HL, HO, w):
        """A block padded by two cells with ``w`` ghost rows and columns
        (the rest of the pad, and the corners, which no axis-wise stencil
        reads, zero)."""
        out = x.new_zeros(x.shape[:-2] + (x.shape[-2] + 4, x.shape[-1] + 4))
        hi = -2 + w if w < 2 else None
        out[..., 2:-2, 2:-2] = x
        out[..., 2 - w:2, 2:-2] = HL[..., :w, :]
        out[..., -2:hi, 2:-2] = HL[..., w:, :]
        out[..., 2:-2, 2 - w:2] = HO[..., :w]
        out[..., 2:-2, -2:hi] = HO[..., w:]
        return out

    @staticmethod
    def _pad_faces(u_faces, HLf1, HOf2):
        """The face arrays padded by two cells, with the next shard's first
        lat face row and lon face column past the block (the only pad
        faces an owned cell reads)."""
        def seam(x, HL=None, HO=None):
            out = x.new_zeros(x.shape[:-2] + (x.shape[-2] + 4,
                                              x.shape[-1] + 4))
            out[..., 2:-2, 2:-2] = x
            if HL is not None:
                out[..., -2:-1, 2:-2] = HL
            if HO is not None:
                out[..., 2:-2, -2:-1] = HO
            return out

        return (seam(u_faces[0]), seam(u_faces[1], HL=HLf1),
                seam(u_faces[2], HO=HOf2))

    def transport_operands(self, u_faces, T, dt_T, halos, offset):
        """The Eulerian T - dt_T u . grad T on one shard from the ghosts
        HLT, HOT, HLf1 and HOf2 of ``halos``: ``Forcing``'s
        advected_temperature on the block padded by two cells, with the
        padded block's geometry, cropped (plain PyTorch: the operands
        mode's transport, and on a mesh the Eulerian temperature
        substep's; bfloat16 fields as ``plain_operands`` takes them)."""
        if T.dtype == torch.bfloat16:
            return kl.narrow(self.transport_operands(
                *kl.widen((u_faces, T)), dt_T, kl.widen(halos), offset))
        fo = self._shard(offset).plain
        H = halos
        Tp = self._pad(T, H["HLT"], H["HOT"], 2)
        fp = self._pad_faces(u_faces, H["HLf1"], H["HOf2"])
        return crop(fo.advected_temperature(fp, Tp, dt_T), 2).contiguous()

    def plain_operands(self, u, u_faces, T, pres, dt, halos, offset):
        """Plain version of K2o and K2mo: the block padded by two cells
        with the ghost operands, ``Forcing`` on the padded block's geometry
        (mesh.shard_geometry), cropped. Returns (rhs_u, T_adv) with the
        transport (``transport_operands``), else rhs_u. The forcing reads
        T at the cell alone (the buoyancy). bfloat16 fields: the float32
        plain version on them widened, each output rounded once."""
        if u.dtype == torch.bfloat16:
            return kl.narrow(self.plain_operands(
                *kl.widen((u, u_faces, T, pres)), dt, kl.widen(halos),
                offset))
        fo = self._shard(offset).plain
        H = halos
        up = self._pad(u, H["HLu"], H["HOu"], 2)
        fp = self._pad_faces(u_faces, H["HLf1"], H["HOf2"])
        pp = self._pad(pres, H["HLp"], H["HOp"], 1)
        Tp = torch.nn.functional.pad(T, (2, 2, 2, 2))
        rhs_u = crop(up + dt * fo.explicit_forcing(up, fp, pp, Tp),
                     2).contiguous()
        if not self.advect_T:
            return rhs_u
        return rhs_u, self.transport_operands(
            u_faces, T, dt * self.dt_T_factor, halos, offset)

    def call_operands(self, u, u_faces, T, pres, dt, halos, offset):
        """K2o (K2mo without the transport) on one shard whose first cell
        is global (row, column) ``offset``, its ghosts ``halos``
        (``halo_shapes``): (rhs_u, T_adv) on the shard, or rhs_u. CPU
        tensors take the plain version; CUDA tensors launch the kernel."""
        if self.halo_mode != "operands":
            raise ValueError("call_operands is the operands mode's")
        if u.device.type == "cpu":
            return self.plain_operands(u, u_faces, T, pres, dt, halos,
                                       offset)
        shp = self.local_shape
        dev, dtype = kl.require_cuda("forcing (operands)", {
            "u": (u, (3,) + shp), "u_faces[0]": (u_faces[0], shp),
            "u_faces[1]": (u_faces[1], shp), "u_faces[2]": (u_faces[2], shp),
            "T": (T, shp), "p": (pres, shp),
            **{k: (halos[k], s)
               for k, s in halo_shapes(shp, self.advect_T).items()}})
        sh = self._shard(offset)
        rs = self.operands_plan(dev, dtype)[0]
        key = (str(dev), dtype)
        tabs = sh.dev.get(key)
        if tabs is None:
            lat = sh.lat.copy()
            lat[2] = np.sin(lat[2].astype(kl.NP_DTYPE[dtype]))
            cdt = kl.compute_dtype(dtype)
            tabs = tuple(torch.as_tensor(a, dtype=t, device=dev)
                         .contiguous() for a, t in ((sh.M, cdt), (lat, cdt),
                                                    (sh.T_wall, dtype)))
            sh.dev[key] = tabs
        M, lat, T_wall = tabs
        sfx = kl.suffix(dtype)
        fn = self._fn.get(("operands", sfx))
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("forcing.cu", f"dp_forcing_{sfx}_operands",
                         [I] * 5 + [P] * 9 + [D] * 7 + [I] * 4 + [P, P]
                         + [I, I] + [P] * 8 + [P])
            self._fn[("operands", sfx)] = fn
        rhs_u = torch.empty_like(u)
        T_adv = torch.empty_like(T) if self.advect_T else None
        p = kl.ptr
        opt = lambda x: p(x) if self.advect_T else None
        dtf = float(dt)
        kl.check(fn(int(self.advect_T), *shp, rs, p(u),
                    p(u_faces[0]), p(u_faces[1]), p(u_faces[2]), p(T),
                    p(pres), opt(T_wall), p(M), p(lat),
                    dtf, dtf * self.dt_T_factor, self.beta, self.T_ref,
                    self.rho_background, self.one_over_Re, self.omega_hat,
                    _SCHEMES[self.scheme],
                    int(self.coriolis_mode == "physical"),
                    int(self.buoyancy == "perturbation"),
                    int(self.include_gradp), p(rhs_u), opt(T_adv),
                    offset[0], self.geo.cell_shape[1],
                    *(p(halos[k]) for k in ("HLu", "HLp", "HLf1", "HOu",
                                            "HOp", "HOf2")),
                    *(opt(halos.get(k)) for k in ("HLT", "HOT")),
                    kl.stream_of(u)), "forcing kernel (operands)")
        self.launches += 1
        return (rhs_u, T_adv) if self.advect_T else rhs_u

    def __call__(self, u, u_faces, T, pres, dt):
        if self.halo_mode != "local":
            raise ValueError("the operands mode is called by call_operands")
        if u.device.type == "cpu":
            return self.plain(u, u_faces, T, pres, dt)
        shp = self.geo.cell_shape
        kl.require_cuda("forcing", {
            "u": (u, (3,) + shp), "u_faces[0]": (u_faces[0], shp),
            "u_faces[1]": (u_faces[1], shp), "u_faces[2]": (u_faces[2], shp),
            "T": (T, shp), "p": (pres, shp)})
        out = self._launch(u, u_faces, T, pres, dt)
        self.launches += 1
        return out
