"""K2: the explicit forcing of the shell standard personality, with the
temperature transport fused in, as a hand-written CUDA kernel beside its
plain PyTorch version.

Replaces the Pallas kernel ``ShellForcingPallas._build_call``
(dycoreplanet_tpu/ops/pallas_stencil.py:373). Computes

    rhs_u = u + dt * ( -(adv u + curv u) + cor u + buoy T
                       + visc_curv u / Re - grad p )
    T_adv = T - dt_T * u . grad T        (Dirichlet inner wall for T)

Kernel source: csrc/forcing.cu. Bound: device-memory traffic — u, the
three face velocities, T and p read, rhs_u and T_adv written: 12 fields,
~50 MB at 32x128x256 f32. Design: one thread per cell; the periodic lon
wrap, the pole ring at lon + pi and the radial wall mirrors are index
arithmetic on global loads (no rolls, no halo arrays).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dycoreplanet_tpu_torch.base import nondim
from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import vector as vec

FIELDS_MOVED = 12
# floating-point operations per cell, counted from csrc/forcing.cu with
# MUSCL: 4 advected fields x ~81 (3 axes x 2 faces of limited
# reconstruction and flux, divergence form), div(u_f) 12, curvature 20,
# Coriolis 10, buoyancy 5, viscous curvature 61, grad p 20, the update 23
OPS_PER_CELL = 480

_SCHEMES = {"muscl": 0, "upwind": 1, "centered": 2}


class ShellForcing:
    """Callable (u, u_faces, T, p, dt) -> (rhs_u, T_adv). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""

    def __init__(self, geo: Geometry, *, beta: float, T_ref: float,
                 rho_background: float, gravity: np.ndarray,
                 one_over_Re: float, omega_hat: float, coriolis_mode: str,
                 buoyancy: str, scheme: str, include_gradp: bool,
                 u_specs, p_specs, T_specs, T_wall: np.ndarray,
                 dt_T_factor: float = 1.0):
        self.geo = geo
        self.beta, self.T_ref = float(beta), float(T_ref)
        self.rho_background = float(rho_background)
        self.gravity = np.asarray(gravity)          # (3, *cells)
        self.one_over_Re = float(one_over_Re)
        self.omega_hat = float(omega_hat)
        self.coriolis_mode = coriolis_mode
        self.buoyancy = buoyancy
        self.scheme = scheme
        self.include_gradp = bool(include_gradp)
        self.u_specs, self.p_specs, self.T_specs = u_specs, p_specs, T_specs
        self.dt_T_factor = float(dt_T_factor)
        ch = kl.shell_channels(geo)
        g_r = kl.lon_invariant(self.gravity[0], "gravity")
        self._M64 = np.stack([ch[k] for k in (
            "vol", "ar_lo", "ar_hi", "alat_lo", "alat_hi", "alon", "dr_lo",
            "dr_hi", "dlat_lo", "dlat_hi", "dlon", "rc")] + [g_r])
        lat = np.asarray(geo.axes[1].centers, np.float64)
        self._lat64 = np.stack([np.cos(lat), np.tan(lat), lat])
        self._T_wall = np.array(np.broadcast_to(np.asarray(T_wall),
                                                geo.cell_shape[1:]))
        self._dev = {}
        self._fn = {}
        self.launches = 0

    # ------------------------------------------------------------------
    def explicit_forcing(self, u, u_faces, pres, T):
        """-adv u + cor u + buoy T + visc_curv u / Re - grad p: operation
        for operation the JAX package's
        ``BoussinesqModel._explicit_forcing``."""
        geo = self.geo
        rho = nondim.density_scaling(self.beta, T, self.T_ref)
        gravity = torch.as_tensor(self.gravity, dtype=u.dtype,
                                  device=u.device)
        if self.buoyancy == "perturbation":
            buoy = (rho - self.rho_background)[None] * gravity
        else:
            buoy = rho[None] * gravity
        div_u = st.divergence(geo, list(u_faces))
        adv = torch.stack([
            st.advect_scalar(geo, u_faces, u[c], self.u_specs[c],
                             scheme=self.scheme, form="advective",
                             div_u=div_u)
            for c in range(3)])
        adv = adv + vec.advection_curvature(geo, u)
        cor = vec.coriolis_acceleration(geo, u, self.omega_hat,
                                        self.coriolis_mode)
        visc_curv = self.one_over_Re * vec.vector_laplacian_curvature(
            geo, u, self.u_specs)
        forcing = -adv + cor + buoy + visc_curv
        if self.include_gradp:
            gradp = torch.stack([
                st.centered_gradient(geo, pres, d, self.p_specs[d])
                for d in range(3)])
            forcing = forcing - gradp
        return forcing

    def advected_temperature(self, u_faces, T, dt_T):
        """T - dt_T * u . grad T (the JAX package's Eulerian
        ``BoussinesqModel._advected_temperature``)."""
        adv_T = st.advect_scalar(self.geo, u_faces, T, self.T_specs,
                                 scheme=self.scheme, form="advective")
        return T - dt_T * adv_T

    def plain(self, u, u_faces, T, pres, dt):
        """Plain PyTorch version: (u + dt * forcing, T_adv)."""
        return (u + dt * self.explicit_forcing(u, u_faces, pres, T),
                self.advected_temperature(u_faces, T,
                                          dt * self.dt_T_factor))

    # ------------------------------------------------------------------
    def __call__(self, u, u_faces, T, pres, dt):
        if u.device.type == "cpu":
            return self.plain(u, u_faces, T, pres, dt)
        shp = self.geo.cell_shape
        dev, dtype = kl.require_cuda("forcing", {
            "u": (u, (3,) + shp), "u_faces[0]": (u_faces[0], shp),
            "u_faces[1]": (u_faces[1], shp), "u_faces[2]": (u_faces[2], shp),
            "T": (T, shp), "p": (pres, shp)})
        key = (str(dev), dtype)
        consts = self._dev.get(key)
        if consts is None:
            lat = self._lat64.copy()
            # sin(lat) in the working dtype, as the JAX function takes it
            lat[2] = np.sin(lat[2].astype(kl.NP_DTYPE[dtype]))
            consts = tuple(torch.as_tensor(a, dtype=dtype, device=dev)
                           .contiguous()
                           for a in (self._M64, lat, self._T_wall))
            self._dev[key] = consts
        M, lat, T_wall = consts
        sfx = kl.suffix(dtype)
        fn = self._fn.get(sfx)
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("forcing.cu", f"dp_forcing_{sfx}",
                         [I, I, I] + [P] * 9 + [D] * 7 + [I] * 4
                         + [P, P, P])
            self._fn[sfx] = fn
        rhs_u = torch.empty_like(u)
        T_adv = torch.empty_like(T)
        p = kl.ptr
        nr, nlat, nlon = shp
        dtf = float(dt)
        kl.check(fn(nr, nlat, nlon, p(u), p(u_faces[0]), p(u_faces[1]),
                    p(u_faces[2]), p(T), p(pres), p(T_wall), p(M), p(lat),
                    dtf, dtf * self.dt_T_factor, self.beta, self.T_ref,
                    self.rho_background, self.one_over_Re, self.omega_hat,
                    _SCHEMES[self.scheme],
                    int(self.coriolis_mode == "physical"),
                    int(self.buoyancy == "perturbation"),
                    int(self.include_gradp), p(rhs_u), p(T_adv),
                    kl.stream_of(u)), "forcing kernel")
        self.launches += 1
        return rhs_u, T_adv
