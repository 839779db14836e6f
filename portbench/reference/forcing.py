"""The explicit forcing and the Eulerian temperature transport of the
plain reference: a frozen copy of the port's ``Forcing`` (ops/forcing.py,
the plain version of K2 and the annulus's forcing), advective form."""

from __future__ import annotations

import numpy as np
import torch

from . import stencil as st
from . import vector as vec
from .grid import Geometry

class Forcing:
    """-adv u + cor u + buoy T + visc_curv u / Re - grad p, and the
    Eulerian T - dt_T u . grad T, in plain PyTorch on any geometry."""

    def __init__(self, geo: Geometry, *, beta: float, T_ref: float,
                 rho_background: float, gravity: np.ndarray,
                 one_over_Re: float, omega_hat: float, coriolis_mode: str,
                 buoyancy: str, scheme: str, include_gradp: bool,
                 u_specs, p_specs, T_specs,
                 advection_form: str = "advective"):
        if advection_form != "advective":
            raise ValueError("the reference computes the advective form only")
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
            rho = 1.0 - self.beta * (T - self.T_ref)
            buoy = rho[None] * gravity
        div_u = st.divergence(geo, list(u_faces))
        adv = torch.stack([
            st.advect_scalar(geo, u_faces, u[c], self.u_specs[c],
                             scheme=self.scheme, form="advective",
                             div_u=div_u)
            for c in range(geo.dim)])
        adv = adv + vec.advection_curvature(geo, u)
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

