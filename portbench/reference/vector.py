"""Curvilinear vector terms of the plain reference: a frozen copy of the
port's ops/vector.py (advection and viscous curvature terms, Coriolis)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .bc import BCSpec
from .grid import Geometry
from .stencil import centered_gradient



def _require(geo: Geometry) -> None:
    if geo.kind not in ("cuboid", "annulus", "shell"):
        raise ValueError(geo.kind)


def _extra(geo: Geometry, name: str, like: torch.Tensor) -> torch.Tensor:
    """A geometry extra in ``like``'s dtype and device, cached on the
    geometry as ``stencil.metric`` caches the metrics (a step captured
    into a CUDA graph makes no host-to-device copy)."""
    cache = geo.extras.setdefault("_torch_extras", {})
    key = (name, like.dtype, str(like.device))
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(np.asarray(geo.extras[name]), dtype=like.dtype,
                            device=like.device)
        cache[key] = t
    return t


def advection_curvature(geo: Geometry, u: torch.Tensor) -> torch.Tensor:
    """Extra pointwise terms of (u.grad)u in curvilinear coordinates;
    zero on the cuboid."""
    _require(geo)
    if geo.kind == "cuboid":
        return torch.zeros_like(u)
    r = _extra(geo, "r_centers", u)
    if geo.kind == "annulus":
        ur, up = u[0], u[1]
        return torch.stack([-up * up / r, ur * up / r])
    tanl = _extra(geo, "tan_lat", u)
    ur, ul, up = u[0], u[1], u[2]
    return torch.stack([
        -(ul * ul + up * up) / r,
        ur * ul / r + up * up * tanl / r,
        ur * up / r - ul * up * tanl / r,
    ])


def vector_laplacian_curvature(
        geo: Geometry, u: torch.Tensor,
        specs: Sequence[Sequence[Optional[BCSpec]]]) -> torch.Tensor:
    """(Delta u)_local - componentwise Delta(u_local); ``specs[c][d]`` is
    the BC of component c along axis d. centered_gradient divides by the
    physical distances (r dphi; r dlat, r cos(lat) dlon), so the angular
    derivatives below are physical ones. Zero on the cuboid."""
    _require(geo)
    if geo.kind == "cuboid":
        return torch.zeros_like(u)
    r = _extra(geo, "r_centers", u)
    if geo.kind == "annulus":
        ur, up = u[0], u[1]
        dphi_up = centered_gradient(geo, up, 1, specs[1][1])
        dphi_ur = centered_gradient(geo, ur, 1, specs[0][1])
        return torch.stack([-ur / r**2 - 2.0 / r * dphi_up,
                            -up / r**2 + 2.0 / r * dphi_ur])
    tanl = _extra(geo, "tan_lat", u)
    cosl = _extra(geo, "cos_lat", u)
    ur, ul, up = u[0], u[1], u[2]
    dlat_ur = centered_gradient(geo, ur, 1, specs[0][1])
    dlat_ul = centered_gradient(geo, ul, 1, specs[1][1])
    dlon_ur = centered_gradient(geo, ur, 2, specs[0][2])
    dlon_ul = centered_gradient(geo, ul, 2, specs[1][2])
    dlon_up = centered_gradient(geo, up, 2, specs[2][2])
    extra_r = (-2.0 * ur / r**2
               - 2.0 / r * (dlat_ul - ul * tanl / r + dlon_up))
    extra_lat = (2.0 / r * dlat_ur
                 - ul / (r * cosl) ** 2
                 + 2.0 * tanl / r * dlon_up)
    extra_lon = (2.0 / r * dlon_ur
                 - 2.0 * tanl / r * dlon_ul
                 - up / (r * cosl) ** 2)
    return torch.stack([extra_r, extra_lat, extra_lon])




def coriolis_acceleration(geo: Geometry, u: torch.Tensor, omega_hat: float,
                          mode: str = "reference") -> torch.Tensor:
    """Coriolis acceleration in the local frame. mode='reference'
    reproduces the reference (SURVEY.md section 7.5): +2 (u_1, -u_0)
    with no Omega in 2D, the annulus and the slab alike
    (cross_product_2d, boussinesq_model.tpp:663-667), -2 Omega e_z x u
    on the 3D cuboid in either mode (tpp:616-621), none on the 3D shell;
    'physical' applies -2 Omega x u (2D: Omega along e_z, out of the
    plane)."""
    _require(geo)
    if geo.dim == 2:
        if mode == "reference":
            return 2.0 * torch.stack([u[1], -u[0]])
        return -2.0 * omega_hat * torch.stack([-u[1], u[0]])
    if geo.kind == "cuboid":
        # (0, 0, Omega) x (u_x, u_y, u_z) = (-Omega u_y, Omega u_x, 0),
        # stored (z, y, x)
        return -2.0 * omega_hat * torch.stack(
            [torch.zeros_like(u[0]), u[2], -u[1]])
    if mode == "reference":
        return torch.zeros_like(u)
    sinl = torch.sin(_extra(geo, "lat_centers", u))
    cosl = _extra(geo, "cos_lat", u)
    om_r = omega_hat * sinl
    om_l = omega_hat * cosl
    ur, ul, up = u[0], u[1], u[2]
    return torch.stack([2.0 * om_l * up,
                        -2.0 * om_r * up,
                        2.0 * (om_r * ul - om_l * ur)])
