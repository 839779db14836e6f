"""Vector-field operators in the local orthonormal bases (PyTorch):
curvature (Christoffel) terms of the advection and the vector Laplacian,
the centred curl and the rotational (vector-invariant) advection of the
FEEC personality, and the Coriolis acceleration, for the cuboid (w, v,
u) = (z, y, x) Cartesian, or (w, u) = (z, x) on the 2D slab, the
annulus (u_r, u_phi) and the shell (u_r, u_lat, u_lon).

Counterpart of the JAX package's ``ops/vector.py``. The cuboid has no
curvature terms; its curl is the physical right-handed one, restacked
into the (z, y, x) order. A 2D curl exists on the annulus only: the
rotational form on the 2D slab raises ValueError, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BCSpec
from dycoreplanet_tpu_torch.ops.stencil import centered_gradient


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


def curl_2d(geo: Geometry, u: torch.Tensor,
            specs: Sequence[Sequence[Optional[BCSpec]]]) -> torch.Tensor:
    """Scalar vorticity zeta = (1/r)[d_r(r u_phi) - d_phi u_r] on the
    annulus, (*cells,)."""
    _require(geo)
    if geo.kind != "annulus":
        raise ValueError(geo.kind)
    r = _extra(geo, "r_centers", u)
    ur, up = u[0], u[1]
    d_rup = centered_gradient(geo, r * up, 0, specs[1][0])
    dphi_ur = centered_gradient(geo, ur, 1, specs[0][1])
    return d_rup / r - dphi_ur


def curl_3d(geo: Geometry, u: torch.Tensor,
            specs: Sequence[Sequence[Optional[BCSpec]]]) -> torch.Tensor:
    """omega = curl u in the local frame, (3, *cells): on the cuboid the
    physical right-handed curl restacked into the (z, y, x) order; on the
    shell the centred gradients are physical derivatives (1/r d/dlat and
    1/(r cos lat) d/dlon)."""
    _require(geo)
    if geo.kind == "cuboid" and geo.dim == 3:
        w, v, uu = u[0], u[1], u[2]     # (z, y, x) components

        def grad(f, c, d):
            return centered_gradient(geo, f, d, specs[c][d])

        om_x = grad(w, 0, 1) - grad(v, 1, 0)
        om_y = grad(uu, 2, 0) - grad(w, 0, 2)
        om_z = grad(v, 1, 2) - grad(uu, 2, 1)
        return torch.stack([om_z, om_y, om_x])
    if geo.kind != "shell":
        raise ValueError(geo.kind)
    r = _extra(geo, "r_centers", u)
    cosl = _extra(geo, "cos_lat", u)
    ur, ul, up = u[0], u[1], u[2]
    d_cos_up = centered_gradient(geo, cosl * up, 1, specs[2][1])
    dlon_ul = centered_gradient(geo, ul, 2, specs[1][2])
    om_r = -d_cos_up / cosl + dlon_ul
    d_rup = centered_gradient(geo, r * up, 0, specs[2][0])
    dlon_ur = centered_gradient(geo, ur, 2, specs[0][2])
    om_lat = dlon_ur - d_rup / r
    dlat_ur = centered_gradient(geo, ur, 1, specs[0][1])
    d_rul = centered_gradient(geo, r * ul, 0, specs[1][0])
    om_lon = d_rul / r - dlat_ur
    return torch.stack([om_r, om_lat, om_lon])


def rotational_advection(
        geo: Geometry, u: torch.Tensor,
        specs: Sequence[Sequence[Optional[BCSpec]]],
        ke_spec: Sequence[Optional[BCSpec]]) -> torch.Tensor:
    """The vector-invariant (rotational) form of (u.grad)u, omega x u +
    grad(|u|^2 / 2): the FEEC personality's advection (reference:
    boussineq_model_FEEC.tpp:786-805). Returns (dim, *cells)."""
    _require(geo)
    ke = 0.5 * torch.sum(u * u, dim=0)
    grad_ke = torch.stack([centered_gradient(geo, ke, d, ke_spec[d])
                           for d in range(geo.dim)])
    if geo.dim == 2:
        # on the annulus only: the 2D slab has no curl_2d (ValueError)
        zeta = curl_2d(geo, u, specs)
        # (zeta e_z) x u = zeta (-u_phi, u_r) in (r, phi) components
        rot = torch.stack([-zeta * u[1], zeta * u[0]])
    elif geo.kind == "cuboid":
        # the right-handed cross product in (x, y, z), components
        # stored (z, y, x)
        az, ay, ax = curl_3d(geo, u, specs)
        bz, by, bx = u[0], u[1], u[2]
        cx = ay * bz - az * by
        cy = az * bx - ax * bz
        cz = ax * by - ay * bx
        rot = torch.stack([cz, cy, cx])
    else:
        # the right-handed triad (x, y, z) = (lon, lat, r)
        ar, al, ap = curl_3d(geo, u, specs)
        br, bl, bp = u[0], u[1], u[2]
        cx = al * br - ar * bl   # lon
        cy = ar * bp - ap * br   # lat
        cz = ap * bl - al * bp   # r
        rot = torch.stack([cz, cy, cx])
    return rot + grad_ke


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
