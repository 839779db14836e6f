"""Vector-field operators in the shell's local orthonormal basis
(u_r, u_lat, u_lon): curvature (Christoffel) terms of the advection and
the vector Laplacian, and the Coriolis acceleration (PyTorch).

Counterpart of the JAX package's ``ops/vector.py`` for the shell; the
annulus and cuboid branches are not ported yet (ROADMAP.md, "annulus and
cuboid geometries").
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BCSpec
from dycoreplanet_tpu_torch.ops.stencil import centered_gradient


def _require_shell(geo: Geometry) -> None:
    if geo.kind != "shell":
        raise NotImplementedError(
            f"{geo.kind} geometry is not ported yet (ROADMAP.md: annulus "
            "and cuboid geometries)")


def _extra(geo: Geometry, name: str, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(geo.extras[name]), dtype=like.dtype,
                           device=like.device)


def advection_curvature(geo: Geometry, u: torch.Tensor) -> torch.Tensor:
    """Extra pointwise terms of (u.grad)u in spherical coordinates."""
    _require_shell(geo)
    r = _extra(geo, "r_centers", u)
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
    the BC of component c along axis d."""
    _require_shell(geo)
    r = _extra(geo, "r_centers", u)
    tanl = _extra(geo, "tan_lat", u)
    cosl = _extra(geo, "cos_lat", u)
    ur, ul, up = u[0], u[1], u[2]
    # physical angular derivatives (centered_gradient divides by the arc
    # distances r dlat / r cos(lat) dlon)
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
    """Coriolis acceleration in the local frame. mode='reference' gives
    no Coriolis on the 3D shell (the reference skips it there,
    SURVEY.md section 7.5); 'physical' applies -2 Omega x u."""
    _require_shell(geo)
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
