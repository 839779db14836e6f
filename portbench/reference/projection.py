"""Projection pieces of the plain reference: a frozen copy of the port's
plain versions of K3 and K5 (ops/projection.py ``faces_div_plain``,
``correct_plain``)."""

from __future__ import annotations

import torch

from . import stencil as st
from .grid import Geometry

def apply_wall_face_values(geo: Geometry, uf: torch.Tensor, d: int
                           ) -> torch.Tensor:
    """Zero normal velocity on the lo wall face of a wall axis (entry 0
    of the cell-shaped faces; the hi wall face is implicit)."""
    if geo.axes[d].periodic:
        return uf
    zero = torch.zeros_like(st._sl(uf, d, slice(0, 1)))
    return torch.cat([zero, st._sl(uf, d, slice(1, None))], dim=d)


def cell_to_faces(geo: Geometry, u_specs, u: torch.Tensor):
    """Face-normal velocities of a collocated field, wall faces 0."""
    return [apply_wall_face_values(
        geo, st.to_faces(geo, u[c], c, u_specs[c][c]), c)
        for c in range(geo.dim)]


def faces_div_plain(geo: Geometry, u_specs, u_star: torch.Tensor, dt):
    """Plain PyTorch version of K3, in any geometry (the JAX model's jnp
    chain off the shell): (*faces, rhs_raw, rhs_sum)."""
    uf = cell_to_faces(geo, u_specs, u_star)
    vol = st.metric(geo, "vol", 0, u_star)
    rhs_raw = -vol * st.divergence(geo, uf) / dt
    return (*uf, rhs_raw, torch.sum(rhs_raw).reshape(1))


def correct_plain(geo: Geometry, p_specs, u_star: torch.Tensor, uf,
                  phi: torch.Tensor, pres: torch.Tensor, dt, phi_mean,
                  incremental: bool):
    """Plain PyTorch version of K5, in any geometry: (u_new, *faces,
    p_new)."""
    phi = phi - phi_mean
    new_faces = []
    for d in range(geo.dim):
        gphi = st.grad_left_faces(geo, phi, d, p_specs[d])
        new_faces.append(apply_wall_face_values(geo, uf[d] - dt * gphi, d))
    gradphi_c = torch.stack([
        st.centered_gradient(geo, phi, d, p_specs[d])
        for d in range(geo.dim)])
    u_new = u_star - dt * gradphi_c
    p_new = pres + phi if incremental else phi
    return (u_new, *new_faces, p_new)

