"""Geometry constructors + resolution derivation.

Maps the reference's single resolution knob ``initial global refinement``
(reference: planet_geometry.tpp:109-120, refine_global on coarse meshes
of 1 cuboid / 12 annulus / 6 shell cells) onto structured grid sizes
with matching cell counts:

  cuboid  r: 2^r cells per direction                  (1 * 8^r cells in 3D)
  annulus r: nr = 2^r,  nphi = 12 * 2^r               (12 * 4^r cells)
  shell   r: nr = 2^r,  nlat = 2^(r+1), nlon = 2^(r+2)
             (2^(3r+3) ~ 6 * 8^r cells, ratio 8/6 — the closest
             power-of-two lat-lon equivalent of the 6-panel shell)

All coordinates are nondimensional (mesh pre-scaled by 1/L_ref exactly
like GridTools::scale in the reference, boussinesq_model.tpp:42-63).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.geometry import Axis, Geometry


def resolution_from_refinement(kind: str, refinement: int) -> Tuple[int, ...]:
    r = refinement
    if kind == "cuboid":
        n = 2**r
        return (n, n, n)
    if kind == "annulus":
        return (2**r, 12 * 2**r)
    if kind == "shell":
        return (2**r, 2 ** (r + 1), 2 ** (r + 2))
    raise ValueError(f"unknown geometry kind {kind!r}")


def _wall_axis(name: str, lo: float, hi: float, n: int) -> Axis:
    faces = np.linspace(lo, hi, n + 1)
    centers = 0.5 * (faces[:-1] + faces[1:])
    return Axis(name=name, n=n, periodic=False, centers=centers, faces=faces)


def _periodic_axis(name: str, lo: float, hi: float, n: int) -> Axis:
    faces = np.linspace(lo, hi, n, endpoint=False)
    h = (hi - lo) / n
    centers = faces + 0.5 * h
    return Axis(name=name, n=n, periodic=True, centers=centers, faces=faces)


# ----------------------------------------------------------------------
# cuboid (z, y, x): unit cube scaled by 1/L_ref; periodic x,y; walls z
# ----------------------------------------------------------------------
def make_cuboid(nz: int, ny: int, nx: int, length_ref: float = 1.0,
                periodic_z: bool = False) -> Geometry:
    """Periodic-x/y unit cuboid with z walls (the reference domain,
    planet_geometry.tpp:29-57). ``periodic_z=True`` makes the domain
    fully periodic — no reference analogue; used by the manufactured-
    solution validation suite (exact Taylor-Green flows need a
    boundary-free domain)."""
    L = 1.0 / length_ref
    if periodic_z:
        az = _periodic_axis("z", 0.0, L, nz)
    else:
        az = _wall_axis("z", 0.0, L, nz)
    ay = _periodic_axis("y", 0.0, L, ny)
    ax = _periodic_axis("x", 0.0, L, nx)
    dz, dy, dx = L / nz, L / ny, L / nx

    vol = np.full((1, 1, 1), dz * dy * dx)
    area = (
        np.full((1, 1, 1), dy * dx),  # z-faces
        np.full((1, 1, 1), dz * dx),  # y-faces
        np.full((1, 1, 1), dz * dy),  # x-faces
    )
    # face distances: interior dz; wall faces ghost-mirror distance dz
    # (center to wall = dz/2, mirror distance = dz)
    dist_z = (np.full((1, 1, 1), dz) if periodic_z
              else np.full((nz + 1, 1, 1), dz))
    dist = (dist_z, np.full((1, 1, 1), dy), np.full((1, 1, 1), dx))
    extras = {
        "z_centers": az.centers.reshape(-1, 1, 1),
        "center": np.array([L / 2, L / 2, L / 2]),
        "diameter": L * np.sqrt(3.0),
    }
    return Geometry(kind="cuboid", axes=(az, ay, ax), vol=vol,
                    face_area=area, face_dist=dist, extras=extras)


# ----------------------------------------------------------------------
# 2D cuboid (z, x): unit square, periodic x, walls z (the reference's
# dim=2 cuboid branch, planet_geometry.tpp:29-57)
# ----------------------------------------------------------------------
def make_cuboid_2d(nz: int, nx: int, length_ref: float = 1.0) -> Geometry:
    L = 1.0 / length_ref
    az = _wall_axis("z", 0.0, L, nz)
    ax = _periodic_axis("x", 0.0, L, nx)
    dz, dx = L / nz, L / nx

    vol = np.full((1, 1), dz * dx)
    area = (np.full((1, 1), dx), np.full((1, 1), dz))
    dist = (np.full((nz + 1, 1), dz), np.full((1, 1), dx))
    extras = {
        "z_centers": az.centers.reshape(-1, 1),
        "center": np.array([L / 2, L / 2]),
        "diameter": L * np.sqrt(2.0),
    }
    return Geometry(kind="cuboid", axes=(az, ax), vol=vol,
                    face_area=area, face_dist=dist, extras=extras)


# ----------------------------------------------------------------------
# annulus (r, phi): shell R0..R1 in nondim units; periodic phi
# ----------------------------------------------------------------------
def make_annulus(nr: int, nphi: int, r0: float, r1: float) -> Geometry:
    ar = _wall_axis("r", r0, r1, nr)
    aphi = _periodic_axis("phi", 0.0, 2.0 * np.pi, nphi)
    dr = (r1 - r0) / nr
    dphi = 2.0 * np.pi / nphi

    rf = ar.faces                       # (nr+1,)
    rc = ar.centers                     # (nr,)
    # exact FV metrics (integrals of the polar Jacobian r)
    vol = (0.5 * (rf[1:] ** 2 - rf[:-1] ** 2) * dphi).reshape(-1, 1)  # (nr,1)
    area_r = (rf * dphi).reshape(-1, 1)          # (nr+1,1) arc length
    area_phi = np.full((1, 1), dr)               # radial segment length
    dist_r = np.full((nr + 1, 1), dr)            # uniform radial spacing
    dist_phi = (rc * dphi).reshape(-1, 1)        # arc distance at center radius
    extras = {
        "r_centers": rc.reshape(-1, 1),
        "r_faces": rf.reshape(-1, 1),
        "phi_centers": aphi.centers.reshape(1, -1),
    }
    return Geometry(kind="annulus", axes=(ar, aphi), vol=vol,
                    face_area=(area_r, area_phi), face_dist=(dist_r, dist_phi),
                    extras=extras)


# ----------------------------------------------------------------------
# shell (r, lat, lon): spherical shell R0..R1; lat in (-pi/2, pi/2) with
# zero-area pole faces; lon periodic
# ----------------------------------------------------------------------
def make_shell(nr: int, nlat: int, nlon: int, r0: float, r1: float) -> Geometry:
    ar = _wall_axis("r", r0, r1, nr)
    alat = _wall_axis("lat", -np.pi / 2, np.pi / 2, nlat)
    alon = _periodic_axis("lon", 0.0, 2.0 * np.pi, nlon)
    dr = (r1 - r0) / nr
    dlat = np.pi / nlat
    dlon = 2.0 * np.pi / nlon

    rf, rc = ar.faces, ar.centers
    latf, latc = alat.faces, alat.centers
    # exact integrals of the spherical Jacobian r^2 cos(lat)
    r3 = (rf[1:] ** 3 - rf[:-1] ** 3) / 3.0                  # (nr,)
    r2 = (rf[1:] ** 2 - rf[:-1] ** 2) / 2.0                  # (nr,)
    sin_band = np.sin(latf[1:]) - np.sin(latf[:-1])          # (nlat,)

    vol = r3.reshape(-1, 1, 1) * sin_band.reshape(1, -1, 1) * dlon
    # radial faces: r_f^2 * band * dlon
    area_r = (rf**2).reshape(-1, 1, 1) * sin_band.reshape(1, -1, 1) * dlon
    # latitude faces: (r^2/2 band) * cos(lat_f) * dlon ; zero at poles
    area_lat = r2.reshape(-1, 1, 1) * np.cos(latf).reshape(1, -1, 1) * dlon
    area_lat[:, 0, :] = 0.0    # exact zero at poles (cos(+-pi/2) rounding)
    area_lat[:, -1, :] = 0.0
    # longitude faces: (r^2/2 band ... ) no: integral over (r,lat) of
    # r dr dlat = r2 * dlat
    area_lon = r2.reshape(-1, 1, 1) * np.full((1, nlat, 1), dlat)

    dist_r = np.full((nr + 1, 1, 1), dr)
    # distance across a latitude face: arc r * dlat at cell-center radius
    dist_lat = rc.reshape(-1, 1, 1) * np.full((1, nlat + 1, 1), dlat)
    # distance across a longitude face: r cos(lat) dlon
    dist_lon = rc.reshape(-1, 1, 1) * np.cos(latc).reshape(1, -1, 1) * dlon

    extras = {
        "r_centers": rc.reshape(-1, 1, 1),
        "r_faces": rf.reshape(-1, 1, 1),
        "lat_centers": latc.reshape(1, -1, 1),
        "lon_centers": alon.centers.reshape(1, 1, -1),
        "cos_lat": np.cos(latc).reshape(1, -1, 1),
        "tan_lat": np.tan(latc).reshape(1, -1, 1),
    }
    return Geometry(kind="shell", axes=(ar, alat, alon), vol=vol,
                    face_area=(area_r, area_lat, area_lon),
                    face_dist=(dist_r, dist_lat, dist_lon), extras=extras)


# ----------------------------------------------------------------------
def make_geometry(params: Parameters) -> Geometry:
    """Build the domain described by a Parameters object, including the
    1/L_ref rescale the reference applies (boussinesq_model.tpp:42-63)."""
    L = params.reference_quantities.length
    num = params.numerics
    if params.cuboid_geometry:
        if params.space_dimension == 2:
            # the reference's dim=2 cuboid (planet_geometry.tpp:29-57):
            # unit square, periodic x, z walls
            n = 2 ** params.initial_global_refinement
            nz, nx = num.nz or n, num.nx or n
            return make_cuboid_2d(nz, nx, length_ref=L)
        nz, ny, nx = resolution_from_refinement("cuboid", params.initial_global_refinement)
        nz, ny, nx = num.nz or nz, num.ny or ny, num.nx or nx
        return make_cuboid(nz, ny, nx, length_ref=L)
    r0 = params.physical_constants.R0 / L
    r1 = params.physical_constants.R1 / L
    if params.space_dimension == 2:
        nr, nphi = resolution_from_refinement("annulus", params.initial_global_refinement)
        nr = num.n_radial or nr
        nphi = num.n_lon or nphi
        return make_annulus(nr, nphi, r0, r1)
    nr, nlat, nlon = resolution_from_refinement("shell", params.initial_global_refinement)
    nr = num.n_radial or nr
    nlat = num.n_lat or nlat
    nlon = num.n_lon or nlon
    return make_shell(nr, nlat, nlon, r0, r1)
