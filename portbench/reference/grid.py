"""Grids of the plain reference: a frozen copy of the port's
grid/geometry.py and the shell and annulus constructors of
grid/factory.py (structured finite-volume metrics, nondimensional)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Axis:
    """One logical grid axis."""

    name: str                 # 'z','y','x','r','phi','lat','lon'
    n: int                    # number of cells
    periodic: bool
    centers: np.ndarray       # (n,) coordinate of cell centers
    faces: np.ndarray         # (n,) if periodic else (n+1,) face coordinates

    @property
    def n_faces(self) -> int:
        return self.n if self.periodic else self.n + 1


@dataclass(frozen=True)
class Geometry:
    """Static metric bundle for one structured domain.

    Metric arrays (numpy, converted lazily to tensors by the ops layer):
      vol          — broadcastable to cell shape: cell volumes
      face_area[d] — broadcastable to face shape of axis d: face areas
      face_dist[d] — broadcastable to face shape of axis d: distance
                     between the two adjacent cell CENTERS across the
                     face (for wall faces: distance from the single
                     adjacent center to the wall, times 2 — i.e. the
                     ghost-mirror distance used by BC stencils)
    """

    kind: str
    axes: Tuple[Axis, ...]
    vol: np.ndarray
    face_area: Tuple[np.ndarray, ...]
    face_dist: Tuple[np.ndarray, ...]
    # geometry-specific extras (e.g. radii/latitude arrays for curvature
    # terms), all broadcast-shaped against cells
    extras: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def dim(self) -> int:
        return len(self.axes)

    @property
    def cell_shape(self) -> Tuple[int, ...]:
        return tuple(a.n for a in self.axes)

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cell_shape))

    def face_shape(self, d: int) -> Tuple[int, ...]:
        s = list(self.cell_shape)
        s[d] = self.axes[d].n_faces
        return tuple(s)

    def cell_diameter(self) -> np.ndarray:
        """Per-cell diagonal length (analogue of deal.II
        ``cell->diameter()`` used by the CFL formula,
        reference: boussinesq_model.tpp:1090). Broadcast-shaped."""
        sq = np.zeros(self.cell_shape)
        for d in range(self.dim):
            # local spacing of cell i along axis d: distance between its
            # two bounding faces measured through the center — use the
            # average of the two adjacent face distances as the physical
            # cell extent along d.
            dist = np.broadcast_to(self.face_dist[d], self.face_shape(d))
            if self.axes[d].periodic:
                left = dist
                right = np.roll(dist, -1, axis=d)
            else:
                sl_l = [slice(None)] * self.dim
                sl_l[d] = slice(0, -1)
                sl_r = [slice(None)] * self.dim
                sl_r[d] = slice(1, None)
                left = dist[tuple(sl_l)]
                right = dist[tuple(sl_r)]
            h = 0.5 * (left + right)
            sq = sq + h * h
        return np.sqrt(sq)


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
