"""Structured curvilinear finite-volume geometry.

TPU-native replacement for the reference's distributed unstructured
triangulation (reference: include/core/planet_geometry.{h,tpp}): instead
of a p4est forest of deformed hexahedra, each domain is a logically
rectangular structured grid with analytic metric terms, so every
operator is a dense stencil that XLA can tile and fuse, and domain
decomposition is plain array sharding.

Conventions
-----------
* Cells are indexed ``[axis0, axis1(, axis2)]`` where axis0 is always the
  wall-bounded "vertical" direction (z or r) and the LAST axis is the
  (largest, periodic where applicable) direction — this puts the longest
  contiguous dimension in TPU lanes.
* Scalars (p, T) and velocity components live at cell centers
  (collocated / A-grid); face-normal velocities used by the projection
  are obtained by interpolation (Rhie-Chow style).
* Faces along a periodic axis: ``n`` faces, face ``i`` between cells
  ``i-1`` and ``i`` (wrap-around). Along a wall axis: ``n+1`` faces,
  face ``i`` left of cell ``i``.
* All metric arrays are stored *broadcast-shaped* against cell/face
  arrays (e.g. shell radial-face area has shape (nr+1, nlat, 1)) to keep
  HBM traffic minimal; XLA fuses the broadcasts into consumers.

Geometries
----------
* cuboid  — (z, y, x), periodic in x and y, walls at z
            (reference mesh: planet_geometry.tpp:29-57)
* annulus — (r, phi), periodic in phi, walls at r=R0, R1
            (reference 2D hyper_shell: planet_geometry.tpp:63-68)
* shell   — (r, lat, lon), periodic in lon, walls at r, zero-area pole
            faces at lat = +-pi/2 (reference 3D hyper_shell: same lines)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

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

    @property
    def total_volume(self) -> float:
        return float(np.sum(np.broadcast_to(self.vol, self.cell_shape)))

    def min_spacing(self) -> float:
        """Minimum physical distance between adjacent cell centers —
        conservative CFL length scale."""
        m = np.inf
        for d in range(self.dim):
            dist = np.broadcast_to(self.face_dist[d], self.face_shape(d))
            m = min(m, float(dist.min()))
        return m

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
