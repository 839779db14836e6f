"""Analytic diagonal of the weak Laplacian — Jacobi preconditioner data.

TPU-native stand-in for the reference's Trilinos PreconditionJacobi
(reference: boussinesq_model.tpp:980-986 temperature Jacobi rebuilt each
step; block_schur_preconditioner.hpp:68-69 velocity Jacobi apply): on a
matrix-free structured grid the diagonal is computed once from metrics
(numpy, at setup) instead of being extracted from an assembled matrix.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec


def weak_laplacian_diagonal(
    geo: Geometry, specs: Sequence[Optional[BCSpec]]
) -> np.ndarray:
    """diag(weak_laplacian) with the given BCs (cell-shaped, negative).

    Per axis, cell i touches faces i and i+1 with conductance
    c = A/dist; its diagonal entry receives -c for each interior or
    periodic/pole face, -2c for an ANTISYM/DIRICHLET wall face (ghost =
    -f + const doubles the self-coupling), and 0 for a NEUMANN wall.
    """
    diag = np.zeros(geo.cell_shape)
    for d in range(geo.dim):
        c = np.broadcast_to(
            np.asarray(geo.face_area[d]) / np.asarray(geo.face_dist[d]),
            geo.face_shape(d),
        ).copy()
        if geo.axes[d].periodic:
            lo, hi = c, np.roll(c, -1, axis=d)
        else:
            spec = specs[d]
            assert spec is not None
            sl_lo = [slice(None)] * geo.dim
            sl_lo[d] = slice(0, -1)
            sl_hi = [slice(None)] * geo.dim
            sl_hi[d] = slice(1, None)
            lo = c[tuple(sl_lo)].copy()
            hi = c[tuple(sl_hi)].copy()

            def wall_factor(rule: BC) -> float:
                if rule == BC.NEUMANN:
                    return 0.0
                if rule in (BC.DIRICHLET, BC.ANTISYM):
                    return 2.0
                # POLE/POLE_FLIP couple to another cell; self-coupling 1
                # (and the pole faces have zero area anyway)
                return 1.0

            first = [slice(None)] * geo.dim
            first[d] = slice(0, 1)
            last = [slice(None)] * geo.dim
            last[d] = slice(-1, None)
            lo[tuple(first)] *= wall_factor(spec.lo)
            hi[tuple(last)] *= wall_factor(spec.hi)
        diag -= lo + hi
    return diag
