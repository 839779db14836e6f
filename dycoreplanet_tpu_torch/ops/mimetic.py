"""Discrete de Rham complex (mimetic staggered operators), PyTorch.

Counterpart of the JAX package's ``ops/mimetic.py``, the
structure-preserving counterpart of the reference's FEEC discretization
(Nedelec H(curl) vorticity — Raviart-Thomas H(div) velocity — L2
pressure; reference: boussineq_model_FEEC.tpp:21-30): on the structured
grid the complex lives on the staggered lattice

    0-forms (nodes) --grad--> 1-forms (edges) --curl--> 2-forms (faces)
                                     --div--> 3-forms (cells)

with all quantities in INTEGRATED convention (point values, line
integrals, face fluxes, cell totals). The chain identities

    curl(grad f) = 0        div(curl e) = 0

then hold EXACTLY (pure telescoping, no metric involved). Periodic axes
wrap; wall axes use zero extension beyond the boundary (the H0 complex),
which preserves the chain property.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry


def _delta(g: torch.Tensor, d: int, periodic: bool) -> torch.Tensor:
    """Forward difference delta_d g = g(i+1) - g(i); zero extension
    beyond the hi wall for bounded axes."""
    if periodic:
        return torch.roll(g, -1, dims=d) - g
    n = g.shape[d]
    hi = g.narrow(d, 1, n - 1)
    shifted = torch.cat([hi, torch.zeros_like(g.narrow(d, n - 1, 1))], dim=d)
    return shifted - g


def grad_edges(geo: Geometry, f: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """0-form (node values) -> 1-form (edge increments): along each
    axis, e_d = delta_d f."""
    return tuple(_delta(f, d, geo.axes[d].periodic) for d in range(geo.dim))


def curl_faces(geo: Geometry, e: Sequence[torch.Tensor]):
    """1-form (edge circulations) -> 2-form (face circulations).

    3D: (curl e)_d = delta_{d+1} e_{d+2} - delta_{d+2} e_{d+1}
    2D: scalar curl = delta_0 e_1 - delta_1 e_0.
    """
    per = [a.periodic for a in geo.axes]
    if geo.dim == 2:
        return _delta(e[1], 0, per[0]) - _delta(e[0], 1, per[1])
    out = []
    for d in range(3):
        a, b = (d + 1) % 3, (d + 2) % 3
        out.append(_delta(e[b], a, per[a]) - _delta(e[a], b, per[b]))
    return tuple(out)


def div_cells(geo: Geometry, F: Sequence[torch.Tensor]) -> torch.Tensor:
    """2-form (face fluxes) -> 3-form (cell totals): sum of outflux."""
    out = None
    for d in range(geo.dim):
        c = _delta(F[d], d, geo.axes[d].periodic)
        out = c if out is None else out + c
    return out
