"""Finite-volume stencil operators (PyTorch).

Counterpart of the JAX package's ``ops/stencil.py``, the functions the
shell standard projection step uses. Every operator is a dense stencil
over the structured grid; metrics enter as broadcast-shaped tensors
converted once per (dtype, device) and cached on the geometry. The
arithmetic follows the JAX functions operation by operation, so the two
agree to round-off in float64 (tests/test_torch_ops.py).

Face indexing: "cell-shaped faces" hold n entries per axis, entry i the
LEFT face of cell i. The hi-wall face is implicit and carries zero
normal velocity (no-slip / no-normal-flux walls, zero-area pole faces).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BCSpec, ghost


def _sl(f: torch.Tensor, d: int, idx) -> torch.Tensor:
    sl = [slice(None)] * f.ndim
    sl[d] = idx
    return f[tuple(sl)]


def _left_metric(geo: Geometry, d: int, metric) -> np.ndarray:
    """Metric array restricted to the left faces (cell-shaped)."""
    m = np.asarray(metric)
    if not geo.axes[d].periodic and m.shape[d] == geo.axes[d].n + 1:
        sl = [slice(None)] * m.ndim
        sl[d] = slice(0, -1)
        m = m[tuple(sl)]
    return m


def _hi_metric(geo: Geometry, d: int, metric) -> np.ndarray:
    """Metric slice at the hi-wall face (1-wide along axis d)."""
    m = np.asarray(metric)
    if m.shape[d] == geo.axes[d].n + 1:
        sl = [slice(None)] * m.ndim
        sl[d] = slice(-1, None)
        m = m[tuple(sl)]
    return m


_METRICS = {
    "vol": lambda geo, d: geo.vol,
    "area_l": lambda geo, d: _left_metric(geo, d, geo.face_area[d]),
    "dist_l": lambda geo, d: _left_metric(geo, d, geo.face_dist[d]),
    "area_h": lambda geo, d: _hi_metric(geo, d, geo.face_area[d]),
    "dist_h": lambda geo, d: _hi_metric(geo, d, geo.face_dist[d]),
}


def metric(geo: Geometry, kind: str, d: int, like: torch.Tensor
           ) -> torch.Tensor:
    """Broadcast-shaped metric tensor in ``like``'s dtype and device,
    cached on the geometry (the JAX package caches its host eigen-
    system there the same way)."""
    cache = geo.extras.setdefault("_torch_metrics", {})
    key = (kind, d, like.dtype, str(like.device))
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(_METRICS[kind](geo, d)),
                            dtype=like.dtype, device=like.device)
        cache[key] = t
    return t


def _shift(f: torch.Tensor, d: int, k: int, g) -> torch.Tensor:
    """Value at index i+k along axis ``d``; edge rows that would wrap
    take the broadcastable ``g`` slice (``None`` = periodic wrap, a
    scalar = constant fill)."""
    n = f.shape[d]
    if g is None:
        return torch.roll(f, -k, dims=d)
    shp = list(f.shape)
    shp[d] = abs(k)
    if not torch.is_tensor(g):
        g = torch.full(shp, float(g), dtype=f.dtype, device=f.device)
    elif list(g.shape) != shp:
        g = g.expand(shp)
    if k > 0:
        return torch.cat([_sl(f, d, slice(k, None)), g], dim=d)
    return torch.cat([g, _sl(f, d, slice(0, n + k))], dim=d)


def _ghost_rows(f: torch.Tensor, d: int, spec: Optional[BCSpec],
                periodic: bool):
    """(lo, hi) one-wide ghost slices for axis d, or (None, None) for a
    periodic axis (the wrap IS the closure)."""
    if periodic:
        return None, None
    if spec is None:
        raise ValueError("wall axis requires a BCSpec")
    return (ghost(f, d, "lo", spec.lo, spec.lo_value, -1),
            ghost(f, d, "hi", spec.hi, spec.hi_value, -1))


def to_faces(geo: Geometry, f: torch.Tensor, d: int,
             spec: Optional[BCSpec] = None) -> torch.Tensor:
    """Arithmetic-mean interpolation to the LEFT faces of axis ``d``."""
    g_lo, _ = _ghost_rows(f, d, spec, geo.axes[d].periodic)
    return 0.5 * (_shift(f, d, -1, g_lo) + f)


def grad_left_faces(geo: Geometry, f: torch.Tensor, d: int,
                    spec: Optional[BCSpec] = None) -> torch.Tensor:
    """Normal derivative at the left faces (cell-shaped)."""
    g_lo, _ = _ghost_rows(f, d, spec, geo.axes[d].periodic)
    return (f - _shift(f, d, -1, g_lo)) / metric(geo, "dist_l", d, f)


def upwind_to_faces(geo: Geometry, f: torch.Tensor, d: int,
                    u_face: torch.Tensor,
                    spec: Optional[BCSpec] = None) -> torch.Tensor:
    """First-order upwind value at the left faces."""
    g_lo, _ = _ghost_rows(f, d, spec, geo.axes[d].periodic)
    return torch.where(u_face > 0, _shift(f, d, -1, g_lo), f)


def _van_leer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """van Leer limited slope, zero at extrema (TVD). The 1e-300 guard
    rounds to 0 in float32, as in the JAX function."""
    ab = a * b
    guard = 1e-300 if ab.dtype == torch.float64 else 0.0
    return torch.where(ab > 0, 2.0 * ab / (a + b + guard),
                       torch.zeros((), dtype=ab.dtype, device=ab.device))


def muscl_to_faces(geo: Geometry, f: torch.Tensor, d: int,
                   u_face: torch.Tensor,
                   spec: Optional[BCSpec] = None) -> torch.Tensor:
    """Second-order MUSCL (van Leer) face value at the left faces. The
    second ghost replicates the first, so a ghost cell's slope is 0."""
    periodic = geo.axes[d].periodic
    g_lo, g_hi = _ghost_rows(f, d, spec, periodic)
    s_m1 = _shift(f, d, -1, g_lo)
    s_p1 = _shift(f, d, 1, g_hi)
    slope = _van_leer(f - s_m1, s_p1 - f)
    slope_m1 = _shift(slope, d, -1, None if periodic else 0.0)
    L = s_m1 + 0.5 * slope_m1
    R = f - 0.5 * slope
    return torch.where(u_face > 0, L, R)


def face_flux_div(geo: Geometry, face_vals: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """(1/V) sum_d ([A q]_out - [A q]_in) for cell-shaped face-normal
    quantities ``q``; the implicit hi-wall flux is zero."""
    out = None
    for d, q in enumerate(face_vals):
        aq = metric(geo, "area_l", d, q) * q
        if geo.axes[d].periodic:
            contrib = torch.roll(aq, -1, dims=d) - aq
        else:
            contrib = _shift(aq, d, 1, 0.0) - aq
        out = contrib if out is None else out + contrib
    return out / metric(geo, "vol", 0, face_vals[0])


def divergence(geo: Geometry, u_faces: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """Divergence of a face-normal velocity field."""
    return face_flux_div(geo, u_faces)


def weak_laplacian(geo: Geometry, f: torch.Tensor,
                   specs: Sequence[Optional[BCSpec]]) -> torch.Tensor:
    """Volume-weighted (weak-form) Laplacian: sum_faces A * df/dn."""
    out = None
    for d in range(geo.dim):
        periodic = geo.axes[d].periodic
        g_lo, g_hi = _ghost_rows(f, d, specs[d], periodic)
        agl = metric(geo, "area_l", d, f) * (
            (f - _shift(f, d, -1, g_lo)) / metric(geo, "dist_l", d, f))
        if periodic:
            contrib = torch.roll(agl, -1, dims=d) - agl
        else:
            n = f.shape[d]
            ag_hi = metric(geo, "area_h", d, f) * (
                (g_hi - _sl(f, d, slice(n - 1, None)))
                / metric(geo, "dist_h", d, f))
            contrib = _shift(agl, d, 1, ag_hi) - agl
        out = contrib if out is None else out + contrib
    return out


def advect_scalar(geo: Geometry, u_faces: Sequence[torch.Tensor],
                  f: torch.Tensor, specs: Sequence[Optional[BCSpec]],
                  scheme: str = "upwind", form: str = "advective",
                  div_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """u . grad f (advective form: div(u f) - f div(u)) or div(u f)."""
    face_vals = []
    for d in range(geo.dim):
        if scheme == "upwind":
            fv = upwind_to_faces(geo, f, d, u_faces[d], specs[d])
        elif scheme == "muscl":
            fv = muscl_to_faces(geo, f, d, u_faces[d], specs[d])
        elif scheme == "centered":
            fv = to_faces(geo, f, d, specs[d])
        else:
            raise ValueError(f"unknown advection scheme {scheme!r}")
        face_vals.append(u_faces[d] * fv)
    div_uf = face_flux_div(geo, face_vals)
    if form == "flux":
        return div_uf
    if form == "advective":
        if div_u is None:
            div_u = divergence(geo, u_faces)
        return div_uf - f * div_u
    raise ValueError(f"unknown advection form {form!r}")


def centered_gradient(geo: Geometry, f: torch.Tensor, d: int,
                      spec: Optional[BCSpec] = None) -> torch.Tensor:
    """Cell-centered gradient component along axis d: average of the two
    adjacent face-normal derivatives."""
    periodic = geo.axes[d].periodic
    g_lo, g_hi = _ghost_rows(f, d, spec, periodic)
    gl = (f - _shift(f, d, -1, g_lo)) / metric(geo, "dist_l", d, f)
    if periodic:
        return 0.5 * (gl + torch.roll(gl, -1, dims=d))
    n = f.shape[d]
    g_hi_row = ((g_hi - _sl(f, d, slice(n - 1, None)))
                / metric(geo, "dist_h", d, f))
    return 0.5 * (gl + _shift(gl, d, 1, g_hi_row))


def cell_max_speed(geo: Geometry, u: torch.Tensor) -> torch.Tensor:
    """|u| at cell centers (u: (dim, *cells)) — feeds the CFL formula."""
    return torch.sqrt(torch.sum(u * u, dim=0))


def volume_mean(geo: Geometry, f: torch.Tensor) -> torch.Tensor:
    """Volume-weighted mean (the pressure zero-mean correction)."""
    w = metric(geo, "vol", 0, f).expand(f.shape)
    return torch.sum(f * w) / torch.sum(w)
