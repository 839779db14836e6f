"""Fast-diagonalization Poisson solve for the uniform-radius shell
(PyTorch counterpart of the JAX package's ``solvers/spectral.py``).

Solves -weak_laplacian(x) = b with sum(b) = 0 by diagonalizing all three
axes with dense transforms (host f64 setup, identical to the JAX
package's):

  lon:  real DFT as a matmul pair (F forward, its f64 pseudo-inverse G)
  lat:  per-lon-mode generalized eigentransform V_k (V_k^T M V_k = I)
  r:    the shared symmetric radial tridiagonal T_r = Q D Q^T

leaving a pointwise multiply by the pseudo-inverse of (D_a + lam_{m,k});
the Neumann nullspace's reciprocal is zeroed, callers re-normalize the
mean. The six transforms are plain matrix products (``torch.einsum``),
left to the BLAS library as the JAX package left them to XLA, in full
float32 on the card (the model disables TF32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry


def _conductance(geo: Geometry, d: int) -> np.ndarray:
    """A/dist at the full faces of axis d (wall faces zeroed)."""
    c = np.broadcast_to(
        np.asarray(geo.face_area[d]) / np.asarray(geo.face_dist[d]),
        geo.face_shape(d),
    ).copy()
    if not geo.axes[d].periodic:
        first = [slice(None)] * geo.dim
        first[d] = slice(0, 1)
        last = [slice(None)] * geo.dim
        last[d] = slice(-1, None)
        c[tuple(first)] = 0.0
        c[tuple(last)] = 0.0
    return c


def _mu(n: int, rfft: bool) -> np.ndarray:
    """Eigenvalues of the periodic [1, -2, 1] stencil: -4 sin^2(pi k/n)."""
    k = np.arange(n // 2 + 1 if rfft else n)
    return -4.0 * np.sin(np.pi * k / n) ** 2


def shell_lat_eigensystem(geo: Geometry):
    """(V, lam): per-lon-mode generalized lat eigentransforms
    S_k V = diag(cos) V Lambda, V^T diag(cos) V = I. Cached on the
    geometry. f64 numpy, shapes (nm, nlat, nlat), (nm, nlat)."""
    cached = geo.extras.get("_lat_eigensystem")
    if cached is not None:
        return cached
    nr, nlat, nlon = geo.cell_shape
    nm = nlon // 2 + 1
    b = _conductance(geo, 1)[:, :, 0].astype(np.float64)
    c = _conductance(geo, 2)[:, :, 0].astype(np.float64)
    cosl = np.cos(np.asarray(geo.axes[1].centers, np.float64))
    bl = b[0]                                   # (nlat+1,) pole-zeroed
    gl = c[0]                                   # (nlat,)
    mu = _mu(nlon, rfft=True)

    T = np.zeros((nlat, nlat))
    for j in range(nlat):
        T[j, j] = bl[j] + bl[j + 1]
        if j > 0:
            T[j, j - 1] = -bl[j]
        if j < nlat - 1:
            T[j, j + 1] = -bl[j + 1]
    Ms = 1.0 / np.sqrt(cosl)
    lam = np.zeros((nm, nlat))
    V = np.zeros((nm, nlat, nlat))
    for k in range(nm):
        Sh = Ms[:, None] * (T + np.diag(-gl * mu[k])) * Ms[None, :]
        w, W = np.linalg.eigh(0.5 * (Sh + Sh.T))
        lam[k] = w
        V[k] = Ms[:, None] * W                 # V^T diag(cos) V = I
    lam = np.maximum(lam, 0.0)
    geo.extras["_lat_eigensystem"] = (V, lam)
    return V, lam


class ShellPoissonFastDiag:
    """EXACT shell solve by full fast diagonalization (see module doc).

    ``precision`` is kept for the model's residual spot-check, whose
    tolerance table is keyed by it exactly as in the JAX package:
    "highest" and "high" compute the same full-precision transforms
    here; "high-refine" adds one refinement pass with ``refine_op`` (the
    exact stencil A = -weak_laplacian)."""

    def __init__(self, geo: Geometry, dtype=np.float32,
                 precision: str = "highest", refine_op=None,
                 device: Optional[torch.device] = None):
        if geo.kind != "shell":
            raise ValueError("ShellPoissonFastDiag needs shell geometry")
        if precision not in ("highest", "high", "high-refine"):
            raise ValueError(f"unknown poisson precision {precision!r}")
        if precision == "high-refine" and refine_op is None:
            raise ValueError("high-refine needs refine_op (the exact "
                             "stencil A = -weak_laplacian)")
        self.precision = precision
        self.refine_op = refine_op
        self.geo = geo
        nr, nlat, nlon = geo.cell_shape
        self.nm = nlon // 2 + 1
        nm = self.nm
        a = _conductance(geo, 0)[:, :, 0].astype(np.float64)
        cosl = np.cos(np.asarray(geo.axes[1].centers, np.float64))
        alpha = a[:, 0] / cosl[0]                  # (nr+1,)

        V, lam = shell_lat_eigensystem(geo)
        Tr = (np.diag(alpha[:-1] + alpha[1:])
              - np.diag(alpha[1:-1], 1) - np.diag(alpha[1:-1], -1))
        D, Q = np.linalg.eigh(0.5 * (Tr + Tr.T))    # Q orthogonal

        denom = D[:, None, None] + lam.T[None, :, :]   # (nr, nlat, nm)
        tiny = 1e-10 * float(denom.max())
        inv_denom = np.where(denom > tiny, 1.0 / np.maximum(denom, tiny), 0.0)

        ll = np.arange(nlon)
        kk = np.arange(nm)
        ang = 2.0 * np.pi * kk[:, None] * ll[None, :] / nlon
        F = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0)  # (2nm, nlon)
        G = np.linalg.pinv(F, rcond=1e-12)                       # (nlon, 2nm)

        f = lambda x: np.asarray(x, dtype=dtype)   # host constants
        self._F = f(F)
        self._G = f(G)
        self._V = f(V)
        self._Q = f(Q)
        self._inv_denom = f(inv_denom[:, :, None, :])  # (nr, nlat, 1, nm)
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "ShellPoissonFastDiag":
        """Move the transform constants to ``device`` (re-read after a
        caller edits the host arrays)."""
        t = lambda a: torch.as_tensor(a, device=device)
        self._t = {k: t(getattr(self, k))
                   for k in ("_F", "_G", "_V", "_Q", "_inv_denom")}
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def _transform_solve(self, bw: torch.Tensor) -> torch.Tensor:
        c = self._t
        nm = self.nm
        bh = torch.einsum("kl,ijl->ijk", c["_F"], bw)
        bs = torch.stack([bh[..., :nm], bh[..., nm:]], dim=2)  # (nr,j,2,k)
        yh = torch.einsum("kjm,ijsk->imsk", c["_V"], bs)
        zh = torch.einsum("ia,imsk->amsk", c["_Q"], yh)
        wh = zh * c["_inv_denom"]
        xh = torch.einsum("ia,amsk->imsk", c["_Q"], wh)
        xs = torch.einsum("kjm,imsk->ijsk", c["_V"], xh)
        xk = torch.cat([xs[:, :, 0, :], xs[:, :, 1, :]], dim=2)
        return torch.einsum("lk,ijk->ijl", c["_G"], xk)

    def solve(self, b: torch.Tensor):
        x = self._transform_solve(b)
        if self.precision == "high-refine":
            r = b - self.refine_op(x)
            x = x + self._transform_solve(r)
        return x, 0


def _uniform_radial(geo: Geometry) -> bool:
    dr = np.diff(np.asarray(geo.axes[0].faces))
    return bool(np.allclose(dr, dr[0], rtol=1e-12, atol=0.0))


def make_poisson_solver(geo: Geometry, dtype=np.float32,
                        precision: str = "highest", refine_op=None,
                        device=None):
    """The shell-uniform branch of the JAX package's factory; the other
    geometries and the non-uniform shell raise."""
    if geo.kind != "shell":
        raise NotImplementedError(
            f"{geo.kind} Poisson solvers are not ported yet (ROADMAP.md: "
            "annulus and cuboid geometries)")
    if not _uniform_radial(geo):
        raise NotImplementedError(
            "the non-uniform radial shell (ShellPoissonSpectral) is not "
            "ported yet (ROADMAP.md: remaining solvers, with K4)")
    return ShellPoissonFastDiag(geo, dtype=dtype, precision=precision,
                                refine_op=refine_op, device=device)
