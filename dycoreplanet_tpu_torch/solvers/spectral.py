"""Fast-diagonalization Poisson solves for the uniform-radius shell, the
annulus and the cuboid (PyTorch counterpart of the JAX package's
``solvers/spectral.py``).

Solves -weak_laplacian(x) = b with sum(b) = 0 by diagonalizing every
axis with dense transforms (host f64 setup, identical to the JAX
package's). Shell:

  lon:  real DFT as a matmul pair (F forward, its f64 pseudo-inverse G)
  lat:  per-lon-mode generalized eigentransform V_k (V_k^T M V_k = I)
  r:    the shared symmetric radial tridiagonal T_r = Q D Q^T

Annulus: the phi DFT pair and one generalized radial eigentransform W
(T_r W = diag(c_phi) W Lambda) shared by every phi mode. Cuboid: the y
and x real-DFT pairs (the operator's mode dependence is even in k, so
the cos / sin rows of an rfft diagonalize the periodic axes) and the z
wall tridiagonal T_z = Q D Q^T, or a third DFT pair when z is periodic
too; the 2D (z, x) slab drops the y pair.

What is left is a pointwise multiply by the pseudo-inverse of the
eigenvalue sums; the Neumann nullspace's reciprocal is zeroed, callers
re-normalize the mean. The transforms are plain matrix products
(``torch.einsum``), left to the BLAS library as the JAX package left
them to XLA, in full float32 on the card (the model disables TF32).

``CuboidPoissonDirect``, ``AnnulusPoissonDirect`` and
``ShellPoissonDirect`` are the direct solves that the JAX package keeps
and tests (``make_poisson_solver`` builds the fast diagonalizations): a
real FFT over the periodic axes (and on the shell the lat
eigentransform), then the tridiagonals along the wall axis of every mode
by the batched Thomas kernel K4 (ops/tridiag.py), the real and imaginary
parts as K4's pair axis, in one launch. ``ShellPoissonSpectral`` is the
factory's solve for a shell with non-uniform radial spacing, where the
radial conductances do not separate: CG over the lon modes (solvers/
cg.py) preconditioned by the exact radial lines, K4 once an iteration.

On a mesh (``make_sharded_poisson_solver``) each of the factory's
solves is a ``_ShardedFastDiag``: the shards' partial forward
transforms, one field-sized fixed-order sum, the middle (the divide, or
the spectral CG whole) once a distinct device, the local backward.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve
from dycoreplanet_tpu_torch.solvers.cg import cg


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


def _real_dft_pair(n: int, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(F, G): forward real-DFT matmul matrix (rows = Re then -Im of the
    rfft) and its f64 pseudo-inverse — an exact roundtrip pair."""
    F, G = _real_dft_pair64(n)
    return F.astype(dtype), G.astype(dtype)


@functools.lru_cache(maxsize=4)
def _real_dft_pair64(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """_real_dft_pair in f64, made once per n in a process: the
    pseudo-inverse of the (n + 2, n) matrix takes seconds at the
    thousands of phi points of a refined annulus, and a model builds up
    to three solvers on the same n."""
    nm = n // 2 + 1
    ll = np.arange(n)
    kk = np.arange(nm)
    ang = 2.0 * np.pi * kk[:, None] * ll[None, :] / n
    F = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0)
    G = np.linalg.pinv(F, rcond=1e-12)
    F.setflags(write=False)
    G.setflags(write=False)
    return F, G


def _t(a, device) -> torch.Tensor:
    """A host constant as a C-contiguous tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


class CuboidPoissonDirect:
    """Exact cuboid solve by an rfft2 over (y, x) and batched Thomas in z
    (the JAX ``CuboidPoissonDirect``, which calls its ``tridiag_solve``
    on the real and then the imaginary part). Here one call of K4
    (``tridiag``, a TridiagSolve) solves both: the rhs is
    ``torch.view_as_real`` of the (nz, ny, nx/2+1) transform, whose
    trailing axis of 2 K4 takes as its pair axis; diag is (nz, ny,
    nx/2+1, 1), broadcast along it, and lower and upper are one value a
    row, (nz, 1, 1, 1), broadcast across every column. No operand is
    copied. The (0, 0) mode's first cell is pinned (the nullspace's
    particular solution with x[0] = 0); callers re-normalize the mean."""

    precision = "highest"

    def __init__(self, geo: Geometry, dtype=np.float32,
                 tridiag: Optional[TridiagSolve] = None,
                 device: Optional[torch.device] = None):
        if geo.kind != "cuboid" or geo.dim != 3:
            raise ValueError("CuboidPoissonDirect needs the 3D cuboid")
        self.geo = geo
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        nz, ny, nx = geo.cell_shape
        az = _conductance(geo, 0)[:, 0, 0]          # (nz+1,)
        cy = float(_conductance(geo, 1)[0, 0, 0])
        cx = float(_conductance(geo, 2)[0, 0, 0])
        mu_y = _mu(ny, rfft=False)                   # (ny,)
        mu_x = _mu(nx, rfft=True)                    # (nx//2+1,)
        shift = -(cy * mu_y[:, None] + cx * mu_x[None, :])
        diag = (az[:-1] + az[1:])[:, None, None] + shift[None]
        diag[0, 0, 0] += az[1] if nz > 1 else 1.0
        f = lambda a: np.asarray(a, dtype=dtype)     # noqa: E731
        self._lower = f(-az[:-1, None, None, None])
        self._diag = f(diag[..., None])
        self._upper = f(-az[1:, None, None, None])
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "CuboidPoissonDirect":
        """Move the coefficients to ``device``."""
        self._tc = tuple(_t(a, device)
                         for a in (self._lower, self._diag, self._upper))
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def systems(self, b: torch.Tensor):
        """K4's operands (lower, diag, upper, rhs) for the solve of b:
        rhs is (nz, ny, nx/2+1, 2), the real and imaginary parts of
        b's rfft2 over (y, x)."""
        acc = torch.promote_types(b.dtype, torch.float32)
        bh = torch.fft.rfft2(b.to(acc), dim=(1, 2))
        return tuple(a.to(acc) for a in self._tc) + (torch.view_as_real(bh),)

    def solve(self, b: torch.Tensor):
        xh = self.tridiag(*self.systems(b))
        x = torch.fft.irfft2(torch.view_as_complex(xh), s=b.shape[1:],
                             dim=(1, 2))
        return x.to(b.dtype), 0


class AnnulusPoissonDirect:
    """Exact annulus solve by an rfft over phi and batched Thomas in r
    (the JAX ``AnnulusPoissonDirect``, which calls its ``tridiag_solve``
    on the real and then the imaginary part, with lower and upper
    materialized to (nr, nphi/2+1)). Here one call of K4 solves both:
    the rhs is ``torch.view_as_real`` of the (nr, nphi/2+1) transform,
    its trailing 2 the pair axis; diag is (nr, nphi/2+1, 1), and lower
    and upper one value a row, (nr, 1, 1): the radial conductances do
    not depend on phi. No operand is copied. The k = 0 mode's first cell
    is pinned; callers re-normalize the mean."""

    precision = "highest"

    def __init__(self, geo: Geometry, dtype=np.float32,
                 tridiag: Optional[TridiagSolve] = None,
                 device: Optional[torch.device] = None):
        if geo.kind != "annulus":
            raise ValueError("AnnulusPoissonDirect needs annulus geometry")
        self.geo = geo
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        nr, nphi = geo.cell_shape
        ar = _conductance(geo, 0)[:, 0]              # (nr+1,)
        cphi = _conductance(geo, 1)[:, 0]            # (nr,) = dr/(r dphi)
        mu = _mu(nphi, rfft=True)                    # (nphi//2+1,)
        diag = (ar[:-1] + ar[1:])[:, None] - cphi[:, None] * mu[None, :]
        diag[0, 0] += ar[1] if nr > 1 else 1.0       # pin k=0 mode
        f = lambda a: np.asarray(a, dtype=dtype)     # noqa: E731
        self._lower = f(-ar[:-1, None, None])
        self._diag = f(diag[..., None])
        self._upper = f(-ar[1:, None, None])
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "AnnulusPoissonDirect":
        """Move the coefficients to ``device``."""
        self._tc = tuple(_t(a, device)
                         for a in (self._lower, self._diag, self._upper))
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def systems(self, b: torch.Tensor):
        """K4's operands (lower, diag, upper, rhs) for the solve of b:
        rhs is (nr, nphi/2+1, 2), the real and imaginary parts of b's
        rfft over phi."""
        acc = torch.promote_types(b.dtype, torch.float32)
        bh = torch.fft.rfft(b.to(acc), dim=1)
        return tuple(a.to(acc) for a in self._tc) + (torch.view_as_real(bh),)

    def solve(self, b: torch.Tensor):
        xh = self.tridiag(*self.systems(b))
        x = torch.fft.irfft(torch.view_as_complex(xh), n=b.shape[1], dim=1)
        return x.to(b.dtype), 0


class CuboidPoissonFastDiag:
    """EXACT cuboid solve by full fast diagonalization: the y and x
    real-DFT pairs, the z wall eigentransform Q (or, on the fully
    periodic domain, a third real-DFT pair), and a pointwise multiply by
    the pseudo-inverse of D_z + shift_{ky,kx} (the Neumann nullspace's
    reciprocal zeroed)."""

    precision = "highest"

    def __init__(self, geo: Geometry, dtype=np.float32,
                 device: Optional[torch.device] = None):
        if geo.kind != "cuboid" or geo.dim != 3:
            raise ValueError("CuboidPoissonFastDiag needs the 3D cuboid")
        self.geo = geo
        nz, ny, nx = geo.cell_shape
        cy = float(_conductance(geo, 1)[0, 0, 0])
        cx = float(_conductance(geo, 2)[0, 0, 0])
        mu_y2 = np.concatenate([_mu(ny, rfft=True)] * 2)
        mu_x2 = np.concatenate([_mu(nx, rfft=True)] * 2)
        f = lambda a: np.asarray(a, dtype=dtype)     # noqa: E731
        self._Q = self._Fz = self._Gz = None
        if geo.axes[0].periodic:
            # fully periodic: z diagonalizes in the same real-DFT basis
            cz = float(_conductance(geo, 0)[0, 0, 0])
            D = -cz * np.concatenate([_mu(nz, rfft=True)] * 2)
            self._Fz, self._Gz = map(f, _real_dft_pair(nz, np.float64))
        else:
            az = _conductance(geo, 0)[:, 0, 0].astype(np.float64)
            Tz = (np.diag(az[:-1] + az[1:])
                  - np.diag(az[1:-1], 1) - np.diag(az[1:-1], -1))
            D, Q = np.linalg.eigh(0.5 * (Tz + Tz.T))
            self._Q = f(Q)
        shift = -(cy * mu_y2[:, None] + cx * mu_x2[None, :])
        denom = D[:, None, None] + shift[None]
        tiny = 1e-10 * float(denom.max())
        inv_denom = np.where(denom > tiny, 1.0 / np.maximum(denom, tiny), 0.0)
        self._Fy, self._Gy = map(f, _real_dft_pair(ny, np.float64))
        self._Fx, self._Gx = map(f, _real_dft_pair(nx, np.float64))
        self._inv_denom = f(inv_denom)
        self.to(device if device is not None else torch.device("cpu"))

    _NAMES = ("_Fy", "_Gy", "_Fx", "_Gx", "_Q", "_Fz", "_Gz", "_inv_denom")

    def to(self, device) -> "CuboidPoissonFastDiag":
        """Move the transform constants to ``device``."""
        self._t = {k: _t(getattr(self, k), device) for k in self._NAMES
                   if getattr(self, k) is not None}
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def solve(self, b: torch.Tensor):
        acc = torch.promote_types(b.dtype, torch.float32)
        c = {k: a.to(acc) for k, a in self._t.items()}
        h = torch.einsum("ky,zyx->zkx", c["_Fy"], b.to(acc))
        h = torch.einsum("kx,zyx->zyk", c["_Fx"], h)
        if self._Q is not None:
            h = torch.einsum("za,zyx->ayx", c["_Q"], h)
            h = h * c["_inv_denom"]
            h = torch.einsum("za,ayx->zyx", c["_Q"], h)
        else:
            h = torch.einsum("az,zyx->ayx", c["_Fz"], h)
            h = h * c["_inv_denom"]
            h = torch.einsum("za,ayx->zyx", c["_Gz"], h)
        h = torch.einsum("xk,zyk->zyx", c["_Gx"], h)
        x = torch.einsum("yk,zkx->zyx", c["_Gy"], h)
        return x.to(b.dtype), 0


class Cuboid2DPoissonFastDiag:
    """EXACT solve on the 2D (z, x) slab (the reference's dim=2 cuboid,
    planet_geometry.tpp:29-57): the x real-DFT pair and the z wall
    eigentransform."""

    precision = "highest"

    def __init__(self, geo: Geometry, dtype=np.float32,
                 device: Optional[torch.device] = None):
        if geo.kind != "cuboid" or geo.dim != 2:
            raise ValueError("Cuboid2DPoissonFastDiag needs the 2D cuboid")
        self.geo = geo
        nz, nx = geo.cell_shape
        cx = float(_conductance(geo, 1)[0, 0])
        mu_x2 = np.concatenate([_mu(nx, rfft=True)] * 2)
        az = _conductance(geo, 0)[:, 0].astype(np.float64)     # (nz+1,)
        Tz = (np.diag(az[:-1] + az[1:])
              - np.diag(az[1:-1], 1) - np.diag(az[1:-1], -1))
        D, Q = np.linalg.eigh(0.5 * (Tz + Tz.T))
        denom = D[:, None] - cx * mu_x2[None, :]               # (nz, 2nmx)
        tiny = 1e-10 * float(denom.max())
        inv = np.where(denom > tiny, 1.0 / np.maximum(denom, tiny), 0.0)
        f = lambda a: np.asarray(a, dtype=dtype)     # noqa: E731
        self._Fx, self._Gx = map(f, _real_dft_pair(nx, np.float64))
        self._Q, self._inv = f(Q), f(inv)
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "Cuboid2DPoissonFastDiag":
        """Move the transform constants to ``device``."""
        self._t = {k: _t(getattr(self, k), device)
                   for k in ("_Fx", "_Gx", "_Q", "_inv")}
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def solve(self, b: torch.Tensor):
        acc = torch.promote_types(b.dtype, torch.float32)
        c = {k: a.to(acc) for k, a in self._t.items()}
        h = torch.einsum("kx,zx->zk", c["_Fx"], b.to(acc))
        h = torch.einsum("za,zk->ak", c["_Q"], h)
        h = h * c["_inv"]
        h = torch.einsum("za,ak->zk", c["_Q"], h)
        x = torch.einsum("xk,zk->zx", c["_Gx"], h)
        return x.to(b.dtype), 0


class ShellPoissonSpectral:
    """Shell solve by an rfft over lon and CG over every lon mode at
    once, preconditioned by the exact radial lines (the JAX
    ``ShellPoissonSpectral``): the solve for a shell whose radial spacing
    is not uniform, where the fast diagonalization does not apply.

    The operator of mode k (real coefficients, the real and imaginary
    parts stacked on the last axis, (nr, nlat, 2 nm)):
      (A_k x)_ij = (a_i + a_i+1 + b_j + b_j+1 - c_ij mu_k) x_ij
                   - a_i x_i-1,j - a_i+1 x_i+1,j - b_j x_i,j-1 - b_j+1 x_i,j+1
    a = A_r/dist_r, b = A_lat/dist_lat (zero at the poles), c =
    A_lon/dist_lon; the k = 0 real mode's constant nullvector is
    deflated to the eigenvalue sigma = mean(diag). The preconditioner
    solves the radial tridiagonals of every (lat, mode) column by K4
    (``tridiag``): diag (nr, nlat, 2 nm) and the rhs as they are, lower
    and upper the radial conductances as (nr, nlat, 1) broadcasts (the
    JAX code materializes them); two column axes, no pair axis (lower
    varies along lat), no copy. K4 runs once before CG's loop and once
    an iteration. ``solve`` returns CG's iteration count; it reads CG's
    stopping test back every iteration (``iterative``), so a model that
    solves with it runs no CUDA graph."""

    precision = "highest"
    iterative = True

    def __init__(self, geo: Geometry, dtype=np.float32, rtol: float = 1e-7,
                 maxiter: int = 120, tridiag: Optional[TridiagSolve] = None,
                 device: Optional[torch.device] = None):
        if geo.kind != "shell":
            raise ValueError("ShellPoissonSpectral needs shell geometry")
        self.geo = geo
        self.rtol = rtol
        self.maxiter = maxiter
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        nr, nlat, nlon = geo.cell_shape
        self.nm = nlon // 2 + 1
        a = _conductance(geo, 0)[:, :, 0]            # (nr+1, nlat)
        bb = _conductance(geo, 1)[:, :, 0]           # (nr, nlat+1)
        c = _conductance(geo, 2)[:, :, 0]            # (nr, nlat)
        mu2 = np.concatenate([_mu(nlon, rfft=True)] * 2)   # re + im
        f = lambda x: np.asarray(x, dtype=dtype)     # noqa: E731
        self._a_lo = f(a[:-1, :, None])              # (nr, nlat, 1)
        self._a_hi = f(a[1:, :, None])
        self._b_lo = f(bb[:, :-1, None])
        self._b_hi = f(bb[:, 1:, None])
        diag = (a[:-1] + a[1:] + bb[:, :-1] + bb[:, 1:])[:, :, None] \
            - c[:, :, None] * mu2[None, None, :]
        self._diag = f(diag)                         # (nr, nlat, 2nm)
        # k = 0 real-mode deflation: sigma (1 1^T)/N on that slice
        self._sigma = float(diag.mean())
        self._defl_scale = self._sigma / (nr * nlat)
        self.to(device if device is not None else torch.device("cpu"))

    _NAMES = ("_a_lo", "_a_hi", "_b_lo", "_b_hi", "_diag")

    def to(self, device) -> "ShellPoissonSpectral":
        """Move the coefficients to ``device``."""
        self._t = {k: _t(getattr(self, k), device) for k in self._NAMES}
        self._t["_p_lower"] = -self._t["_a_lo"]
        self._t["_p_upper"] = -self._t["_a_hi"]
        return self

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x in spectral space; x: (nr, nlat, 2nm)."""
        c = self._t
        z = torch.zeros_like
        ax = c["_diag"] * x
        ax = ax - c["_a_lo"] * torch.cat([z(x[:1]), x[:-1]], dim=0)
        ax = ax - c["_a_hi"] * torch.cat([x[1:], z(x[:1])], dim=0)
        ax = ax - c["_b_lo"] * torch.cat([z(x[:, :1]), x[:, :-1]], dim=1)
        ax = ax - c["_b_hi"] * torch.cat([x[:, 1:], z(x[:, :1])], dim=1)
        ax[:, :, 0] += self._defl_scale * torch.sum(x[:, :, 0])
        return ax

    def line_operands(self, r: torch.Tensor):
        """K4's operands (lower, diag, upper, rhs) of the preconditioner
        on r, (nr, nlat, 2nm)."""
        c = self._t
        return c["_p_lower"], c["_diag"], c["_p_upper"], r

    def _line_precond(self, r: torch.Tensor) -> torch.Tensor:
        return self.tridiag(*self.line_operands(r))

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def solve(self, b: torch.Tensor):
        nlon = self.geo.cell_shape[2]
        acc = torch.promote_types(b.dtype, torch.float32)
        bh = torch.fft.rfft(b.to(acc), dim=2)
        bs = torch.cat([bh.real, bh.imag], dim=2)
        res = cg(self._apply, bs, rtol=self.rtol, maxiter=self.maxiter,
                 preconditioner=self._line_precond)
        nm = self.nm
        xh = torch.complex(res.x[:, :, :nm], res.x[:, :, nm:])
        x = torch.fft.irfft(xh, n=nlon, dim=2)
        return x.to(b.dtype), res.iterations


class ShellPoissonDirect:
    """Exact shell solve (the JAX ``ShellPoissonDirect``): rfft over lon,
    the generalized lat eigentransform of each lon mode, batched Thomas
    in r, and the inverse transforms. With uniform radial spacing the
    radial conductances separate, a_ij = alpha_i cos_j, so each (mode,
    lat eigenvector) is one radial tridiagonal. The eigentransforms are
    matrix products (``torch.einsum``), as the JAX package computes them
    outside any Pallas kernel; the tridiagonals are one K4 launch
    (``tridiag``): the rhs (nr, nlat, 2, nm) with the real and imaginary
    parts on axis 2, K4's pair axis; diag (nr, nlat, 1, nm); lower and
    upper one value a row, (nr, 1, 1, 1). No operand is copied."""

    precision = "highest"

    def __init__(self, geo: Geometry, dtype=np.float32,
                 tridiag: Optional[TridiagSolve] = None,
                 device: Optional[torch.device] = None):
        if geo.kind != "shell":
            raise ValueError("ShellPoissonDirect needs shell geometry")
        self.geo = geo
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        nr, nlat, nlon = geo.cell_shape
        self.nm = nlon // 2 + 1
        a = _conductance(geo, 0)[:, :, 0].astype(np.float64)
        cosl = np.cos(np.asarray(geo.axes[1].centers, np.float64))
        alpha = a[:, 0] / cosl[0]                  # (nr+1,)
        V, lam = shell_lat_eigensystem(geo)
        diag = ((alpha[:-1] + alpha[1:])[:, None, None]
                + np.transpose(lam)[None, :, :])   # (nr, nlat_m, nm)
        # nullspace pin (k = 0 constant mode): ground the first radial cell
        m0 = int(np.argmin(lam[0]))
        diag[0, m0, 0] += alpha[1] if nr > 1 else 1.0
        f = lambda x: np.asarray(x, dtype=dtype)   # noqa: E731
        self._V = f(V)
        self._lower = f(-alpha[:-1, None, None, None])
        self._upper = f(-alpha[1:, None, None, None])
        self._diag = f(diag[:, :, None, :])        # (nr, m, 1, nm)
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "ShellPoissonDirect":
        """Move the transforms and coefficients to ``device``."""
        self._Vt = _t(self._V, device)
        self._tc = tuple(_t(a, device)
                         for a in (self._lower, self._diag, self._upper))
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def systems(self, b: torch.Tensor):
        """K4's operands (lower, diag, upper, rhs) for the solve of b:
        rhs is (nr, nlat, 2, nm), the lat eigentransform of the real and
        imaginary parts of b's rfft over lon."""
        acc = torch.promote_types(b.dtype, torch.float32)
        bh = torch.fft.rfft(b.to(acc), dim=2)
        bs = torch.stack([bh.real, bh.imag], dim=2)          # (nr, j, 2, k)
        yh = torch.einsum("kjm,ijsk->imsk", self._Vt.to(acc), bs)
        return tuple(a.to(acc) for a in self._tc) + (yh,)

    def solve(self, b: torch.Tensor):
        nlon = self.geo.cell_shape[2]
        low, diag, up, yh = self.systems(b)
        xh = self.tridiag(low, diag, up, yh)
        xs = torch.einsum("kjm,imsk->ijsk", self._Vt.to(yh.dtype), xh)
        x = torch.fft.irfft(torch.complex(xs[:, :, 0, :], xs[:, :, 1, :]),
                            n=nlon, dim=2)
        return x.to(b.dtype), 0


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

        F, G = _real_dft_pair(nlon, np.float64)   # (2nm, nlon), (nlon, 2nm)

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
        # under a bfloat16 state the solve runs in float32 and casts back
        acc = torch.promote_types(b.dtype, torch.float32)
        bw = b.to(acc)
        x = self._transform_solve(bw)
        if self.precision == "high-refine":
            r = bw - self.refine_op(x).to(acc)
            x = x + self._transform_solve(r)
        return x.to(b.dtype), 0


class AnnulusPoissonFastDiag:
    """EXACT annulus solve by fast diagonalization. The radial operator
    depends on the phi mode, A_k = T_r - mu_k diag(c_phi) with c_phi(r)
    = dr/(r dphi); the generalized symmetric eigenproblem T_r W =
    diag(c_phi) W Lambda (W^T diag(c_phi) W = I, host f64 via the
    C^{-1/2} similarity) gives A_k^{-1} = W (Lambda - mu_k)^{-1} W^T for
    every mode at once: one (nr x nr) matmul pair around a pointwise
    multiply, between the phi DFT pair.

    ``check_amp``: the residual amplification bound that the model's
    Poisson spot-check takes (1e6 eps), as in the JAX package: the
    generalized eigentransforms leave a relative residual of ~3.5e3 eps
    at production aspect in f32 (working-precision conditioning, not a
    solver defect)."""

    precision = "highest"
    check_amp = 1e6

    def __init__(self, geo: Geometry, dtype=np.float32,
                 device: Optional[torch.device] = None):
        if geo.kind != "annulus":
            raise ValueError("AnnulusPoissonFastDiag needs annulus geometry")
        self.geo = geo
        nr, nphi = geo.cell_shape
        ar = _conductance(geo, 0)[:, 0].astype(np.float64)    # (nr+1,)
        cphi = _conductance(geo, 1)[:, 0].astype(np.float64)  # (nr,)
        mu = _mu(nphi, rfft=True)                             # (nm,) <= 0
        mu2 = np.concatenate([mu, mu])                        # re+im stack

        Tr = (np.diag(ar[:-1] + ar[1:])
              - np.diag(ar[1:-1], 1) - np.diag(ar[1:-1], -1))
        Ms = 1.0 / np.sqrt(cphi)
        S = Ms[:, None] * Tr * Ms[None, :]
        lam, U = np.linalg.eigh(0.5 * (S + S.T))
        W = Ms[:, None] * U                                   # W^T C W = I
        lam = np.maximum(lam, 0.0)

        denom = lam[:, None] - mu2[None, :]                   # (nr, 2nm)
        tiny = 1e-10 * float(denom.max())
        inv_denom = np.where(denom > tiny, 1.0 / np.maximum(denom, tiny), 0.0)

        F, G = _real_dft_pair(nphi, np.float64)
        f = lambda a: np.asarray(a, dtype=dtype)              # host constants
        self._F, self._G = f(F), f(G)
        self._W = f(W)
        self._inv_denom = f(inv_denom)
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "AnnulusPoissonFastDiag":
        """Move the transform constants to ``device`` (re-read after a
        caller edits the host arrays)."""
        self._t = {k: torch.as_tensor(getattr(self, k), device=device)
                   for k in ("_F", "_G", "_W", "_inv_denom")}
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.solve(b)[0]

    def solve(self, b: torch.Tensor):
        c = self._t
        h = torch.einsum("kp,rp->rk", c["_F"], b.to(c["_F"].dtype))
        h = torch.einsum("ra,rk->ak", c["_W"], h)
        h = h * c["_inv_denom"]
        h = torch.einsum("ra,ak->rk", c["_W"], h)
        return torch.einsum("pk,rk->rp", c["_G"], h).to(b.dtype), 0


class _ShardedFastDiag:
    """A fast diagonalization on its geometry's mesh (parallel/mesh.py),
    whose only collective is one field-sized sum a solve: each shard
    contracts its own rows and columns of the forward transforms of the
    sharded axes (``_forward``), and a fixed-order sum of the shards'
    partials (``halo.psum``) completes them. The eigen-space work
    (``_middle``: the transforms of the unsharded axes and the divide,
    or a direct Helmholtz solve's radial systems, or a whole CG) gives
    the same result on every shard; it runs once for each distinct
    device of the mesh, not once a shard (on one card the shards would
    repeat it). The backward transforms (``_backward``) are local: each
    shard applies its own rows of the inverse transforms. ``precision``
    is the base solver's (the model's spot-check tolerance), and so is
    ``check_amp`` where it has one. A subclass names the base's host
    arrays it cuts (``_cuts``: name -> the axis of the array that runs
    over the sharded axis -2 or -1 of the cells, as "rows" / "cols", or
    None for a replicated array); a shard's constants also hold its
    block's offsets (``"_at"``: (j0, k0))."""

    _cuts: dict = {}

    def __init__(self, base, mesh):
        from dycoreplanet_tpu_torch.parallel.mesh import local_shape, offsets

        self.geo = base.geo
        self.mesh = mesh
        self.precision = getattr(base, "precision", None)
        if hasattr(base, "check_amp"):
            self.check_amp = base.check_amp
        nl, no = local_shape(base.geo, mesh)[-2:]
        self._offsets = offsets(base.geo, mesh)
        self._span = {"rows": nl, "cols": no}
        self._host = {k: getattr(base, k) for k in self._cuts
                      if getattr(base, k, None) is not None}
        self._dev = {}

    def __call__(self, b):
        """The solve as a preconditioner (the escalated Poisson CG's)."""
        return self.solve(b)[0]

    def _consts(self, a: int, b: int, dev) -> dict:
        """The base's arrays on dev, each cut to shard (a, b)'s rows or
        columns along its axis that runs over them (made once)."""
        key = (a, b, str(dev))
        c = self._dev.get(key)
        if c is None:
            j0, k0 = self._offsets[a, b]
            c = {"_at": (j0, k0)}
            for name, x in self._host.items():
                cut = self._cuts[name]
                if cut is not None:
                    ax, which = cut
                    start = j0 if which == "rows" else k0
                    x = np.take(x, np.arange(start, start
                                             + self._span[which]), axis=ax)
                c[name] = torch.as_tensor(np.array(x, order="C"),
                                          device=dev)
            self._dev[key] = c
        return c

    def solve(self, rhs):
        return self._solve(rhs)

    def _middle_count(self, c, h, *args):
        """The middle and its iteration count (0: a direct middle)."""
        return self._middle(c, h, *args), 0

    def _solve(self, rhs, *args):
        """(x, the middle's iteration count): the shards' forward
        partials, THE solver all-reduce, the middle (``args``: a
        Helmholtz solve's coefficient) once a distinct device of this
        process (once a rank on a process mesh: the same bits on every
        rank, as the sum is), the local backward."""
        from dycoreplanet_tpu_torch.parallel.halo import psum
        from dycoreplanet_tpu_torch.parallel.mesh import build

        mesh = self.mesh
        part = build(mesh, lambda a, b: self._forward(
            self._consts(a, b, mesh.device(a, b)), rhs[a, b]))
        full = psum(part, mesh)                  # THE solver all-reduce
        mine = mesh.local_shards()[0]
        mid = {dev: self._middle_count(self._consts(*mine, dev), h, *args)
               for dev, h in full.items()}
        x = build(mesh, lambda a, b: self._backward(
            self._consts(a, b, mesh.device(a, b)),
            mid[mesh.device(a, b)][0]).to(rhs[a, b].dtype))
        return x, mid[mesh.own_device][1]


class ShardedShellPoissonFastDiag(_ShardedFastDiag):
    """ShellPoissonFastDiag on a ("lat", "lon") mesh (the JAX class,
    spectral.py:697-780): each shard contracts its own lon columns of F
    and lat rows of V; the radial transform and the divide are the
    eigen-space work; each shard applies its own rows of V and G. The
    "high-refine" pass needs the global operator and is not run here."""

    _cuts = {"_F": (1, "cols"), "_G": (0, "cols"), "_V": (1, "rows"),
             "_Q": None, "_inv_denom": None}

    def __init__(self, base: ShellPoissonFastDiag, mesh):
        super().__init__(base, mesh)
        self.nm = base.nm

    def _forward(self, c, x):
        nm = self.nm
        bh = torch.einsum("kl,ijl->ijk", c["_F"], x.to(c["_F"].dtype))
        bs = torch.stack([bh[..., :nm], bh[..., nm:]], dim=2)
        return torch.einsum("kjm,ijsk->imsk", c["_V"], bs)

    def _middle(self, c, y):
        zh = torch.einsum("ia,imsk->amsk", c["_Q"], y)
        return torch.einsum("ia,amsk->imsk", c["_Q"], zh * c["_inv_denom"])

    def _backward(self, c, xh):
        xs = torch.einsum("kjm,imsk->ijsk", c["_V"], xh)
        xk = torch.cat([xs[:, :, 0, :], xs[:, :, 1, :]], dim=2)
        return torch.einsum("lk,ijk->ijl", c["_G"], xk)


class ShardedAnnulusPoissonFastDiag(_ShardedFastDiag):
    """AnnulusPoissonFastDiag on a ("phi",) mesh: each shard contracts its
    own phi columns of the DFT F; the radial eigentransform W and the
    divide are the eigen-space work (the constant mode's zero
    eigenvalue has its reciprocal zeroed in the base's table); each
    shard applies its own rows of the inverse G."""

    _cuts = {"_F": (1, "cols"), "_G": (0, "cols"), "_W": None,
             "_inv_denom": None}

    def _forward(self, c, x):
        return torch.einsum("kp,rp->rk", c["_F"], x.to(c["_F"].dtype))

    def _middle(self, c, h):
        h = torch.einsum("ra,rk->ak", c["_W"], h) * c["_inv_denom"]
        return torch.einsum("ra,ak->rk", c["_W"], h)

    def _backward(self, c, h):
        return torch.einsum("pk,rk->rp", c["_G"], h)


class ShardedCuboidPoissonFastDiag(_ShardedFastDiag):
    """CuboidPoissonFastDiag on a ("y", "x") mesh: each shard contracts
    its own y rows of F_y and x columns of F_x; the z transform (the wall
    eigentransform Q, or on the fully periodic box the DFT pair) and the
    divide are the eigen-space work; each shard applies its own rows of
    G_x and G_y."""

    _cuts = {"_Fy": (1, "rows"), "_Gy": (0, "rows"), "_Fx": (1, "cols"),
             "_Gx": (0, "cols"), "_Q": None, "_Fz": None, "_Gz": None,
             "_inv_denom": None}

    def _forward(self, c, x):
        h = torch.einsum("ky,zyx->zkx", c["_Fy"], x.to(c["_Fy"].dtype))
        return torch.einsum("kx,zyx->zyk", c["_Fx"], h)

    def _middle(self, c, h):
        if "_Q" in c:
            h = torch.einsum("za,zyx->ayx", c["_Q"], h) * c["_inv_denom"]
            return torch.einsum("za,ayx->zyx", c["_Q"], h)
        h = torch.einsum("az,zyx->ayx", c["_Fz"], h) * c["_inv_denom"]
        return torch.einsum("za,ayx->zyx", c["_Gz"], h)

    def _backward(self, c, h):
        h = torch.einsum("xk,zyk->zyx", c["_Gx"], h)
        return torch.einsum("yk,zkx->zyx", c["_Gy"], h)


class ShardedCuboid2DPoissonFastDiag(_ShardedFastDiag):
    """Cuboid2DPoissonFastDiag on an ("x",) mesh: each shard contracts its
    own x columns of F_x; the z eigentransform and the divide are the
    eigen-space work; each shard applies its own rows of G_x."""

    _cuts = {"_Fx": (1, "cols"), "_Gx": (0, "cols"), "_Q": None,
             "_inv": None}

    def _forward(self, c, x):
        return torch.einsum("kx,zx->zk", c["_Fx"], x.to(c["_Fx"].dtype))

    def _middle(self, c, h):
        h = torch.einsum("za,zk->ak", c["_Q"], h) * c["_inv"]
        return torch.einsum("za,ak->zk", c["_Q"], h)

    def _backward(self, c, h):
        return torch.einsum("xk,zk->zx", c["_Gx"], h)


class ShardedShellPoissonSpectral(_ShardedFastDiag):
    """ShellPoissonSpectral on a ("lat", "lon") mesh. The lon rfft
    cannot run along a sharded axis, so the lon real DFT is the matmul
    pair ``_real_dft_pair`` (the annulus's phi on its mesh): each shard
    contracts its own lon columns of F and places the result in its own
    lat rows of a zero (nr, nlat, 2 nm) field, and the one field-sized
    sum completes the transform. The middle is the whole CG over every
    lon mode with K4 as its line preconditioner (the base's operator and
    radial lines, on each distinct device), once a device; the backward
    is each shard's own lat rows through its own columns of G. ``solve``
    returns the CG's count, as the base does; ``iterative``, ``rtol`` and
    ``maxiter`` are the base's. The order of the DFT's sums is not the
    FFT's, which can move the count by one on a right-hand side at the
    CG's knife edge (ROADMAP.md Queue 3)."""

    _cuts = {"_F": (1, "cols"), "_G": (0, "cols")}
    iterative = True

    def __init__(self, base: ShellPoissonSpectral, mesh):
        super().__init__(base, mesh)
        nr, nlat, nlon = base.geo.cell_shape
        F, G = _real_dft_pair(nlon, base._diag.dtype)
        self._host.update(_F=F, _G=G)
        self.base = base
        self.rtol, self.maxiter = base.rtol, base.maxiter
        self.tridiag = base.tridiag
        self._full = (nr, nlat, 2 * base.nm)
        self._nl = self._span["rows"]
        self._on = {}

    def _solver(self, dev) -> ShellPoissonSpectral:
        """The base's operator and radial lines on ``dev`` (made once):
        the base itself on its own device."""
        s = self._on.get(str(dev))
        if s is None:
            s = (self.base if self.base._t["_diag"].device == dev
                 else copy.copy(self.base).to(dev))
            self._on[str(dev)] = s
        return s

    def _forward(self, c, x):
        j0 = c["_at"][0]
        bh = torch.einsum("kl,ijl->ijk", c["_F"], x.to(c["_F"].dtype))
        out = bh.new_zeros(self._full)
        out[:, j0:j0 + self._nl] = bh
        return out

    def _middle_count(self, c, h):
        s = self._solver(h.device)
        res = cg(s._apply, h, rtol=self.rtol, maxiter=self.maxiter,
                 preconditioner=s._line_precond)
        return res.x, res.iterations

    def _backward(self, c, xh):
        j0 = c["_at"][0]
        return torch.einsum("lk,ijk->ijl", c["_G"],
                            xh[:, j0:j0 + self._nl])


def make_sharded_poisson_solver(base, mesh):
    """The sharded form of ``make_poisson_solver``'s product (a fast
    diagonalization, or the stretched shell's spectral CG) on the
    geometry's mesh."""
    for single, sharded in (
            (ShellPoissonFastDiag, ShardedShellPoissonFastDiag),
            (AnnulusPoissonFastDiag, ShardedAnnulusPoissonFastDiag),
            (CuboidPoissonFastDiag, ShardedCuboidPoissonFastDiag),
            (Cuboid2DPoissonFastDiag, ShardedCuboid2DPoissonFastDiag),
            (ShellPoissonSpectral, ShardedShellPoissonSpectral)):
        if type(base) is single:
            return sharded(base, mesh)
    raise ValueError(f"no sharded form of {type(base).__name__}")


def _uniform_radial(geo: Geometry) -> bool:
    dr = np.diff(np.asarray(geo.axes[0].faces))
    return bool(np.allclose(dr, dr[0], rtol=1e-12, atol=0.0))


def make_poisson_solver(geo: Geometry, dtype=np.float32,
                        precision: str = "highest", refine_op=None,
                        device=None, tridiag: Optional[TridiagSolve] = None,
                        **kw):
    """The JAX package's factory: the fast diagonalizations on the
    cuboid, the annulus and the uniform-radius shell; on a shell with
    non-uniform radial spacing ``ShellPoissonSpectral`` (``kw``: its
    ``rtol`` and ``maxiter``), its radial lines on ``tridiag``."""
    if geo.kind == "cuboid":
        if geo.dim == 2:
            return Cuboid2DPoissonFastDiag(geo, dtype=dtype, device=device)
        return CuboidPoissonFastDiag(geo, dtype=dtype, device=device)
    if geo.kind == "annulus":
        return AnnulusPoissonFastDiag(geo, dtype=dtype, device=device)
    if geo.kind != "shell":
        raise ValueError(f"unknown geometry kind {geo.kind!r}")
    if _uniform_radial(geo):
        return ShellPoissonFastDiag(geo, dtype=dtype, precision=precision,
                                    refine_op=refine_op, device=device)
    return ShellPoissonSpectral(geo, dtype=dtype, tridiag=tridiag,
                                device=device, **kw)
