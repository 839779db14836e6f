"""Solvers of the plain reference: frozen copies of the port's
Jacobi-Richardson solve (solvers/fixed.py), the Thomas recurrences
(solvers/tridiag.py, the plain version of K4), the operator diagonals
(ops/diagonal.py), and the fast-diagonalization Poisson and direct
Helmholtz solves of the shell and the annulus (solvers/spectral.py,
solvers/helmholtz.py), with K4 replaced by the plain recurrences.

Every matrix product goes through ``product``: with ``tf32`` its two
operands are first rounded to TF32 (10 explicit mantissa bits, nearest,
ties to even), which is what a float32 product on the card computes when
TF32 is allowed. That is the control of the benchmark's comparison; the
reference itself runs with ``tf32=False``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .bc import BC, BCSpec
from .grid import Geometry


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, nearest, ties
    to even; other dtypes are returned as they are."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def product(spec: str, a: torch.Tensor, b: torch.Tensor,
            tf32: bool) -> torch.Tensor:
    """torch.einsum(spec, a, b), the operands rounded to TF32 first when
    ``tf32``."""
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.einsum(spec, a, b)


# ----------------------------------------------------------------------
# fixed-iteration Jacobi-Richardson (solvers/fixed.py, solvers/cg.py _dot)
# ----------------------------------------------------------------------
class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor
    converged: torch.Tensor


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b), accumulated in float32 at the least."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.sum(a.to(acc) * b.to(acc))


def richardson_solve(operator: Callable[[torch.Tensor], torch.Tensor],
                     b: torch.Tensor, x0: torch.Tensor, *,
                     diag: torch.Tensor, iters: int,
                     rtol: float) -> SolveResult:
    """``iters`` Jacobi-Richardson steps on A x = b, the residual of the
    last iterate tracked exactly; converged when ||r|| <= rtol ||b||
    (rtol clamped to 16 eps of b's dtype)."""
    x = x0.to(b.dtype)
    eps = torch.finfo(b.dtype).eps
    rtol_eff = max(rtol, 16.0 * eps)
    r = b - operator(x)
    for _ in range(iters):
        dx = r / diag
        x = x + dx
        r = r - operator(dx)
    rnorm = torch.sqrt(dot(r, r))
    stop = rtol_eff * torch.sqrt(dot(b, b))
    return SolveResult(x=x, iterations=iters, residual_norm=rnorm,
                       converged=rnorm <= stop)


def cg(operator: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: torch.Tensor, *, rtol: float, maxiter: int,
       preconditioner: Callable[[torch.Tensor], torch.Tensor],
       divergence_factor: float = 32.0) -> SolveResult:
    """Preconditioned CG on A x = b (solvers/cg.py): the best iterate
    seen, converged when ||r|| <= rtol ||b|| (rtol clamped to 16 eps of
    b's dtype)."""
    x = x0.to(b.dtype)
    M = preconditioner
    rtol_eff = max(rtol, 16.0 * torch.finfo(b.dtype).eps)
    stop = rtol_eff * torch.sqrt(dot(b, b))
    r = b - operator(x)
    z = M(r)
    p = z
    rz = dot(r, z)
    rnorm = torch.sqrt(dot(r, r))
    x_best, rbest = x, rnorm
    k = 0
    while (k < maxiter and bool(rnorm > stop)
           and bool(rnorm < divergence_factor * rbest + stop)):
        Ap = operator(p)
        pAp = dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / pAp, torch.zeros_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        rnorm = torch.sqrt(dot(r, r))
        k += 1
        if bool(rnorm < rbest):
            x_best, rbest = x, rnorm
    return SolveResult(x=x_best, iterations=k, residual_norm=rbest,
                       converged=rbest <= stop)


# ----------------------------------------------------------------------
# Thomas recurrences (solvers/tridiag.py)
# ----------------------------------------------------------------------
def thomas_solve(lower: torch.Tensor, diag: torch.Tensor,
                 upper: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(lower, diag, upper) x = rhs along axis 0, batched
    over the trailing axes (``lower[0]``, ``upper[n-1]`` unused; no
    pivoting: the systems here are diagonally dominant)."""
    acc = torch.promote_types(torch.promote_types(diag.dtype, rhs.dtype),
                              torch.float32)
    lower, diag, upper, rhs = (a.to(acc) for a in (lower, diag, upper, rhs))
    n = rhs.shape[0]
    c_prev = torch.zeros_like(diag[0])
    g_prev = torch.zeros(torch.broadcast_shapes(diag[0].shape, rhs[0].shape),
                         dtype=acc, device=rhs.device)
    cs, gs = [], []
    for i in range(n):
        denom = diag[i] - lower[i] * c_prev
        c_prev = upper[i] / denom
        g_prev = (rhs[i] - lower[i] * g_prev) / denom
        cs.append(c_prev)
        gs.append(g_prev)
    x_next = torch.zeros_like(g_prev)
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        x_next = gs[i] - cs[i] * x_next
        xs[i] = x_next
    return torch.stack(xs)


# ----------------------------------------------------------------------
# operator diagonals (ops/diagonal.py)
# ----------------------------------------------------------------------
def _wall_factor(rule: BC) -> float:
    if rule == BC.NEUMANN:
        return 0.0
    if rule in (BC.DIRICHLET, BC.ANTISYM):
        return 2.0
    return 1.0      # pole rules couple to another cell


def weak_laplacian_diagonal(geo: Geometry,
                            specs: Sequence[Optional[BCSpec]]) -> np.ndarray:
    """diag(weak_laplacian) with the given BCs (cell-shaped, negative)."""
    diag = np.zeros(geo.cell_shape)
    for d in range(geo.dim):
        c = np.broadcast_to(
            np.asarray(geo.face_area[d]) / np.asarray(geo.face_dist[d]),
            geo.face_shape(d)).copy()
        if geo.axes[d].periodic:
            lo, hi = c, np.roll(c, -1, axis=d)
        else:
            spec = specs[d]
            sl_lo = [slice(None)] * geo.dim
            sl_lo[d] = slice(0, -1)
            sl_hi = [slice(None)] * geo.dim
            sl_hi[d] = slice(1, None)
            lo = c[tuple(sl_lo)].copy()
            hi = c[tuple(sl_hi)].copy()
            first = [slice(None)] * geo.dim
            first[d] = slice(0, 1)
            last = [slice(None)] * geo.dim
            last[d] = slice(-1, None)
            lo[tuple(first)] *= _wall_factor(spec.lo)
            hi[tuple(last)] *= _wall_factor(spec.hi)
        diag -= lo + hi
    return diag


# ----------------------------------------------------------------------
# fast diagonalization (solvers/spectral.py)
# ----------------------------------------------------------------------
def _conductance(geo: Geometry, d: int) -> np.ndarray:
    """A/dist at the full faces of axis d (wall faces zeroed)."""
    c = np.broadcast_to(
        np.asarray(geo.face_area[d]) / np.asarray(geo.face_dist[d]),
        geo.face_shape(d)).copy()
    if not geo.axes[d].periodic:
        first = [slice(None)] * geo.dim
        first[d] = slice(0, 1)
        last = [slice(None)] * geo.dim
        last[d] = slice(-1, None)
        c[tuple(first)] = 0.0
        c[tuple(last)] = 0.0
    return c


def _conductance_full(geo: Geometry, d: int) -> np.ndarray:
    """face_area/dist WITHOUT wall zeroing (walls couple to ghosts)."""
    return np.asarray(np.broadcast_to(
        np.asarray(geo.face_area[d], np.float64)
        / np.asarray(geo.face_dist[d], np.float64), geo.face_shape(d)))


def _mu(n: int) -> np.ndarray:
    """Eigenvalues of the periodic [1, -2, 1] stencil, rfft modes."""
    k = np.arange(n // 2 + 1)
    return -4.0 * np.sin(np.pi * k / n) ** 2


def shell_lat_eigensystem(geo: Geometry):
    """(V, lam): per-lon-mode generalized lat eigentransforms
    S_k V = diag(cos) V Lambda, V^T diag(cos) V = I (f64)."""
    nr, nlat, nlon = geo.cell_shape
    nm = nlon // 2 + 1
    bl = _conductance(geo, 1)[0, :, 0].astype(np.float64)
    gl = _conductance(geo, 2)[0, :, 0].astype(np.float64)
    cosl = np.cos(np.asarray(geo.axes[1].centers, np.float64))
    mu = _mu(nlon)
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
        V[k] = Ms[:, None] * W
    return V, np.maximum(lam, 0.0)


@functools.lru_cache(maxsize=4)
def real_dft_pair(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(F, G): the forward real-DFT matmul matrix (rows: Re, then -Im of
    the rfft) and its f64 pseudo-inverse, made once per n."""
    nm = n // 2 + 1
    ang = 2.0 * np.pi * np.arange(nm)[:, None] * np.arange(n)[None, :] / n
    F = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0)
    G = np.linalg.pinv(F, rcond=1e-12)
    F.setflags(write=False)
    G.setflags(write=False)
    return F, G


def _dev(arrays: dict, dtype: torch.dtype, device) -> dict:
    return {k: torch.as_tensor(np.array(a, order="C"), dtype=dtype,
                               device=device) for k, a in arrays.items()}


class ShellPoissonFastDiag:
    """-weak_laplacian(x) = b on the uniform shell: lon real DFT, per-mode
    lat eigentransform, radial eigentransform, divide."""

    def __init__(self, geo: Geometry, dtype: torch.dtype, device,
                 tf32: bool = False):
        self.tf32 = tf32
        nr, nlat, nlon = geo.cell_shape
        self.nm = nlon // 2 + 1
        a = _conductance(geo, 0)[:, :, 0].astype(np.float64)
        cosl = np.cos(np.asarray(geo.axes[1].centers, np.float64))
        alpha = a[:, 0] / cosl[0]
        V, lam = shell_lat_eigensystem(geo)
        Tr = (np.diag(alpha[:-1] + alpha[1:])
              - np.diag(alpha[1:-1], 1) - np.diag(alpha[1:-1], -1))
        D, Q = np.linalg.eigh(0.5 * (Tr + Tr.T))
        denom = D[:, None, None] + lam.T[None, :, :]
        tiny = 1e-10 * float(denom.max())
        inv_denom = np.where(denom > tiny, 1.0 / np.maximum(denom, tiny), 0.0)
        F, G = real_dft_pair(nlon)
        self.c = _dev(dict(F=F, G=G, V=V, Q=Q,
                           inv_denom=inv_denom[:, :, None, :]), dtype, device)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        c, nm, t = self.c, self.nm, self.tf32
        bh = product("kl,ijl->ijk", c["F"], b, t)
        bs = torch.stack([bh[..., :nm], bh[..., nm:]], dim=2)
        yh = product("kjm,ijsk->imsk", c["V"], bs, t)
        zh = product("ia,imsk->amsk", c["Q"], yh, t)
        wh = zh * c["inv_denom"]
        xh = product("ia,amsk->imsk", c["Q"], wh, t)
        xs = product("kjm,imsk->ijsk", c["V"], xh, t)
        xk = torch.cat([xs[:, :, 0, :], xs[:, :, 1, :]], dim=2)
        return product("lk,ijk->ijl", c["G"], xk, t)


class AnnulusPoissonFastDiag:
    """-weak_laplacian(x) = b on the annulus: phi real DFT, one
    generalized radial eigentransform for every mode, divide."""

    # the spot-check's residual amplification bound, in eps (as the port)
    check_amp = 1e6

    def __init__(self, geo: Geometry, dtype: torch.dtype, device,
                 tf32: bool = False):
        self.tf32 = tf32
        nr, nphi = geo.cell_shape
        ar = _conductance(geo, 0)[:, 0].astype(np.float64)
        cphi = _conductance(geo, 1)[:, 0].astype(np.float64)
        mu2 = np.concatenate([_mu(nphi)] * 2)
        Tr = (np.diag(ar[:-1] + ar[1:])
              - np.diag(ar[1:-1], 1) - np.diag(ar[1:-1], -1))
        Ms = 1.0 / np.sqrt(cphi)
        S = Ms[:, None] * Tr * Ms[None, :]
        lam, U = np.linalg.eigh(0.5 * (S + S.T))
        W = Ms[:, None] * U
        lam = np.maximum(lam, 0.0)
        denom = lam[:, None] - mu2[None, :]
        tiny = 1e-10 * float(denom.max())
        inv_denom = np.where(denom > tiny, 1.0 / np.maximum(denom, tiny), 0.0)
        F, G = real_dft_pair(nphi)
        self.c = _dev(dict(F=F, G=G, W=W, inv_denom=inv_denom), dtype, device)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        c, t = self.c, self.tf32
        h = product("kp,rp->rk", c["F"], b, t)
        h = product("ra,rk->ak", c["W"], h, t)
        h = h * c["inv_denom"]
        h = product("ra,ak->rk", c["W"], h, t)
        return product("pk,rk->rp", c["G"], h, t)


# ----------------------------------------------------------------------
# direct Helmholtz on the annulus (solvers/helmholtz.py)
# ----------------------------------------------------------------------
_WALL_W = {BC.NEUMANN: 0.0, BC.ANTISYM: 2.0, BC.DIRICHLET: 2.0}


def _radial_tridiag(alpha: np.ndarray, w_lo: float, w_hi: float):
    """(diag, lower, upper) of the 1D wall-aware operator from the face
    conductances alpha (n+1,), ghost coupling folded into diag."""
    n = alpha.shape[0] - 1
    diag = np.zeros(n)
    diag[:-1] += alpha[1:n]
    diag[1:] += alpha[1:n]
    diag[0] += w_lo * alpha[0]
    diag[-1] += w_hi * alpha[n]
    lower = np.concatenate([[0.0], -alpha[1:n]])
    upper = np.concatenate([-alpha[1:n], [0.0]])
    return diag, lower, upper


class AnnulusHelmholtzDirect:
    """(vol - c weak_laplacian) x_f = b_f for a stack of C fields: the phi
    real DFT, then per mode the radial tridiagonal
    diag(v) + c (T_r^bc - mu_k diag(c_phi)) by the Thomas recurrences."""

    def __init__(self, geo: Geometry, radial_specs: Sequence[BCSpec],
                 dtype: torch.dtype, device, tf32: bool = False):
        self.tf32 = tf32
        nr, nphi = geo.cell_shape
        alpha = _conductance_full(geo, 0)[:, 0]
        cphi = _conductance(geo, 1)[:, 0].astype(np.float64)
        v = np.broadcast_to(np.asarray(geo.vol, np.float64),
                            geo.cell_shape)[:, 0]
        mu2 = np.concatenate([_mu(nphi)] * 2)
        trd = np.zeros((len(radial_specs), nr))
        for cidx, spec in enumerate(radial_specs):
            d_, low, up = _radial_tridiag(alpha, _WALL_W[spec.lo],
                                          _WALL_W[spec.hi])
            trd[cidx] = d_
        F, G = real_dft_pair(nphi)
        self.c = _dev(dict(F=F, G=G, v=v[:, None, None],
                           trd=np.transpose(trd)[:, :, None],
                           shift=-cphi[:, None, None] * mu2[None, None, :],
                           low=low[:, None, None], up=up[:, None, None]),
                      dtype, device)

    def solve(self, b: torch.Tensor, coef: float) -> torch.Tensor:
        t = self.c
        bh = product("kp,crp->crk", t["F"], b, self.tf32)
        yt = torch.movedim(bh, 1, 0)
        diag = t["v"] + coef * (t["trd"] + t["shift"])
        xt = thomas_solve(coef * t["low"], diag, coef * t["up"], yt)
        xh = torch.movedim(xt, 0, 1)
        return product("pk,crk->crp", t["G"], xh, self.tf32)
