"""Direct (non-iterative) Helmholtz solvers for the shell, the annulus
and the 3D cuboid: (vol - c * weak_laplacian) x = b, the counterpart of
the JAX package's ``solvers/helmholtz.py`` (``ShellHelmholtzDirect``,
``AnnulusHelmholtzDirect``, ``CuboidHelmholtzDirect``).

The momentum and temperature systems share the pressure operator's
separable structure on the uniform-radius shell: vol_ij = v_i cos_j and
the radial conductance a_ij = alpha_i cos_j, so per longitude mode the
lat generalized eigentransform of the pressure operator (pole faces
have zero area for every field) reduces the operator to independent
radial tridiagonals  diag(v) + c (T_r^bc + lam I)  — solved by the
batched Thomas kernel K4 (ops/tridiag.py).

Only the radial wall rule distinguishes the fields: NEUMANN walls add
nothing, ANTISYM/DIRICHLET walls add 2*alpha_wall to the boundary
diagonal. Inhomogeneous Dirichlet values are the caller's affine offset,
as in the CG path. On the annulus the phi DFT alone leaves, per phi
mode, the radial tridiagonal diag(v) + c (T_r^bc - mu_k diag(c_phi)),
solved by K4 in the JAX solver's layout. On the cuboid the cell volume
is constant, so the y and x real-DFT pairs and a z eigentransform a
field diagonalize the operator fully: no tridiagonal is left, and no
K4. Host setup is f64 numpy, identical to the JAX package's; the
per-mode transforms are plain matrix products (``torch.einsum``) in
full precision (the model disables TF32), and
``c`` enters only on the device side, so one solver serves every dt.

On a mesh (``make_sharded_helmholtz_solver``) each solve is the sharded
fast diagonalization's shape (solvers/spectral.py ``_ShardedFastDiag``):
each shard contracts its own rows and columns of the transforms of the
sharded axes, one field-sized fixed-order sum completes them, the
middle (the radial systems through K4, in one device's layout, or on
the box the z transform and the divide) runs once a distinct device,
and each shard applies its own rows of the inverse transforms.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve
from dycoreplanet_tpu_torch.solvers.spectral import (
    _conductance, _mu, _real_dft_pair, _ShardedFastDiag, _uniform_radial,
    shell_lat_eigensystem)

# wall-rule weight on the boundary diagonal of the 1D operator
_WALL_W = {BC.NEUMANN: 0.0, BC.ANTISYM: 2.0, BC.DIRICHLET: 2.0}


def _rules_of(spec: Optional[BCSpec]) -> Tuple[float, float]:
    if spec is None:
        raise ValueError("wall axis needs a BCSpec")
    try:
        return _WALL_W[spec.lo], _WALL_W[spec.hi]
    except KeyError as e:  # pole rules etc. are not wall rules
        raise ValueError(f"unsupported radial wall rule {e}") from None


def _conductance_full(geo: Geometry, d: int) -> np.ndarray:
    """face_area/dist WITHOUT wall zeroing (walls couple to ghosts)."""
    return np.asarray(
        np.broadcast_to(
            np.asarray(geo.face_area[d], np.float64)
            / np.asarray(geo.face_dist[d], np.float64),
            geo.face_shape(d),
        )
    )


def _radial_tridiag(alpha: np.ndarray, w_lo: float, w_hi: float):
    """1D wall-aware operator pieces from face conductances alpha
    (n+1,): returns (diag (n,), lower (n,), upper (n,)) of T^bc with
    lower[0] = upper[-1] = 0 (ghost coupling folded into diag)."""
    n = alpha.shape[0] - 1
    diag = np.zeros(n)
    diag[:-1] += alpha[1:n]
    diag[1:] += alpha[1:n]
    diag[0] += w_lo * alpha[0]
    diag[-1] += w_hi * alpha[n]
    lower = np.concatenate([[0.0], -alpha[1:n]])
    upper = np.concatenate([-alpha[1:n], [0.0]])
    return diag, lower, upper


class ShellHelmholtzDirect:
    """Exact shell solve of (vol - c*weak_laplacian) x_f = b_f for a
    stack of fields with per-field radial wall rules. ``tridiag`` is the
    K4 wrapper (shared by a model's solvers, so one launch count)."""

    def __init__(self, geo: Geometry, radial_specs: Sequence[BCSpec],
                 dtype=np.float32, tridiag: Optional[TridiagSolve] = None,
                 device: Optional[torch.device] = None):
        if geo.kind != "shell" or not _uniform_radial(geo):
            raise ValueError("ShellHelmholtzDirect needs the uniform-radius "
                             "shell")
        self.geo = geo
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        nr, nlat, nlon = geo.cell_shape
        self.nm = nlon // 2 + 1
        nc = len(radial_specs)

        cosl = np.cos(np.asarray(geo.axes[1].centers, np.float64))
        j0 = int(np.argmax(cosl))
        a = _conductance_full(geo, 0)[:, :, 0]
        alpha = a[:, j0] / cosl[j0]                    # (nr+1,)
        volf = np.broadcast_to(np.asarray(geo.vol, np.float64),
                               geo.cell_shape)[:, :, 0]
        v = volf[:, j0] / cosl[j0]                     # (nr,)

        V, lam = shell_lat_eigensystem(geo)
        F, G = _real_dft_pair(nlon, np.float64)

        trd = np.zeros((nc, nr))
        low = up = None
        for cidx, spec in enumerate(radial_specs):
            w_lo, w_hi = _rules_of(spec)
            d_, l_, u_ = _radial_tridiag(alpha, w_lo, w_hi)
            trd[cidx] = d_
            low, up = l_, u_                           # field-independent

        f = lambda x: np.asarray(x, dtype=dtype)       # host constants
        self._F, self._G = f(F), f(G)
        self._V = f(V)
        # Thomas layout: (nr, C, m, s, k); see solve()
        self._v = f(v[:, None, None, None, None])
        self._trd = f(np.transpose(trd)[:, :, None, None, None])
        self._lam = f(np.transpose(lam)[None, None, :, None, :])
        self._low = f(low[:, None, None, None, None])
        self._up = f(up[:, None, None, None, None])
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "ShellHelmholtzDirect":
        """Move the constants to ``device``."""
        # C-contiguous, so that diag (formed from them) is too
        self._t = {k: torch.as_tensor(np.ascontiguousarray(getattr(self, k)),
                                      device=device)
                   for k in ("_F", "_G", "_V", "_v", "_trd", "_lam", "_low",
                             "_up")}
        return self

    def _consts(self, dtype):
        acc = torch.promote_types(dtype, torch.float32)
        return acc, {k: a.to(acc) for k, a in self._t.items()}

    def systems(self, b: torch.Tensor, c: float):
        """The radial tridiagonal systems of the solve, (lower, diag,
        upper, rhs): rhs is (nr, C, nlat, 2, nlon/2+1), the coefficients
        broadcast against it. b: (C, nr, nlat, nlon); c: the scalar
        coefficient (dt/Re or dt_T/Pe, rounded to the working dtype by
        the caller)."""
        nm = self.nm
        acc, t = self._consts(b.dtype)
        bh = torch.einsum("kl,cijl->cijk", t["_F"], b.to(acc))
        bs = torch.stack([bh[..., :nm], bh[..., nm:]], dim=3)  # (C,i,j,s,k)
        # Thomas order (nr, C, m, s, k), C-contiguous so that K4 solves
        # along axis 0 with the batch flattened in C order (one copy)
        yt = torch.einsum("kjm,cijsk->icmsk", t["_V"], bs).contiguous()
        diag = t["_v"] + c * (t["_trd"] + t["_lam"])   # (nr, C, m, 1, k)
        return c * t["_low"], diag, c * t["_up"], yt

    def solve(self, b: torch.Tensor, c: float) -> torch.Tensor:
        """x with (vol - c weak_laplacian) x = b, per field of b."""
        _, t = self._consts(b.dtype)
        xt = self.tridiag(*self.systems(b, c))
        xs = torch.einsum("kjm,icmsk->cijsk", t["_V"], xt)
        xk = torch.cat([xs[:, :, :, 0, :], xs[:, :, :, 1, :]], dim=3)
        x = torch.einsum("lk,cijk->cijl", t["_G"], xk)
        return x.to(b.dtype).contiguous()


class AnnulusHelmholtzDirect:
    """Exact annulus solve of (vol - c*weak_laplacian) x_f = b_f for a
    stack of C fields: the phi real DFT as a matmul pair, then per mode
    the radial tridiagonal diag(v) + c (T_r^bc - mu_k diag(c_phi)),
    solved by K4 (``tridiag``, shared by a model's solvers) in the JAX
    solver's Thomas layout: systems along nr, columns (C, 2nm) with the
    real and imaginary parts side by side along the last axis."""

    def __init__(self, geo: Geometry, radial_specs: Sequence[BCSpec],
                 dtype=np.float32, tridiag: Optional[TridiagSolve] = None,
                 device: Optional[torch.device] = None):
        if geo.kind != "annulus":
            raise ValueError("AnnulusHelmholtzDirect needs the annulus")
        self.geo = geo
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        nr, nphi = geo.cell_shape
        self.nm = nphi // 2 + 1
        nc = len(radial_specs)

        alpha = _conductance_full(geo, 0)[:, 0]        # (nr+1,)
        cphi = _conductance(geo, 1)[:, 0].astype(np.float64)  # (nr,)
        v = np.broadcast_to(np.asarray(geo.vol, np.float64),
                            geo.cell_shape)[:, 0]      # (nr,)
        mu2 = np.concatenate([_mu(nphi, rfft=True)] * 2)  # (2nm,)

        trd = np.zeros((nc, nr))
        low = up = None
        for cidx, spec in enumerate(radial_specs):
            w_lo, w_hi = _rules_of(spec)
            d_, l_, u_ = _radial_tridiag(alpha, w_lo, w_hi)
            trd[cidx] = d_
            low, up = l_, u_                           # field-independent

        F, G = _real_dft_pair(nphi, np.float64)
        f = lambda x: np.asarray(x, dtype=dtype)       # host constants
        self._F, self._G = f(F), f(G)
        # Thomas layout: (nr, C, 2nm)
        self._v = f(v[:, None, None])
        self._trd = f(np.transpose(trd)[:, :, None])
        self._shift = f(-cphi[:, None, None] * mu2[None, None, :])
        self._low = f(low[:, None, None])
        self._up = f(up[:, None, None])
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "AnnulusHelmholtzDirect":
        """Move the constants to ``device`` (copies: ``_v`` is a view of
        the geometry's read-only broadcast volume)."""
        self._t = {k: torch.as_tensor(np.array(getattr(self, k), order="C"),
                                      device=device)
                   for k in ("_F", "_G", "_v", "_trd", "_shift", "_low",
                             "_up")}
        return self

    def _consts(self, dtype):
        acc = torch.promote_types(dtype, torch.float32)
        return acc, {k: a.to(acc) for k, a in self._t.items()}

    def systems(self, b: torch.Tensor, c: float):
        """The radial tridiagonal systems of the solve, (lower, diag,
        upper, rhs) as K4 takes them: lower and upper (nr, 1, 1), diag
        (nr, C, 2nm) and rhs a (nr, C, 2nm) view of the transformed b,
        whose memory is (C, nr, 2nm). b: (C, nr, nphi); c: the scalar
        coefficient (rounded to the working dtype by the caller)."""
        acc, t = self._consts(b.dtype)
        bh = torch.einsum("kp,crp->crk", t["_F"], b.to(acc))
        yt = torch.movedim(bh, 1, 0)                   # (nr, C, 2nm)
        diag = t["_v"] + c * (t["_trd"] + t["_shift"])
        return c * t["_low"], diag, c * t["_up"], yt

    def solve(self, b: torch.Tensor, c: float) -> torch.Tensor:
        """x with (vol - c weak_laplacian) x = b, per field of b."""
        _, t = self._consts(b.dtype)
        xt = self.tridiag(*self.systems(b, c))
        xh = torch.movedim(xt, 0, 1)                   # (C, nr, 2nm)
        x = torch.einsum("pk,crk->crp", t["_G"], xh)
        return x.to(b.dtype).contiguous()


class CuboidHelmholtzDirect:
    """Exact cuboid solve of (vol - c*weak_laplacian) x_f = b_f by full
    fast diagonalization (vol constant): the y and x real-DFT pairs and
    a z eigentransform a field (its wall rules), the denominators vol +
    c (D_z^bc + shift_{ky,kx}) formed on the device, so one solver serves
    every c. Matrix products only (the JAX solver's einsums); no K4."""

    def __init__(self, geo: Geometry, z_specs: Sequence[BCSpec],
                 dtype=np.float32, device: Optional[torch.device] = None):
        if geo.kind != "cuboid" or geo.dim != 3:
            raise ValueError("CuboidHelmholtzDirect needs the 3D cuboid")
        self.geo = geo
        nz, ny, nx = geo.cell_shape
        vol = np.broadcast_to(np.asarray(geo.vol, np.float64), geo.cell_shape)
        if not np.allclose(vol, vol.flat[0]):
            raise ValueError(
                "cuboid direct Helmholtz requires uniform cell volume")
        self._vol = float(vol.flat[0])

        alpha = _conductance_full(geo, 0)[:, 0, 0]     # (nz+1,)
        cy = float(_conductance(geo, 1)[0, 0, 0])
        cx = float(_conductance(geo, 2)[0, 0, 0])
        mu_y2 = np.concatenate([_mu(ny, rfft=True)] * 2)
        mu_x2 = np.concatenate([_mu(nx, rfft=True)] * 2)
        shift = -(cy * mu_y2[:, None] + cx * mu_x2[None, :])  # (2nmy,2nmx)

        nc = len(z_specs)
        Q = np.zeros((nc, nz, nz))
        D = np.zeros((nc, nz))
        for cidx, spec in enumerate(z_specs):
            w_lo, w_hi = _rules_of(spec)
            d_, l_, u_ = _radial_tridiag(alpha, w_lo, w_hi)
            Tz = np.diag(d_) + np.diag(l_[1:], -1) + np.diag(u_[:-1], 1)
            w, W = np.linalg.eigh(0.5 * (Tz + Tz.T))
            Q[cidx] = W
            D[cidx] = np.maximum(w, 0.0)

        f = lambda x: np.asarray(x, dtype=dtype)       # noqa: E731
        self._Fy, self._Gy = map(f, _real_dft_pair(ny, np.float64))
        self._Fx, self._Gx = map(f, _real_dft_pair(nx, np.float64))
        self._Q = f(Q)
        self._denomK = f(D[:, :, None, None] + shift[None, None])
        self.to(device if device is not None else torch.device("cpu"))

    def to(self, device) -> "CuboidHelmholtzDirect":
        """Move the constants to ``device``."""
        self._t = {k: torch.as_tensor(np.ascontiguousarray(getattr(self, k)),
                                      device=device)
                   for k in ("_Fy", "_Gy", "_Fx", "_Gx", "_Q", "_denomK")}
        return self

    def solve(self, b: torch.Tensor, c: float) -> torch.Tensor:
        """x with (vol - c weak_laplacian) x = b, per field of b: (C, nz,
        ny, nx); c: the scalar coefficient (rounded to the working dtype
        by the caller)."""
        acc = torch.promote_types(b.dtype, torch.float32)
        t = {k: a.to(acc) for k, a in self._t.items()}
        h = torch.einsum("ky,czyx->czkx", t["_Fy"], b.to(acc))
        h = torch.einsum("kx,czyx->czyk", t["_Fx"], h)
        h = torch.einsum("cza,czyx->cayx", t["_Q"], h)
        h = h / (self._vol + c * t["_denomK"])
        h = torch.einsum("cza,cayx->czyx", t["_Q"], h)
        h = torch.einsum("xk,czyk->czyx", t["_Gx"], h)
        x = torch.einsum("yk,czkx->czyx", t["_Gy"], h)
        return x.to(b.dtype)


class ShardedShellHelmholtzDirect(_ShardedFastDiag):
    """ShellHelmholtzDirect on a ("lat", "lon") mesh: each shard contracts
    its own lon columns of F and lat rows of V, the sum completes the
    transformed right-hand side in one device's Thomas layout (nr, C, m,
    s, k), K4 solves the radial systems v + c (trd + lam) (their
    per-field wall rules) once a device, and each shard applies its own
    rows of V and columns of G. ``solve(b, c)`` as the base's."""

    _cuts = {"_F": (1, "cols"), "_G": (0, "cols"), "_V": (1, "rows"),
             "_v": None, "_trd": None, "_lam": None, "_low": None,
             "_up": None}

    def __init__(self, base: ShellHelmholtzDirect, mesh):
        super().__init__(base, mesh)
        self.nm = base.nm
        self.tridiag = base.tridiag

    def solve(self, b, c: float):
        return self._solve(b, c)[0]

    def _forward(self, t, x):
        nm = self.nm
        bh = torch.einsum("kl,cijl->cijk", t["_F"], x.to(t["_F"].dtype))
        bs = torch.stack([bh[..., :nm], bh[..., nm:]], dim=3)
        return torch.einsum("kjm,cijsk->icmsk", t["_V"], bs).contiguous()

    def _middle(self, t, yt, c):
        diag = t["_v"] + c * (t["_trd"] + t["_lam"])
        return self.tridiag(c * t["_low"], diag, c * t["_up"], yt)

    def _backward(self, t, xt):
        xs = torch.einsum("kjm,icmsk->cijsk", t["_V"], xt)
        xk = torch.cat([xs[:, :, :, 0, :], xs[:, :, :, 1, :]], dim=3)
        return torch.einsum("lk,cijk->cijl", t["_G"], xk).contiguous()


class ShardedAnnulusHelmholtzDirect(_ShardedFastDiag):
    """AnnulusHelmholtzDirect on a ("phi",) mesh (a 1 x B grid): each
    shard contracts its own phi columns of F, the sum completes the
    (C, nr, 2nm) transform, K4 solves the radial systems in one device's
    layout (its (nr, C, 2nm) view) once a device, and each shard applies
    its own rows of G."""

    _cuts = {"_F": (1, "cols"), "_G": (0, "cols"), "_v": None,
             "_trd": None, "_shift": None, "_low": None, "_up": None}

    def __init__(self, base: AnnulusHelmholtzDirect, mesh):
        super().__init__(base, mesh)
        self.tridiag = base.tridiag

    def solve(self, b, c: float):
        return self._solve(b, c)[0]

    def _forward(self, t, x):
        return torch.einsum("kp,crp->crk", t["_F"],
                            x.to(t["_F"].dtype)).contiguous()

    def _middle(self, t, h, c):
        diag = t["_v"] + c * (t["_trd"] + t["_shift"])
        return self.tridiag(c * t["_low"], diag, c * t["_up"],
                            torch.movedim(h, 1, 0))

    def _backward(self, t, xt):
        return torch.einsum("pk,crk->crp", t["_G"],
                            torch.movedim(xt, 0, 1)).contiguous()


class ShardedCuboidHelmholtzDirect(_ShardedFastDiag):
    """CuboidHelmholtzDirect on a ("y", "x") mesh: each shard contracts
    its own y rows of F_y and x columns of F_x; the z eigentransforms and
    the divide by vol + c denomK are the middle, once a device (matrix
    products only, no K4, as on one device); each shard applies its own
    rows of G_x and G_y."""

    _cuts = {"_Fy": (1, "rows"), "_Gy": (0, "rows"), "_Fx": (1, "cols"),
             "_Gx": (0, "cols"), "_Q": None, "_denomK": None}

    def __init__(self, base: CuboidHelmholtzDirect, mesh):
        super().__init__(base, mesh)
        self._vol = base._vol

    def solve(self, b, c: float):
        return self._solve(b, c)[0]

    def _forward(self, t, x):
        h = torch.einsum("ky,czyx->czkx", t["_Fy"], x.to(t["_Fy"].dtype))
        return torch.einsum("kx,czyx->czyk", t["_Fx"], h)

    def _middle(self, t, h, c):
        h = torch.einsum("cza,czyx->cayx", t["_Q"], h)
        h = h / (self._vol + c * t["_denomK"])
        return torch.einsum("cza,cayx->czyx", t["_Q"], h)

    def _backward(self, t, h):
        h = torch.einsum("xk,czyk->czyx", t["_Gx"], h)
        return torch.einsum("yk,czkx->czyx", t["_Gy"], h)


def make_sharded_helmholtz_solver(base, mesh):
    """The sharded form of ``make_helmholtz_solver``'s product on the
    geometry's mesh."""
    for single, sharded in (
            (ShellHelmholtzDirect, ShardedShellHelmholtzDirect),
            (AnnulusHelmholtzDirect, ShardedAnnulusHelmholtzDirect),
            (CuboidHelmholtzDirect, ShardedCuboidHelmholtzDirect)):
        if type(base) is single:
            return sharded(base, mesh)
    raise ValueError(f"no sharded form of {type(base).__name__}")


def make_helmholtz_solver(geo: Geometry, wall_specs: Sequence[BCSpec],
                          dtype=np.float32,
                          tridiag: Optional[TridiagSolve] = None,
                          device=None):
    """Direct Helmholtz solver for a stack of fields whose radial (z) wall
    BCSpecs are ``wall_specs``; None where the JAX package has none: the
    2D slab and the shell with non-uniform radii."""
    if geo.kind == "cuboid":
        if geo.dim != 3:
            return None
        return CuboidHelmholtzDirect(geo, wall_specs, dtype=dtype,
                                     device=device)
    if geo.kind == "annulus":
        return AnnulusHelmholtzDirect(geo, wall_specs, dtype=dtype,
                                      tridiag=tridiag, device=device)
    if geo.kind != "shell":
        raise ValueError(f"unknown geometry kind {geo.kind!r}")
    if not _uniform_radial(geo):
        return None
    return ShellHelmholtzDirect(geo, wall_specs, dtype=dtype,
                                tridiag=tridiag, device=device)
