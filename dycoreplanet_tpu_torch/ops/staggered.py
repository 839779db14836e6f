"""Staggered C-grid (mimetic) operators of the FEEC personality, PyTorch.

Counterpart of the JAX package's ``ops/staggered.py``, operation for
operation: velocity lives as FACE-NORMAL components on a MAC lattice
(the structured-grid H(div) space), vorticity as EDGE circulations (the
H(curl) space), and pressure/temperature at cell centers (L2) — the
reference's exterior-calculus discretization (FE_Nedelec / FE_RaviartThomas
/ FE_DGQ, reference: boussineq_model_FEEC.tpp:21-30). The chain
identities of the discrete de Rham complex (ops/mimetic.py) then hold in
the dynamics: the projected faces are divergence-free to the Poisson
solve's accuracy, the projection never changes the discrete vorticity,
the Sadourny-averaged rotational advection is energy-neutral on the
uniform periodic cuboid, and the viscosity is the symmetric PSD Galerkin
product C^T M C, so the implicit solve is CG-clean.

Conventions
-----------
Two face layouts appear:
  * "cell-shaped" (the model-state layout, ops/stencil.py docstring):
    n entries per axis, entry i = LEFT face of cell i; hi-wall face
    implicit zero.
  * "full faces" (internal to this module): wall axes carry n+1 entries
    (both wall faces explicit), periodic axes n. All staggered algebra
    happens on full faces; `expand`/`contract` convert at the module
    boundary.

Edge fields along axis c are face-staggered in the other two axes and
cell-centered along c. The orientation is the cyclic index convention
in ARRAY axes; the (z, y, x) and (r, lat, lon) orderings are
left-handed, so the cyclic curl is minus the physical one (the model
sets q = -zeta_cyc + planetary term in 3D, models/mimetic.py).

The metrics are numpy float64 on the host (``StaggeredMetrics``), made
once, and cast once per (dtype, device) into a cache of tensors; no
operator copies anything to or from the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops.bc import BC, pad_axis


def _sl(f: torch.Tensor, d: int, idx) -> torch.Tensor:
    sl = [slice(None)] * f.ndim
    sl[d] = idx
    return f[tuple(sl)]


def _sl_np(x: np.ndarray, d: int, idx) -> np.ndarray:
    sl = [slice(None)] * x.ndim
    sl[d] = idx
    return np.asarray(x)[tuple(sl)]


class StaggeredMetrics:
    """Length elements of the orthogonal structured grids at arbitrary
    staggered positions (numpy float64, computed once).

    ``lam(d, stag, ext_axis)`` = physical length per cell step along
    axis ``d`` evaluated at the staggering combo ``stag`` ('c' = cell
    centers, 'f' = full faces per axis), optionally with one mirror
    ghost appended at each end of ``ext_axis``. Scale factors: cuboid
    s_d = 1; annulus s_phi = r; shell s_lat = r, s_lon = r cos(lat).
    ``dxi``: the coordinate spacings to take (a window of a grid takes
    the whole grid's, parallel/sharded_mimetic.py)."""

    def __init__(self, geo: Geometry, dxi: Optional[Sequence[float]] = None):
        self.geo = geo
        self.dim = geo.dim
        if dxi is not None:
            self.dxi = list(dxi)
            return
        # uniform coordinate spacing per axis (factory invariant)
        self.dxi = []
        for a in geo.axes:
            if a.periodic:
                self.dxi.append(float(a.faces[1] - a.faces[0])
                                if a.n > 1
                                else float(2 * (a.centers[0] - a.faces[0])))
            else:
                self.dxi.append(float(a.faces[1] - a.faces[0]))

    def coords(self, d: int, stag: str, ext: bool = False) -> np.ndarray:
        a = self.geo.axes[d]
        c = a.centers if stag == "c" else a.faces
        if ext:
            c = np.concatenate([[c[0] - self.dxi[d]], c,
                                [c[-1] + self.dxi[d]]])
        return np.asarray(c, dtype=np.float64)

    def _bshape(self, arr1d: np.ndarray, d: int) -> np.ndarray:
        shape = [1] * self.dim
        shape[d] = arr1d.shape[0]
        return arr1d.reshape(shape)

    def lam(self, d: int, stag: Sequence[str],
            ext_axis: Optional[int] = None) -> np.ndarray:
        """Length element along axis d at staggering ``stag`` (one
        'c'/'f' per axis), broadcast-shaped: only the axes the scale
        factor depends on have extent > 1."""
        kind = self.geo.kind
        dxi = self.dxi[d]
        if kind == "cuboid":
            # a constant metric broadcasts along a ghost-padded axis too
            return np.full((1,) * self.dim, dxi)
        if kind == "annulus":
            if d == 0:
                return np.full((1,) * self.dim, dxi)
            r = self.coords(0, stag[0], ext=(ext_axis == 0))
            return self._bshape(r * dxi, 0)
        if kind == "shell":
            if d == 0:
                return np.full((1,) * self.dim, dxi)
            r = self._bshape(self.coords(0, stag[0], ext=(ext_axis == 0)), 0)
            if d == 1:
                return r * dxi
            lat = self._bshape(self.coords(1, stag[1], ext=(ext_axis == 1)),
                               1)
            # |cos|: a ghost beyond a pole stands for the antipodal
            # interior cell, whose scale factor is cos of the mirrored
            # latitude (interior values are unchanged)
            return r * np.abs(np.cos(lat)) * dxi
        raise ValueError(kind)


class StaggeredOps:
    """Mimetic operator bundle for one geometry and velocity BC set.

    ``u_specs[c][d]`` is the ghost rule of velocity component c along
    axis d (the model's u_specs); ``scalar_specs[d]`` the pressure-like
    rule. The 3D and 2D cuboid, the annulus and the shell (its pole
    closure: the half-turn antipodal ghost rules, ``_gapply``). ``dxi``:
    StaggeredMetrics'."""

    def __init__(self, geo: Geometry, u_specs, scalar_specs,
                 dxi: Optional[Sequence[float]] = None):
        if geo.kind not in ("cuboid", "annulus", "shell"):
            raise NotImplementedError(geo.kind)
        if geo.kind == "shell" and geo.cell_shape[-1] % 2:
            # the half-turn roll is its own transpose for even nlon only
            raise ValueError("the staggered shell needs an even nlon, not "
                             f"{geo.cell_shape[-1]}")
        self.geo = geo
        self.dim = geo.dim
        self.u_specs = u_specs
        self.scalar_specs = scalar_specs
        self.m = StaggeredMetrics(geo, dxi)
        self._cache: Dict[tuple, torch.Tensor] = {}
        self._build_static()

    # ------------------------------------------------------------------
    # static metric arrays (numpy) and their tensors
    # ------------------------------------------------------------------
    def _full_stag(self, d: int) -> List[str]:
        s = ["c"] * self.dim
        s[d] = "f"
        return s

    def _edge_stag(self, c: int) -> List[str]:
        s = ["f"] * self.dim
        s[c] = "c"
        return s

    def _build_static(self) -> None:
        geo, m, dim = self.geo, self.m, self.dim
        # dual length across d-faces (full): lam_d at d='f'
        self.h_face = [m.lam(d, self._full_stag(d)) for d in range(dim)]
        # full-face areas (exact FV integrals from the geometry)
        self.area_face = [np.asarray(geo.face_area[d], dtype=np.float64)
                          for d in range(dim)]
        # face "volume" weight w = A * h (the H(div) mass weight)
        self.w_face = [self.area_face[d] * self.h_face[d] for d in range(dim)]
        if dim == 2:
            stag = ["f", "f"]
            self.A_edge = m.lam(0, stag) * m.lam(1, stag)  # dual-loop area
            self.l_edge = np.ones_like(self.A_edge)        # out-of-plane
            self.inv_A_edge = 1.0 / self.A_edge
            self.edge_w = self.l_edge / self.A_edge
            return
        self.A_edge, self.l_edge, self.inv_A_edge, self.edge_w = [], [], [], []
        for c in range(3):
            a, b = (c + 1) % 3, (c + 2) % 3
            stag = self._edge_stag(c)
            A = m.lam(a, stag) * m.lam(b, stag)
            L = m.lam(c, stag)
            self.A_edge.append(A)
            self.l_edge.append(L)
            # the shell's radial edges AT the pole faces have zero
            # dual-loop area: those degenerate loops carry zero vorticity
            # and zero viscous weight (dropping nonnegative terms keeps
            # the curl-curl form symmetric PSD)
            tol = 1e-12 * float(np.max(A))
            self.inv_A_edge.append(
                np.where(A > tol, 1.0 / np.maximum(A, tol), 0.0))
            self.edge_w.append(np.where(A > tol, L / np.maximum(A, tol), 0.0))

    def _t(self, key: tuple, make, like: torch.Tensor) -> torch.Tensor:
        """The static numpy array ``make()`` as a tensor in ``like``'s
        dtype and device, made once per (key, dtype, device)."""
        k = (key, like.dtype, like.device)
        t = self._cache.get(k)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(make()),
                                dtype=like.dtype, device=like.device)
            self._cache[k] = t
        return t

    def _lam_ext(self, d: int, ext_axis: int, like: torch.Tensor,
                 part: str = "all") -> torch.Tensor:
        """lam_d at d's full faces with ghosts along ``ext_axis`` (the
        weight of a padded face component): ``part`` 'all', 'core' (the
        ghosts stripped), 'lo' or 'hi' (one ghost entry)."""
        def make():
            lam = self.m.lam(d, self._full_stag(d), ext_axis=ext_axis)
            if part == "all" or lam.shape[ext_axis] == 1:
                return lam
            idx = {"core": slice(1, -1), "lo": slice(0, 1),
                   "hi": slice(-1, None)}[part]
            return _sl_np(lam, ext_axis, idx)
        return self._t(("lam_ext", d, ext_axis, part), make, like)

    # ------------------------------------------------------------------
    # layout conversion
    # ------------------------------------------------------------------
    def expand(self, uf_cell: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Cell-shaped faces -> full faces (wall axes gain the hi-wall
        entry = 0; the lo-wall entry is forced to 0)."""
        out = []
        for d in range(self.dim):
            x = uf_cell[d]
            if self.geo.axes[d].periodic:
                out.append(x)
                continue
            zero = torch.zeros_like(_sl(x, d, slice(0, 1)))
            out.append(torch.cat([zero, _sl(x, d, slice(1, None)), zero],
                                 dim=d))
        return out

    def contract(self, uf_full: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Full faces -> cell-shaped (drop the hi-wall entry; zero the
        lo-wall entry so pinned walls stay exact)."""
        out = []
        for d in range(self.dim):
            x = uf_full[d]
            if self.geo.axes[d].periodic:
                out.append(x)
                continue
            n = x.shape[d] - 1
            zero = torch.zeros_like(_sl(x, d, slice(0, 1)))
            out.append(torch.cat([zero, _sl(x, d, slice(1, n))], dim=d))
        return out

    # ------------------------------------------------------------------
    # staggered primitives (full-face convention)
    # ------------------------------------------------------------------
    def _c2f(self, x, d, spec, op, weight_ext=None):
        """Cell-staggered along d -> face-staggered (full) via a 2-point
        ``op`` on the ghost-padded array; an optional metric weight,
        ghost entries included, multiplies BEFORE the stencil."""
        per = self.geo.axes[d].periodic
        p = pad_axis(x, d, spec, per)
        if weight_ext is not None:
            if not torch.is_tensor(weight_ext):
                weight_ext = torch.as_tensor(np.asarray(weight_ext),
                                             dtype=x.dtype, device=x.device)
            p = p * weight_ext
        n = self.geo.axes[d].n
        nf = n if per else n + 1
        return op(_sl(p, d, slice(0, nf)), _sl(p, d, slice(1, nf + 1)))

    def avg_c2f(self, x, d, spec, weight_ext=None):
        return self._c2f(x, d, spec, lambda a, b: 0.5 * (a + b), weight_ext)

    def dcf(self, x, d, spec, weight_ext=None):
        """Backward difference cells -> full faces."""
        return self._c2f(x, d, spec, lambda a, b: b - a, weight_ext)

    def avg_f2c(self, x, d):
        if self.geo.axes[d].periodic:
            return 0.5 * (x + torch.roll(x, -1, dims=d))
        return 0.5 * (_sl(x, d, slice(0, -1)) + _sl(x, d, slice(1, None)))

    def dfc(self, x, d):
        """Forward difference full faces -> cells."""
        if self.geo.axes[d].periodic:
            return torch.roll(x, -1, dims=d) - x
        return _sl(x, d, slice(1, None)) - _sl(x, d, slice(0, -1))

    # ------------------------------------------------------------------
    # mimetic operators
    # ------------------------------------------------------------------
    def circulation(self, U: Sequence[torch.Tensor]):
        """Dual-loop circulations around edges (cyclic convention):
        3D: circ_c = d_a(lam_b u_b) - d_b(lam_a u_a); 2D: a scalar at
        nodes. Ghost values use the velocity wall rules, the metric
        evaluated at the true ghost positions."""
        like = U[0]
        if self.dim == 2:
            t1 = self.dcf(U[1], 0, self.u_specs[1][0],
                          weight_ext=self._lam_ext(1, 0, like))
            t2 = self.dcf(U[0], 1, self.u_specs[0][1],
                          weight_ext=self._lam_ext(0, 1, like))
            return t1 - t2
        out = []
        for c in range(3):
            a, b = (c + 1) % 3, (c + 2) % 3
            t1 = self.dcf(U[b], a, self.u_specs[b][a],
                          weight_ext=self._lam_ext(b, a, like))
            t2 = self.dcf(U[a], b, self.u_specs[a][b],
                          weight_ext=self._lam_ext(a, b, like))
            out.append(t1 - t2)
        return out

    def vorticity(self, U: Sequence[torch.Tensor]):
        """Physical edge vorticity in the cyclic convention:
        zeta_cyc = circulation / dual-loop area."""
        circ = self.circulation(U)
        if self.dim == 2:
            return circ * self._t(("inv_A_edge",), lambda: self.inv_A_edge,
                                  circ)
        return [circ[c] * self._t(("inv_A_edge", c),
                                  lambda c=c: self.inv_A_edge[c], circ[c])
                for c in range(3)]

    def cross(self, q, U: Sequence[torch.Tensor]):
        """Sadourny double-averaged cross product cross(q, u) at faces
        (cyclic convention): out_d = avg_b(q_a * avg_d(u_b))
                                   - avg_a(q_b * avg_d(u_a)).
        2D: out = (avg_phi(q * avg_r(u_phi)), -avg_r(q * avg_phi(u_r)))
        with scalar q at nodes."""
        if self.dim == 2:
            ub = self.avg_c2f(U[1], 0, self.u_specs[1][0])
            ua = self.avg_c2f(U[0], 1, self.u_specs[0][1])
            t0 = self.avg_f2c(q * ub, 1)
            t1 = -self.avg_f2c(q * ua, 0)
            return [t0, t1]
        out = []
        for d in range(3):
            a, b = (d + 1) % 3, (d + 2) % 3
            ub = self.avg_c2f(U[b], d, self.u_specs[b][d])   # at a-edges
            ua = self.avg_c2f(U[a], d, self.u_specs[a][d])   # at b-edges
            out.append(self.avg_f2c(q[a] * ub, b)
                       - self.avg_f2c(q[b] * ua, a))
        return out

    def kinetic_energy(self, U: Sequence[torch.Tensor]) -> torch.Tensor:
        """C-grid KE at cell centers: 0.5 sum_d avg_d(u_d^2)."""
        out = None
        for d in range(self.dim):
            t = self.avg_f2c(U[d] * U[d], d)
            out = t if out is None else out + t
        return 0.5 * out

    def grad_faces(self, f: torch.Tensor, specs) -> List[torch.Tensor]:
        """Scalar gradient at full faces: delta(f)/h."""
        return [self.dcf(f, d, specs[d])
                / self._t(("h_face", d), lambda d=d: self.h_face[d], f)
                for d in range(self.dim)]

    # -------------------- symmetric viscous operator -------------------
    def _gapply(self, rule, x):
        """The (self-adjoint) linear ghost operator of a wall rule on an
        edge slice: ghost = G(interior edge). ANTISYM/NEUMANN are
        -+identity; POLE/POLE_FLIP the (sign-flipped) half-turn
        longitude roll — its own transpose for even nlon, so the same
        operator serves the forward pad and the transpose foldback."""
        if rule == BC.ANTISYM:
            return -x
        if rule == BC.NEUMANN:
            return x
        if rule in (BC.POLE, BC.POLE_FLIP):
            half = self.geo.cell_shape[-1] // 2
            r = torch.roll(x, half, dims=-1)
            return -r if rule == BC.POLE_FLIP else r
        raise ValueError(f"unsupported wall rule for staggered ops: {rule}")

    def _dcf_transpose(self, x, d, spec):
        """Exact transpose of ``dcf`` (with its ghost extension) along a
        wall axis; periodic axes transpose to the wrapped backward
        difference. Maps full faces -> cells."""
        if self.geo.axes[d].periodic:
            return x - torch.roll(x, -1, dims=d)
        out = _sl(x, d, slice(0, -1)) - _sl(x, d, slice(1, None))
        # ghost foldback: dcf's lo face used ghost = G_lo(interior 0),
        # the hi face ghost = G_hi(interior n-1); G self-adjoint
        out.narrow(d, 0, 1).add_(
            -self._gapply(spec.lo, _sl(x, d, slice(0, 1))))
        out.narrow(d, out.shape[d] - 1, 1).add_(
            self._gapply(spec.hi, _sl(x, d, slice(-1, None))))
        return out

    def curlcurl_weighted(self, U: Sequence[torch.Tensor]):
        """The W-weighted symmetric viscous operator
        CC = (C E)^T diag(l/A) (C E): full-face input/output.
        <v, CC u> = sum_edges (l_e/A_e) circ_e(u) circ_e(v) >= 0, so
        W + nu*CC is SPD for the implicit momentum CG."""
        like = U[0]
        circ = self.circulation(U)
        if self.dim == 2:
            mu = circ * self._t(("edge_w",), lambda: self.edge_w, like)
            # circ = +dcf_0(lam1 u1) - dcf_1(lam0 u0)
            out1 = self._wtrans(mu, 0, self.u_specs[1][0], 1)
            out0 = -self._wtrans(mu, 1, self.u_specs[0][1], 0)
            return [out0, out1]
        out = [None] * 3
        for c in range(3):
            a, b = (c + 1) % 3, (c + 2) % 3
            mu = circ[c] * self._t(("edge_w", c),
                                   lambda c=c: self.edge_w[c], like)
            tb = self._wtrans(mu, a, self.u_specs[b][a], b)
            ta = -self._wtrans(mu, b, self.u_specs[a][b], a)
            out[b] = tb if out[b] is None else out[b] + tb
            out[a] = ta if out[a] is None else out[a] + ta
        return out

    def _wtrans(self, mu, d, spec, comp):
        """Transpose of x -> dcf(x, d, spec, weight_ext=lam_comp) (lam of
        component ``comp`` with ghosts along d): distributes an edge
        field back to the faces of the weighted component."""
        lam_core = self._lam_ext(comp, d, mu, "core")
        if self.geo.axes[d].periodic:
            return (mu - torch.roll(mu, -1, dims=d)) * lam_core
        core = _sl(mu, d, slice(0, -1)) - _sl(mu, d, slice(1, None))
        out = core * lam_core
        # the ghost-position metric is longitude-invariant, so it
        # commutes with the (self-adjoint) ghost operator G
        out.narrow(d, 0, 1).add_(-self._gapply(
            spec.lo, self._lam_ext(comp, d, mu, "lo")
            * _sl(mu, d, slice(0, 1))))
        out.narrow(d, out.shape[d] - 1, 1).add_(self._gapply(
            spec.hi, self._lam_ext(comp, d, mu, "hi")
            * _sl(mu, d, slice(-1, None))))
        return out

    # ------------------------------------------------------------------
    def curlcurl_diag(self) -> List[np.ndarray]:
        """Jacobi diagonal of ``curlcurl_weighted`` in the CELL-SHAPED
        face layout (interior stencil; wall ghost foldbacks ignored —
        preconditioner only). Broadcast-shaped numpy arrays."""
        dim = self.dim

        def pair_sum_f2c(x: np.ndarray, d: int) -> np.ndarray:
            """Sum of the two edge values adjacent to a face across
            axis d (full-face extent -> cell extent)."""
            if x.shape[d] == 1:
                return 2.0 * x
            if self.geo.axes[d].periodic:
                return x + np.roll(x, -1, axis=d)
            return _sl_np(x, d, slice(0, -1)) + _sl_np(x, d, slice(1, None))

        def to_cell(x: np.ndarray, d: int) -> np.ndarray:
            """Drop the hi-wall entry along the face axis d."""
            if x.shape[d] == 1 or self.geo.axes[d].periodic:
                return x
            return _sl_np(x, d, slice(0, -1))

        if dim == 2:
            mw = self.edge_w
            l1 = self.m.lam(1, self._full_stag(1))
            l0 = self.m.lam(0, self._full_stag(0))
            d1 = (l1 ** 2) * pair_sum_f2c(mw, 0)
            d0 = (l0 ** 2) * pair_sum_f2c(mw, 1)
            return [to_cell(d0, 0), to_cell(d1, 1)]
        out = [np.zeros((1,) * dim) for _ in range(3)]
        for c in range(3):
            a, b = (c + 1) % 3, (c + 2) % 3
            mw = self.edge_w[c]
            lam_b = self.m.lam(b, self._full_stag(b))
            lam_a = self.m.lam(a, self._full_stag(a))
            out[b] = out[b] + (lam_b ** 2) * pair_sum_f2c(mw, a)
            out[a] = out[a] + (lam_a ** 2) * pair_sum_f2c(mw, b)
        return [to_cell(out[d], d) for d in range(3)]

