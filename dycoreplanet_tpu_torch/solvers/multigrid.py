"""Geometric multigrid V-cycle for the weak-form Poisson operator
(PyTorch counterpart of the JAX package's ``solvers/multigrid.py``).

The preconditioner of ``poisson solver = mg``: one V(nu1, nu2) cycle per
CG iteration (solvers/cg.py), in place of the reference's algebraic
preconditioners (ILU inner Schur preconditioner, preconditioner.h:36-42;
AMG declared for FEEC, boussineq_model_FEEC.h:299).

Components, as in the JAX package:
  * hierarchy  — cell-count halving per axis while even and > minimum,
                 rebuilt through grid/factory.py (exact coarse metrics);
  * smoother   — weighted Jacobi (omega = 0.8) on the weak residual, or
                 damped alternating-direction LINE relaxation along the
                 (at most two) stiff axes: a batched tridiagonal solve of
                 each line block carrying the full operator diagonal
                 ("auto" picks line on the shell and the annulus);
  * restriction — summation over child cells; prolongation —
                 piecewise-constant injection (its transpose);
  * coarse solve — fixed smoother sweeps in palindromic order.

The line solves are K4 (ops/tridiag.py ``TridiagSolve``, the model's
one wrapper): on a CUDA tensor the hand kernel, on a CPU tensor its plain
version ``thomas_solve``. Their operands are the moved-axis view of the
residual (``torch.movedim``, strided) against contiguous (n, ...)
coefficients; a periodic axis stacks the Sherman-Morrison pair [r, u] on
axis 1 against the coefficients' broadcast axis 1. At 32 x 128 x 256 the
hierarchy has 4 levels and, with the two stiff axes, one V-cycle runs
3 * 2 * (2 + 2) + 40 * 2 = 104 line solves.

On a mesh (``ShardedPoissonMultigrid``, the V-cycle of a hierarchy
rebuilt with ``line_axes_allowed=(0,)``, as the JAX package's mesh
rebuilds it) the same cycle runs on Sharded fields: each level's
operator on the shards (parallel/sharded_step.py), each radial line
solve one K4 launch a shard on the shard's own columns (its residual as
it is, the level's coefficients cut to the shard once: no copy), and the
restriction and prolongation on each shard alone, which holds whole
2^dim families where the mesh divides every level. At 32 x 128 x 256
one V-cycle runs 3 * 2 * 2 + 40 = 52 line solves on every shard. The
annulus's mesh relaxes its radial lines the same way; the walled box's
smoother is weighted Jacobi ("auto" on the cuboid, in both packages), so
its sharded V-cycle runs no K4.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.grid import factory
from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BCSpec
from dycoreplanet_tpu_torch.ops.diagonal import weak_laplacian_diagonal
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve
from dycoreplanet_tpu_torch.parallel.mesh import build
from dycoreplanet_tpu_torch.solvers.cg import _zeros_like
from dycoreplanet_tpu_torch.solvers.tridiag import thomas_solve


def _coarsen_shape(shape: Tuple[int, ...], min_cells: int = 4
                   ) -> Optional[Tuple[int, ...]]:
    """Halve every axis; None when any axis would drop below minimum or
    is odd (uniform coarsening of power-of-two grids)."""
    if any(n % 2 != 0 or n // 2 < min_cells for n in shape):
        return None
    return tuple(n // 2 for n in shape)


def _rebuild(geo: Geometry, shape: Tuple[int, ...]) -> Geometry:
    """The coarse level's geometry. As in the JAX package, only the 3D
    box with z walls, the annulus and the shell have one (its
    ``_rebuild`` makes a walled 3D box whatever the fine level)."""
    lo = float(geo.axes[0].faces[0])
    hi = float(geo.axes[0].faces[-1])
    if geo.kind == "cuboid":
        if geo.dim != 3 or geo.axes[0].periodic:
            raise ValueError(
                "poisson solver = mg: no multigrid hierarchy for the 2D slab "
                "or the fully periodic box (none in the JAX package either)")
        L = float(geo.axes[0].faces[-1])  # domain edge (scaled)
        if abs(L - 1.0) > 1e-12:
            return factory.make_cuboid(*shape, length_ref=1.0 / L)
        return factory.make_cuboid(*shape, length_ref=1.0)
    if geo.kind == "annulus":
        return factory.make_annulus(shape[0], shape[1], lo, hi)
    return factory.make_shell(shape[0], shape[1], shape[2], lo, hi)


class PoissonMultigrid:
    """V-cycle preconditioner for A x = b with A = -weak_laplacian.

    ``specs`` must be resolution-agnostic BC rules (Neumann / pole /
    periodic — the pressure BCs), so the same spec list applies on every
    level. ``line_axes_allowed`` restricts line relaxation to these axes
    (None: any). The coefficients are made in numpy float64, cast once to
    ``dtype`` and put on ``device``; ``tridiag`` is the K4 wrapper the
    line solves call (the model passes its own, whose ``launches`` count
    them). ``dtype`` may be a torch dtype (a model's working dtype,
    bfloat16 included: the residuals are then bfloat16, the tables
    float32, and every line solve takes K4's bfloat16 form)."""

    def __init__(self, geo: Geometry, specs: Sequence[Optional[BCSpec]], *,
                 n_smooth: int = 2, omega: float = 0.8,
                 coarse_iters: int = 40, min_cells: int = 4,
                 dtype=np.float32, smoother: str = "auto",
                 line_axes_allowed: Optional[Sequence[int]] = None,
                 device=None, tridiag: Optional[TridiagSolve] = None):
        self.specs = list(specs)
        self.n_smooth = n_smooth
        self.omega = omega
        self.coarse_iters = coarse_iters
        if smoother == "auto":
            smoother = "line" if geo.kind in ("shell", "annulus") \
                else "jacobi"
        assert smoother in ("line", "jacobi")
        self.smoother = smoother
        self.line_axes_allowed = (tuple(line_axes_allowed)
                                  if line_axes_allowed is not None else None)
        self.tridiag = tridiag if tridiag is not None else TridiagSolve()
        self.device = torch.device("cpu" if device is None else device)
        self.rhs_bf16 = dtype == torch.bfloat16
        if isinstance(dtype, torch.dtype):
            # a model's working dtype. Under bfloat16 the residuals are
            # bfloat16 and the tables float32: the lon lines near the poles
            # are nearly singular (their lon conductances dwarf the rest of
            # the diagonal), and bfloat16 coefficients, as the JAX package
            # casts them, leave a V-cycle whose residual grows ~1e6-fold
            # (ROADMAP.md Queue 3)
            self.torch_dtype = (torch.float32 if dtype == torch.bfloat16
                                else dtype)
            dtype = dtypes.host_dtype(dtype)
        else:
            self.torch_dtype = torch.float64 \
                if np.dtype(dtype) == np.float64 else torch.float32
        self.geos: List[Geometry] = [geo]
        shape = geo.cell_shape
        while True:
            nxt = _coarsen_shape(shape, min_cells)
            if nxt is None:
                break
            shape = nxt
            self.geos.append(_rebuild(geo, shape))
        self.diags = [(-weak_laplacian_diagonal(g, self.specs)).astype(dtype)
                      for g in self.geos]
        self._diags_t = [self._tensor(d) for d in self.diags]
        self.line_axes: List[int] = []
        self.lines = []
        if self.smoother == "line":
            # an axis whose two face conductances reach >= 40% of the
            # diagonal somewhere is a strong-coupling direction that point
            # Jacobi cannot smooth (the lat-lon shell: lon near the poles,
            # lat at planetary aspect); relax along the top two
            stiff = [(self._axis_stiffness(geo, self.diags[0], a), a)
                     for a in range(geo.dim)
                     if (self.line_axes_allowed is None
                         or a in self.line_axes_allowed)]
            if not stiff:
                self.smoother = "jacobi"
            else:
                stiff.sort(reverse=True)
                axes = [a for s, a in stiff if s >= 0.4][:2]
                self.line_axes = axes if axes else [stiff[0][1]]
            self.lines = [
                {a: self._line_coeffs(g, d, dtype, a) for a in self.line_axes}
                for g, d in zip(self.geos, self.diags)]
        self._lines_t = [{a: self._line_tensors(*c) for a, c in lv.items()}
                         for lv in self.lines]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=self.torch_dtype, device=self.device)

    def _axis_stiffness(self, g: Geometry, diag, axis: int) -> float:
        lo, hi = self._face_conductances(g, axis)
        return float(np.max((lo + hi)
                            / np.broadcast_to(np.asarray(diag, np.float64),
                                              g.cell_shape)))

    def _face_conductances(self, g: Geometry, axis: int):
        """(c_lo, c_hi) per cell along ``axis``, broadcast to
        cell_shape, wall/pole faces zeroed by the face areas."""
        shape = g.cell_shape
        n = shape[axis]
        c = (np.asarray(g.face_area[axis], np.float64)
             / np.asarray(g.face_dist[axis], np.float64))
        while c.ndim < len(shape):
            c = c[..., None]
        if c.shape[axis] == n + 1:          # wall/pole axis: n+1 faces
            fshape = shape[:axis] + (n + 1,) + shape[axis + 1:]
            cb = np.broadcast_to(c, fshape)
            sl_lo = [slice(None)] * len(shape)
            sl_lo[axis] = slice(0, n)
            sl_hi = [slice(None)] * len(shape)
            sl_hi[axis] = slice(1, n + 1)
            return cb[tuple(sl_lo)], cb[tuple(sl_hi)]
        cb = np.broadcast_to(c, shape)       # periodic: one shared face
        return cb, cb

    def _line_coeffs(self, g: Geometry, diag, dtype, axis: int):
        """Tridiagonal coefficients of the ``axis`` line block of
        A = -weak_laplacian carrying the FULL operator diagonal, with
        ``axis`` moved to the front for the batched Thomas solve.
        Periodic axes return the wrap conductance for the
        Sherman-Morrison corner correction."""
        periodic = self.specs[axis] is None
        c_lo, c_hi = self._face_conductances(g, axis)
        d = np.broadcast_to(np.asarray(diag, np.float64),
                            g.cell_shape).copy()
        lower = -np.moveaxis(c_lo, axis, 0).copy()
        upper = -np.moveaxis(c_hi, axis, 0).copy()
        dd = np.moveaxis(d, axis, 0).copy()
        wrap = None
        if periodic:
            wrap = lower[0].copy().astype(dtype)   # face 0 == face n
        lower[0] = 0.0
        upper[-1] = 0.0
        return (lower.astype(dtype), dd.astype(dtype), upper.astype(dtype),
                wrap)

    def _line_tensors(self, lo, d, up, wrap):
        """One line block's device tensors: (lower, diag, upper, None) or,
        on a periodic axis, (lower, d_t, upper, (w / gamma, u)): d_t the
        diagonal of A_t = A_c - u v^T, u = [gamma, 0, .., w] the
        correction's column (constant, so made once), gamma = -d[0].
        Under bfloat16 residuals the tuple also holds z = A_t^{-1} u,
        solved once in float64 on the host from the float32 tables, so
        that K4 takes the bfloat16 residual alone."""
        lo_t, d_t, up_t = self._tensor(lo), self._tensor(d), self._tensor(up)
        if wrap is None:
            return lo_t, d_t, up_t, None
        w = self._tensor(wrap)
        gamma = -d_t[0]
        dt_ = d_t.clone()
        dt_[0] = d_t[0] + (-gamma)
        dt_[-1] = d_t[-1] + (-(w * w) / gamma)
        u = torch.zeros_like(d_t)
        u[0] = gamma
        u[-1] = w
        if not self.rhs_bf16:
            return lo_t, dt_, up_t, (w / gamma, u)
        z = thomas_solve(*(t.cpu().double() for t in (lo_t, dt_, up_t, u)))
        return lo_t, dt_, up_t, (w / gamma, u, self._tensor(z))

    # -----------------------------------------------------------------
    def _apply(self, level: int, x: torch.Tensor) -> torch.Tensor:
        return -st.weak_laplacian(self.geos[level], x, self.specs)

    def line_operands(self, level: int, axis: int, r: torch.Tensor):
        """(lower, diag, upper, rhs) of the line solve's K4 call along
        ``axis``: the coefficients as made, the residual's moved-axis view;
        on a periodic axis the Sherman-Morrison pair [r, u] stacked on
        axis 1 against the coefficients' broadcast axis 1, but for a
        bfloat16 residual, which goes alone (its z made once)."""
        lo, d, up, wrap = self._lines_t[level][axis]
        rt = torch.movedim(r, axis, 0)
        if wrap is None or self.rhs_bf16:
            return lo, d, up, rt
        return (lo[:, None], d[:, None], up[:, None],
                torch.stack([rt, wrap[1]], dim=1))

    def _line_solve(self, level: int, axis: int, r: torch.Tensor
                    ) -> torch.Tensor:
        """T^{-1} r along ``axis`` (K4; periodic axes get the
        Sherman-Morrison corner correction of A_c = A_t + u v^T,
        u = [gamma, 0, .., w], v = [1, 0, .., w / gamma]: one 2-rhs solve
        of [r, u]; for a bfloat16 r, one of r beside the z made once)."""
        x = self.tridiag(*self.line_operands(level, axis, r))
        wrap = self._lines_t[level][axis][3]
        if wrap is not None:
            w_over_gamma = wrap[0]
            y, z = (x, wrap[2]) if self.rhs_bf16 else (x[:, 0], x[:, 1])
            vy = y[0] + w_over_gamma * y[-1]
            vz = z[0] + w_over_gamma * z[-1]
            x = y - z * (vy / (1.0 + vz))
        return torch.movedim(x.to(r.dtype), 0, axis)

    def _smooth(self, level: int, x: torch.Tensor, b: torch.Tensor, n: int,
                reverse: bool = False) -> torch.Tensor:
        if self.smoother == "line":
            # damped alternating-direction line relaxation over the stiff
            # axes (the line solve carries the full diagonal, so modes
            # oscillating in the other directions need omega in
            # (1/2, 1)); the post-smooth reverses the axis order so the
            # V-cycle stays symmetric (CG-admissible)
            axes = self.line_axes[::-1] if reverse else self.line_axes
            for _ in range(n):
                for a in axes:
                    r = b - self._apply(level, x)
                    x = x + self.omega * self._line_solve(level, a, r)
            return x
        d = self._diags_t[level]
        for _ in range(n):
            x = x + self.omega * (b - self._apply(level, x)) / d
        return x

    @staticmethod
    def _restrict(r: torch.Tensor) -> torch.Tensor:
        """Sum over the 2^dim children (conservative for the weak form)."""
        shape = []
        for n in r.shape:
            shape += [n // 2, 2]
        return r.reshape(shape).sum(dim=tuple(2 * d + 1
                                              for d in range(r.ndim)))

    @staticmethod
    def _prolong(x: torch.Tensor) -> torch.Tensor:
        """Piecewise-constant injection."""
        for d in range(x.ndim):
            x = torch.repeat_interleave(x, 2, dim=d)
        return x

    def _vcycle(self, level: int, b: torch.Tensor) -> torch.Tensor:
        if level == len(self.geos) - 1:
            # palindromic sweep order keeps the coarse solve self-adjoint
            # with an alternating-direction smoother
            half = self.coarse_iters // 2
            x = self._smooth(level, _zeros_like(b), b, half)
            return self._smooth(level, x, b, self.coarse_iters - half,
                                reverse=True)
        x = self._smooth(level, _zeros_like(b), b, self.n_smooth)
        r = b - self._apply(level, x)
        xc = self._vcycle(level + 1, self._restrict(r))
        x = x + self._prolong(xc)
        return self._smooth(level, x, b, self.n_smooth, reverse=True)

    def line_solves_per_cycle(self) -> int:
        """The line solves (K4 launches) of one V-cycle."""
        if self.smoother != "line":
            return 0
        return len(self.line_axes) * (
            2 * self.n_smooth * (len(self.geos) - 1) + self.coarse_iters)

    # -----------------------------------------------------------------
    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """Preconditioner application M^{-1} r (one V-cycle)."""
        return self._vcycle(0, r)


class ShardedPoissonMultigrid(PoissonMultigrid):
    """The V-cycle of ``base`` (a PoissonMultigrid rebuilt as the JAX
    package's mesh rebuilds it, ``line_axes_allowed=(0,)``: on the shell
    and the annulus the line smoother relaxes along the radial lines
    alone; the walled box's smoother is weighted Jacobi, as "auto" picks
    on the cuboid in both packages) on the geometry's mesh, on Sharded
    residuals. It shares base's hierarchy, tables and K4 wrapper (whose
    ``launches`` count every shard's line solves); the cycle itself is
    PoissonMultigrid's. A level whose sharded axes the mesh does not
    divide raises ValueError: its 2^dim families would straddle two
    shards."""

    def __init__(self, base: PoissonMultigrid, mesh):
        from dycoreplanet_tpu_torch.parallel.sharded_step import (
            ShardedStep)

        if base.smoother == "line" and base.line_axes != [0]:
            raise ValueError("the sharded V-cycle relaxes along the radial "
                             "lines alone (line_axes_allowed=(0,))")
        A, B = mesh.grid
        for level, g in enumerate(base.geos):
            if g.cell_shape[-2] % A or g.cell_shape[-1] % B:
                raise ValueError(
                    f"poisson solver = mg: level {level} of the hierarchy, "
                    f"{g.cell_shape}, is not divisible by the mesh "
                    f"({A}, {B})")
        for name in ("specs", "n_smooth", "omega", "coarse_iters",
                     "smoother", "line_axes", "geos", "tridiag",
                     "torch_dtype"):
            setattr(self, name, getattr(base, name))
        self.mesh = mesh
        self.ops = [ShardedStep(g, mesh) for g in base.geos]
        # each level's radial line coefficients (or Jacobi diagonal) cut
        # to this process's shards (op.offsets: its own)
        self.shard_lines = [
            {ab: tuple(t[..., j0:j0 + op.local[-2], k0:k0 + op.local[-1]]
                       .to(mesh.device(*ab)).contiguous()
                       for t in lv[0][:3])
             for ab, (j0, k0) in op.offsets.items()}
            for lv, op in zip(base._lines_t, self.ops)]
        self._diags_t = [op.cut(d, base.torch_dtype)
                         for d, op in zip(base.diags, self.ops)]

    def shard_operands(self, level: int, ab, r):
        """(lower, diag, upper, rhs) of shard ``ab``'s radial line solve:
        the level's coefficients cut to the shard and the shard's residual
        ``r`` (a tensor) as it is."""
        return self.shard_lines[level][ab] + (r,)

    def _apply(self, level: int, x):
        return -self.ops[level].weak_laplacian(x, self.specs)

    def _line_solve(self, level: int, axis: int, r):
        """T^{-1} r along the radial lines: one K4 launch a shard."""
        return build(self.mesh, lambda a, b: self.tridiag(
            *self.shard_operands(level, (a, b), r[a, b])).to(r[a, b].dtype))

    def _restrict(self, r):
        return r.map(PoissonMultigrid._restrict)

    def _prolong(self, x):
        return x.map(PoissonMultigrid._prolong)
