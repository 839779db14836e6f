"""K1: the fast path's implicit stage — fixed-iteration Jacobi-Richardson
solves of the momentum and temperature Helmholtz systems with exactly
tracked residuals, plus the pre-Poisson projection head — as hand-written
CUDA kernels beside the plain PyTorch version.

Replaces the Pallas kernel ``HelmholtzRichardsonPallas._build_call``
(dycoreplanet_tpu/ops/pallas_richardson.py:348). Solves

    (V - dt/Re L) u* = V rhs_u     x0 = rhs_u, ``iters_u`` sweeps
    (V - dt_T/Pe L) T = rhs_T      x0 = T0,    ``iters_T`` sweeps

and emits the left-face velocities of u* and the compatibility-corrected
Poisson right-hand side, with the norms the model's honesty gate reads.
Kernel source: csrc/richardson.cu (init, one sweep per iteration, head,
fixed-order reduction). Bound: device-memory traffic — 13 fields moved
at the least (rhs_u, rhs_T, T0 read; u*, T_new, three faces, rhs
written), ~55 MB at 32x128x256 f32.

The plain version is deliberately the straightforward composition the
JAX package runs on the CPU: ``solvers.fixed.richardson_solve`` over the
ghost-based ``weak_laplacian`` and the plain projection head, so an
error in the kernel's ghost or metric handling shows in the comparison.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.projection import faces_div_plain
from dycoreplanet_tpu_torch.solvers.cg import _dot
from dycoreplanet_tpu_torch.solvers.fixed import richardson_solve

FIELDS_MOVED = 13
# floating-point operations per cell: ~30 per weak-Laplacian apply to
# one channel, (iters + 1) applies for each of the 4 channels, plus the
# projection head and the norms
OPS_PER_CHANNEL_APPLY = 30
OPS_PER_CELL_HEAD = 40


class ShellRichardson:
    """Callable (rhs_u, rhs_T, T0, dt) -> (u_star, T_new,
    (uf0, uf1, uf2, rhs_phi), (rnorm_u, bnorm_u, rnorm_T, bnorm_T)).
    CPU tensors take the plain version; CUDA tensors launch the kernels."""

    def __init__(self, geo: Geometry, *, one_over_Re: float,
                 one_over_Pe: float, nse_interval: int,
                 helm_diags: np.ndarray, T_diag: np.ndarray,
                 iters_u: int, iters_T: int, u_specs, T_specs_hom):
        if iters_u < 1 or iters_T < 1:
            raise ValueError("the Richardson kernel needs >= 1 iteration")
        self.geo = geo
        self.one_over_Re = float(one_over_Re)
        self.one_over_Pe = float(one_over_Pe)
        self.dt_T_factor = 1.0 / float(nse_interval)
        self.iters_u, self.iters_T = int(iters_u), int(iters_T)
        self.u_specs, self.T_specs_hom = u_specs, T_specs_hom
        self.helm_diags = np.asarray(helm_diags)
        self.T_diag = np.asarray(T_diag)
        ch = kl.shell_channels(geo)
        Ld = kl.lon_invariant(self.helm_diags, "helm_diags")   # (3, nr, nlat)
        Ld_T = kl.lon_invariant(self.T_diag, "T_diag")
        self._M64 = np.stack([ch[k] for k in (
            "vol", "ar_lo", "ar_hi", "alat_lo", "alat_hi", "alon", "dr_lo",
            "dr_hi", "dlat_lo", "dlat_hi", "dlon")] + list(Ld) + [Ld_T])
        self._M = {}
        self._fn = {}
        self.launches = 0

    # ------------------------------------------------------------------
    def plain(self, rhs_u, rhs_T, T0, dt):
        geo = self.geo
        dtype = rhs_u.dtype
        npd = kl.NP_DTYPE[dtype]
        vol = st.metric(geo, "vol", 0, rhs_u)
        coef = float(npd(dt) * npd(self.one_over_Re))
        kT = float(npd(npd(dt) * npd(self.dt_T_factor))
                   * npd(self.one_over_Pe))
        hd = torch.as_tensor(self.helm_diags, dtype=dtype,
                             device=rhs_u.device)
        td = torch.as_tensor(self.T_diag, dtype=dtype, device=rhs_u.device)

        def helm_op(x):
            return vol[None] * x - coef * torch.stack([
                st.weak_laplacian(geo, x[c], self.u_specs[c])
                for c in range(3)])

        def temp_op(x):
            return vol * x - kT * st.weak_laplacian(geo, x, self.T_specs_hom)

        res_u = richardson_solve(helm_op, vol[None] * rhs_u, rhs_u,
                                 diag=vol[None] + coef * hd,
                                 iters=self.iters_u)
        res_T = richardson_solve(temp_op, rhs_T, T0, diag=vol + kT * td,
                                 iters=self.iters_T)
        uf0, uf1, uf2, rhs_raw, total = faces_div_plain(
            geo, self.u_specs, res_u.x, dt)
        rhs_phi = rhs_raw - total / float(geo.n_cells)
        b_u = vol[None] * rhs_u
        return (res_u.x, res_T.x, (uf0, uf1, uf2, rhs_phi),
                (res_u.residual_norm, torch.sqrt(_dot(b_u, b_u)),
                 res_T.residual_norm, torch.sqrt(_dot(rhs_T, rhs_T))))

    # ------------------------------------------------------------------
    def __call__(self, rhs_u, rhs_T, T0, dt):
        if rhs_u.device.type == "cpu":
            return self.plain(rhs_u, rhs_T, T0, dt)
        shp = self.geo.cell_shape
        dev, dtype = kl.require_cuda("richardson", {
            "rhs_u": (rhs_u, (3,) + shp), "rhs_T": (rhs_T, shp),
            "T0": (T0, shp)})
        key = (str(dev), dtype)
        if key not in self._M:
            self._M[key] = torch.as_tensor(self._M64, dtype=dtype,
                                           device=dev).contiguous()
        sfx = kl.suffix(dtype)
        fn = self._fn.get(sfx)
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("richardson.cu", f"dp_richardson_{sfx}",
                         [I, I, I, P, P, P, P, D, D, D, D, I, I]
                         + [P] * 13)
            self._fn[sfx] = fn
        nr, nlat, nlon = shp
        new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
        u_star, ru_a, ru_b = (new(3, nr, nlat, nlon) for _ in range(3))
        T_new, rT_a, rT_b, f0, f1, f2, rhs_raw = (
            new(nr, nlat, nlon) for _ in range(7))
        nblk = (nr * nlat * nlon + 255) // 256
        parts = new(nblk, 5)
        sums = new(5)
        p = kl.ptr
        kl.check(fn(nr, nlat, nlon, p(self._M[key]), p(rhs_u), p(rhs_T),
                    p(T0), float(dt), self.one_over_Re, self.one_over_Pe,
                    self.dt_T_factor, self.iters_u, self.iters_T, p(u_star),
                    p(T_new), p(ru_a), p(ru_b), p(rT_a), p(rT_b), p(f0),
                    p(f1), p(f2), p(rhs_raw), p(parts), p(sums),
                    kl.stream_of(rhs_u)), "richardson kernels")
        self.launches += 1
        rhs_phi = rhs_raw - sums[4] / float(self.geo.n_cells)
        norms = torch.sqrt(sums[:4])
        return (u_star, T_new, (f0, f1, f2, rhs_phi),
                (norms[0], norms[1], norms[2], norms[3]))


def ops_per_cell(iters_u: int, iters_T: int) -> int:
    """Operations per cell of one K1 call (for the roofline bound)."""
    applies = 3 * (iters_u + 1) + (iters_T + 1)
    return applies * OPS_PER_CHANNEL_APPLY + OPS_PER_CELL_HEAD
