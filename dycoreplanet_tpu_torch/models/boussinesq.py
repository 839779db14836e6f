"""BoussinesqModel — the shell standard-personality time stepper on
PyTorch (counterpart of the JAX package's ``models/boussinesq.py``).

Solves the nondimensional rotating buoyancy Boussinesq system with the
IMEX-Euler splitting and the incremental pressure projection:

  1. explicit forcing     rhs_u = u + dt (-adv u + cor u + buoy T
                                          + visc_curv u - grad p)     [K2]
  2. Helmholtz predictor  (V - dt/Re L) u* = V rhs_u
  3. temperature          (V - dt/Pe L) T = V T_adv + dt/Pe L_offset  [K1]
  4. Poisson projection   -L phi = -V div(U*)/dt  (fast diagonalization)
  5. correction           U = U* - dt grad_f phi, u = u* - dt grad_c phi,
                          p = p + phi

On the fast path steps 2-3 are fixed-iteration Jacobi-Richardson
solves with the projection head fused (kernel K1, ops/richardson.py).
Their exactly tracked residuals and the Poisson residual spot-check
gate every step; a miss redoes the step with full CG (``step_strong``),
which runs the faces_div kernel K3 (ops/projection.py) — the
reference's NoConvergence retry, boussinesq_model.tpp:1203-1232. The
JAX model's ``_explicit_forcing`` and ``_advected_temperature`` are
``ShellForcing.explicit_forcing`` / ``.advected_temperature`` here, the
plain version of K2 (ops/forcing.py).

This slice runs the 3D spherical shell, standard (advective)
personality, incremental projection. Every other configuration raises
``NotImplementedError`` naming its ROADMAP.md item; none quietly runs
another path.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.base import nondim
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.factory import make_geometry
from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.ops.diagonal import weak_laplacian_diagonal
from dycoreplanet_tpu_torch.ops.forcing import ShellForcing
from dycoreplanet_tpu_torch.ops.projection import (
    ShellProjection, apply_wall_face_values)
from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson
from dycoreplanet_tpu_torch.physics.closures import radial_gravity_scalar
from dycoreplanet_tpu_torch.physics.initial_data import (
    TemperatureInitialValues)
from dycoreplanet_tpu_torch.solvers.cg import cg
from dycoreplanet_tpu_torch.solvers.spectral import make_poisson_solver

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class State(NamedTuple):
    u: torch.Tensor                     # (3, *cells) velocity, local frame
    u_faces: Tuple[torch.Tensor, ...]   # cell-shaped LEFT-face velocities
    p: torch.Tensor                     # (*cells) pressure
    T: torch.Tensor                     # (*cells) temperature
    time: float
    step_number: int


class StepDiagnostics:
    """Per-step diagnostics packed into ONE float32 device vector, slot
    for slot as in the JAX package: [cfl, max|u|, T_min, T_max,
    max|div u|, poisson_iters, temperature_iters, helmholtz_residual,
    poisson_residual, temperature_residual, solver_ok, helmholtz_iters
    x3]. The host pays one device->host copy when a field is first
    read. Iteration counts / residuals of -1 mean "direct solve, not
    measured"."""

    def __init__(self, packed: torch.Tensor, dim: int):
        self.packed = packed
        self._dim = dim
        self._host_vals: Optional[np.ndarray] = None

    @staticmethod
    def pack(cfl, max_velocity, T_min, T_max, div_norm, poisson_iters,
             temperature_iters, helmholtz_iters, helmholtz_residual=0.0,
             poisson_residual=0.0, temperature_residual=0.0,
             solver_ok=1.0, device=None) -> torch.Tensor:
        def f32(v):
            return torch.as_tensor(v, device=device).to(
                torch.float32).reshape(())
        head = [f32(v) for v in (
            cfl, max_velocity, T_min, T_max, div_norm, poisson_iters,
            temperature_iters, helmholtz_residual, poisson_residual,
            temperature_residual, solver_ok)]
        helm = [f32(v) for v in helmholtz_iters]
        return torch.stack(head + helm)

    def _h(self) -> np.ndarray:
        if self._host_vals is None:
            self._host_vals = self.packed.detach().cpu().numpy()
        return self._host_vals

    @property
    def cfl(self) -> float:
        return float(self._h()[0])

    @property
    def max_velocity(self) -> float:
        return float(self._h()[1])

    @property
    def T_min(self) -> float:
        return float(self._h()[2])

    @property
    def T_max(self) -> float:
        return float(self._h()[3])

    @property
    def div_norm(self) -> float:
        return float(self._h()[4])

    @property
    def poisson_iters(self) -> int:
        return int(self._h()[5])

    @property
    def temperature_iters(self) -> int:
        return int(self._h()[6])

    @property
    def helmholtz_residual(self) -> float:
        return float(self._h()[7])

    @property
    def poisson_residual(self) -> float:
        return float(self._h()[8])

    @property
    def temperature_residual(self) -> float:
        return float(self._h()[9])

    @property
    def solver_ok(self) -> bool:
        """All iterative solves of this step met their tolerance; False
        triggers the host-level escalation to full CG."""
        return bool(self._h()[10] > 0.5)

    @property
    def helmholtz_iters(self) -> np.ndarray:
        return self._h()[11:].astype(np.int32)


def _unsupported(params: Parameters) -> Optional[str]:
    """The ROADMAP.md item that brings a configuration this slice does
    not run, or None."""
    num = params.numerics
    if params.use_FEEC_solver or num.momentum_solver == "coupled":
        return "FEEC, coupled and mimetic solvers"
    if params.cuboid_geometry or params.space_dimension != 3:
        return "annulus and cuboid geometries"
    if num.dtype == "bfloat16":
        return "bf16"
    if num.helmholtz_solver == "direct":
        return "remaining solvers: direct Helmholtz (K4)"
    if num.poisson_solver in ("cg", "mg"):
        return f"remaining solvers: poisson solver = {num.poisson_solver}"
    if num.temperature_advection == "semi-lagrangian":
        return "semi-Lagrangian temperature transport"
    if num.residual_check_interval > 1:
        return ("residual check interval > 1 (K1 without residual "
                "tracking, with the rewind)")
    if params.NSE_solver_interval > 1:
        return "NSE solver interval > 1 temperature substeps"
    if num.fixed_solver_iters <= 0 and num.momentum_fixed_iters > 0:
        return ("remaining solvers: momentum fixed iters > 0 with fixed "
                "solver iters = 0 (Richardson momentum beside CG "
                "temperature)")
    return None


def resolve_device(device) -> torch.device:
    """CUDA unless the caller asks for the CPU; no silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: dycoreplanet_tpu_torch runs on the "
                "GPU; pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


class BoussinesqModel:
    """Time stepper for one configuration (reference analogue:
    Standard::BoussinesqModel, include/core/boussinesq_model.h:116-310).

    ``device``: None runs on CUDA and raises without it; "cpu" runs the
    kernels' plain versions (the CPU tests)."""

    def __init__(self, params: Parameters, geometry: Optional[Geometry] = None,
                 device=None):
        item = _unsupported(params)
        if item is not None:
            raise NotImplementedError(
                f"not ported yet (ROADMAP.md: {item})")
        self.device = resolve_device(device)
        self.params = params
        self.geo = geometry if geometry is not None else make_geometry(params)
        if self.geo.kind != "shell":
            raise NotImplementedError(
                "not ported yet (ROADMAP.md: annulus and cuboid geometries)")
        num = params.numerics
        self.torch_dtype = _DTYPES[num.dtype]
        self.dtype = np.dtype(num.dtype)
        if self.device.type == "cuda":
            # TF32 would round the Poisson transforms' operands to 10-bit
            # mantissas; the projection needs full float32 products
            torch.backends.cuda.matmul.allow_tf32 = False

        ref = params.reference_quantities
        pc = params.physical_constants
        self.one_over_Re = 1.0 / nondim.reynolds_number(
            ref.velocity, ref.length, pc.kinematic_viscosity)
        self.one_over_Pe = 1.0 / nondim.peclet_number(
            ref.velocity, ref.length, pc.thermal_diffusivity)
        self.beta = pc.expansion_coefficient
        self.T_ref = ref.temperature_ref
        self.g_hat_scale = ref.length / ref.velocity**2
        self.omega_hat = ref.length * pc.omega / ref.velocity
        self.coriolis_mode = num.coriolis_mode
        self.advection_scheme = num.advection_scheme
        self.momentum_iters = num.momentum_fixed_iters or num.fixed_solver_iters

        self._setup_bcs()
        self._setup_static_fields()
        geo = self.geo
        self._forcing = ShellForcing(
            geo, beta=self.beta, T_ref=self.T_ref,
            rho_background=self.rho_background, gravity=self.gravity,
            one_over_Re=self.one_over_Re, omega_hat=self.omega_hat,
            coriolis_mode=self.coriolis_mode, buoyancy=num.buoyancy,
            scheme=self.advection_scheme,
            include_gradp=num.projection == "incremental",
            u_specs=self.u_specs, p_specs=self.p_specs,
            T_specs=self.T_specs, T_wall=self.T_wall,
            dt_T_factor=1.0 / params.NSE_solver_interval)
        self._proj = ShellProjection(geo, self.u_specs)
        self._richardson = None
        if num.fixed_solver_iters > 0:
            self._richardson = ShellRichardson(
                geo, one_over_Re=self.one_over_Re,
                one_over_Pe=self.one_over_Pe,
                nse_interval=params.NSE_solver_interval,
                helm_diags=self.helm_diags, T_diag=self.T_diag,
                iters_u=self.momentum_iters,
                iters_T=num.fixed_solver_iters,
                u_specs=self.u_specs, T_specs_hom=self.T_specs_hom)
        # True: every solve of the step takes the full CG path (the
        # strong retry of the host-level NoConvergence handling)
        self._force_cg = False
        # re-arming escalation (see run): a fast-path miss opens a
        # full-CG window of `_fast_rearm_steps` steps, doubling on each
        # repeat miss up to the cap
        self._fast_rearm_steps = 8
        self._fast_rearm_cap = 1024
        self._strong_steps_left = 0
        self.escalations = 0

    # ------------------------------------------------------------------
    def kernels(self) -> Dict[str, object]:
        """The kernel wrappers of the step, by name (their ``launches``
        count the CUDA launches)."""
        out = {"forcing": self._forcing, "faces_div": self._proj}
        if self._richardson is not None:
            out["richardson"] = self._richardson
        return out

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=self.torch_dtype,
                               device=self.device)

    def _scalar(self, x) -> float:
        """A Python float holding ``x`` rounded to the working dtype."""
        return float(self.dtype.type(x))

    # ------------------------------------------------------------------
    def _setup_bcs(self) -> None:
        """Ghost rules replacing the reference's constraint sets
        (no-slip inner / no-normal-flux outer wall, pole closure;
        reference: boussinesq_model.tpp:259-387)."""
        AS, NEU = BC.ANTISYM, BC.NEUMANN
        PO, PF = BC.POLE, BC.POLE_FLIP
        self.u_specs = [
            [BCSpec(AS, AS), BCSpec(PO, PO), None],    # u_r
            [BCSpec(AS, NEU), BCSpec(PF, PF), None],   # u_lat
            [BCSpec(AS, NEU), BCSpec(PF, PF), None],   # u_lon
        ]
        self.p_specs = [BCSpec(NEU, NEU), BCSpec(PO, PO), None]

    def _cartesian(self, radii) -> np.ndarray:
        """Cartesian points (len(radii), nlat, nlon, 3) at the given
        radii and the cell-centre latitudes and longitudes (the
        reference's initial-data functions are Cartesian)."""
        axes = self.geo.axes
        r, lat, lon = np.meshgrid(radii, axes[1].centers, axes[2].centers,
                                  indexing="ij")
        return np.stack([r * np.cos(lat) * np.cos(lon),
                         r * np.cos(lat) * np.sin(lon),
                         r * np.sin(lat)], axis=-1)

    def _setup_static_fields(self) -> None:
        """Host numpy constants (the same arrays the JAX model builds)
        and their device copies."""
        geo = self.geo
        params = self.params
        dt_np = self.dtype
        self.vol = np.ascontiguousarray(
            np.broadcast_to(geo.vol, geo.cell_shape)).astype(dt_np)
        self.diameter = np.asarray(geo.cell_diameter(), dtype=dt_np)
        r = np.broadcast_to(geo.extras["r_centers"], geo.cell_shape)
        gvec = np.zeros((3,) + geo.cell_shape)
        gvec[0] = radial_gravity_scalar(
            r, params.physical_constants.gravity_constant)
        self.gravity = (self.g_hat_scale * gvec).astype(dt_np)

        ic = TemperatureInitialValues(
            3, float(geo.axes[0].faces[0]), float(geo.axes[0].faces[-1]),
            width_scale=params.numerics.ic_width_scale)
        self.T_init = np.asarray(
            ic(self._cartesian(geo.axes[0].centers).astype(dt_np)),
            dtype=dt_np)
        # boundary values: the IC on the inner wall surface
        self.T_wall = np.asarray(
            ic(self._cartesian(geo.axes[0].faces[:1])[0].astype(dt_np)),
            dtype=dt_np)
        T_mean0 = float((self.T_init * self.vol).sum() / self.vol.sum())
        self.rho_background = float(1.0 - self.beta * (T_mean0 - self.T_ref))

        NEU = BC.NEUMANN
        self.T_specs = [BCSpec(BC.DIRICHLET, NEU,
                               lo_value=self._tensor(self.T_wall)),
                        BCSpec(BC.POLE, BC.POLE), None]
        self.T_specs_hom = [BCSpec(BC.ANTISYM, NEU),
                            BCSpec(BC.POLE, BC.POLE), None]
        # affine offset of the inhomogeneous-Dirichlet weak Laplacian:
        # weak_lap_inhom(x) = weak_lap_hom(x) + offset
        zero = torch.zeros(geo.cell_shape, dtype=self.torch_dtype,
                           device=self.device)
        self.T_lap_offset = st.weak_laplacian(
            geo, zero, self.T_specs).cpu().numpy()

        # Poisson: the shell fast-diagonalization solve. "auto" resolves
        # as the JAX package does off the TPU ("highest"); every
        # precision computes full-precision transforms here and keeps
        # its residual-check tolerance
        prec = params.numerics.poisson_precision
        if prec == "auto":
            prec = "highest"
        self.poisson_spectral = make_poisson_solver(
            geo, dtype=dt_np, precision=prec,
            refine_op=lambda x: -st.weak_laplacian(geo, x, self.p_specs),
            device=self.device)
        self.helm_diags = np.stack([
            (-weak_laplacian_diagonal(geo, self.u_specs[c])).astype(dt_np)
            for c in range(3)])
        self.T_diag = (
            -weak_laplacian_diagonal(geo, self.T_specs_hom)).astype(dt_np)

        self._vol_t = self._tensor(self.vol)
        self._diameter_t = self._tensor(self.diameter)
        self._T_lap_offset_t = self._tensor(self.T_lap_offset)
        self._helm_diags_t = self._tensor(self.helm_diags)
        self._T_diag_t = self._tensor(self.T_diag)

    # ------------------------------------------------------------------
    def initial_state(self) -> State:
        shp = self.geo.cell_shape
        z = lambda *s: torch.zeros(s, dtype=self.torch_dtype,
                                   device=self.device)
        return State(u=z(3, *shp), u_faces=tuple(z(*shp) for _ in range(3)),
                     p=z(*shp), T=self._tensor(self.T_init), time=0.0,
                     step_number=0)

    def interp_to_faces(self, u: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Face-normal velocities of a collocated field (wall faces 0)."""
        return tuple(apply_wall_face_values(
            self.geo, st.to_faces(self.geo, u[c], c, self.u_specs[c][c]), c)
            for c in range(3))

    # ------------------------------------------------------------------
    def _step_body(self, state: State, dt: float):
        geo = self.geo
        p = self.params
        vol = self._vol_t
        u, u_faces, pres, T = state.u, state.u_faces, state.p, state.T
        dt = self._scalar(dt)
        dt_T = self._scalar(dt / p.NSE_solver_interval)

        # ---------------- explicit forcing from step n [K2] -----------
        rhs_u, T_adv = self._forcing(u, u_faces, T, pres, dt)
        kT = self._scalar(self.dtype.type(dt_T)
                          * self.dtype.type(self.one_over_Pe))
        rhs_T = vol * T_adv + kT * self._T_lap_offset_t

        if self._richardson is not None and not self._force_cg:
            # fused implicit stage [K1]: both Richardson solves + the
            # projection head
            rk = self._richardson
            u_star, T_new, prefused, (rn_u, bn_u, rn_T, bn_T) = \
                rk(rhs_u, rhs_T, T, dt)
            eps16 = 16.0 * float(np.finfo(self.dtype).eps)
            helm_ok = rn_u <= max(p.numerics.helmholtz_tol, eps16) * bn_u
            T_ok = rn_T <= max(p.numerics.temperature_tol, eps16) * bn_T
            (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
             poisson_ok) = self._project_velocity(u_star, pres, dt,
                                                  prefused=prefused)
            helm_iters = [rk.iters_u] * 3
            T_iters = rk.iters_T
            helm_rnorm, T_rnorm = rn_u, rn_T
            momentum_ok = torch.logical_and(helm_ok, poisson_ok)
        else:
            (u_new, p_new, new_faces, helm_iters, poisson_iters,
             helm_rnorm, poisson_rnorm, momentum_ok) = \
                self._solve_momentum_projection(rhs_u, pres, dt)
            T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
                rhs_T, kT, T)

        # ---------------- diagnostics ----------------------------------
        speed = st.cell_max_speed(geo, u_new)
        cfl = torch.max(torch.clamp(speed, min=1e-10) / self._diameter_t)
        div_new = st.divergence(geo, new_faces)
        packed = StepDiagnostics.pack(
            cfl, torch.max(speed), torch.min(T_new), torch.max(T_new),
            torch.max(torch.abs(div_new)), poisson_iters, T_iters,
            helm_iters, helmholtz_residual=helm_rnorm,
            poisson_residual=poisson_rnorm, temperature_residual=T_rnorm,
            solver_ok=torch.logical_and(momentum_ok, T_ok),
            device=self.device)
        new_state = State(u=u_new, u_faces=tuple(new_faces), p=p_new,
                          T=T_new, time=state.time + dt_T,
                          step_number=state.step_number + 1)
        return new_state, StepDiagnostics(packed, 3)

    # ------------------------------------------------------------------
    def _solve_temperature_system(self, rhs_T, kT, x0):
        """(vol - kT * weak_lap_hom) T = rhs_T by Jacobi-CG (reference:
        temperature CG at 1e-12*rhs, tpp:1426-1440)."""
        geo = self.geo
        vol = self._vol_t
        diag_T = vol + kT * self._T_diag_t

        def temp_op(x):
            return vol * x - kT * st.weak_laplacian(geo, x, self.T_specs_hom)

        res = cg(temp_op, rhs_T, x0=x0,
                 rtol=self.params.numerics.temperature_tol,
                 maxiter=self.params.numerics.max_cg_iters,
                 preconditioner=lambda r: r / diag_T)
        return res.x, res.iterations, res.residual_norm, res.converged

    def _solve_pressure_poisson(self, rhs_phi):
        """-weak_lap(phi) = rhs_phi: the fast-diagonalization solve, or
        under ``_force_cg`` CG preconditioned by it (a corrupted
        fast-diag then only slows the iteration). Returns (phi, iters,
        residual_norm, converged) with the -1 sentinel for the direct
        solve (replaced by the spot-check in _project_velocity)."""
        if not self._force_cg:
            phi, iters = self.poisson_spectral.solve(rhs_phi)
            return (phi, iters, torch.tensor(-1.0, device=self.device),
                    torch.tensor(True, device=self.device))
        res = cg(lambda x: -st.weak_laplacian(self.geo, x, self.p_specs),
                 rhs_phi, rtol=self.params.numerics.poisson_tol,
                 maxiter=self.params.numerics.max_cg_iters,
                 preconditioner=self.poisson_spectral)
        return res.x, res.iterations, res.residual_norm, res.converged

    def _solve_momentum_projection(self, rhs_u, pres, dt):
        """Full-CG Helmholtz predictor + projection (the escalated path;
        all three components in one stacked CG)."""
        geo = self.geo
        vol = self._vol_t
        coef = self._scalar(self.dtype.type(dt)
                            * self.dtype.type(self.one_over_Re))

        def helm_op(x):
            return vol[None] * x - coef * torch.stack([
                st.weak_laplacian(geo, x[c], self.u_specs[c])
                for c in range(3)])

        helm_diag = vol[None] + coef * self._helm_diags_t
        res = cg(helm_op, vol[None] * rhs_u, x0=rhs_u,
                 rtol=self.params.numerics.helmholtz_tol,
                 maxiter=self.params.numerics.max_cg_iters,
                 preconditioner=lambda r: r / helm_diag)
        (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
         poisson_ok) = self._project_velocity(res.x, pres, dt)
        return (u_new, p_new, new_faces, [res.iterations] * 3,
                poisson_iters, res.residual_norm, poisson_rnorm,
                torch.logical_and(res.converged, poisson_ok))

    # ------------------------------------------------------------------
    def _project_velocity(self, u_star, pres, dt, prefused=None):
        """Faces + compatible RHS (from K1's head, or K3), Poisson solve,
        face/cell correction, residual spot-check. Returns (u_new, p_new,
        new_faces, poisson_iters, poisson_rnorm, poisson_ok)."""
        geo = self.geo
        p = self.params
        vol = self._vol_t
        if prefused is not None:
            uf_star = list(prefused[:3])
            rhs_phi = prefused[3]
        else:
            uf0, uf1, uf2, rhs_raw, total = self._proj.faces_div(u_star, dt)
            uf_star = [uf0, uf1, uf2]
            # compatibility: subtract the float drift of sum(rhs)
            rhs_phi = rhs_raw - total / float(geo.n_cells)

        phi, poisson_iters, poisson_rnorm, poisson_ok = \
            self._solve_pressure_poisson(rhs_phi)

        phi = phi - st.volume_mean(geo, phi)
        new_faces = []
        for d in range(3):
            gphi = st.grad_left_faces(geo, phi, d, self.p_specs[d])
            new_faces.append(apply_wall_face_values(
                geo, uf_star[d] - dt * gphi, d))
        gradphi_c = torch.stack([
            st.centered_gradient(geo, phi, d, self.p_specs[d])
            for d in range(3)])
        u_new = u_star - dt * gradphi_c
        p_new = pres + phi if p.numerics.projection == "incremental" else phi
        if p.correct_pressure_to_zero_mean:
            p_new = p_new - st.volume_mean(geo, p_new)

        if not self._force_cg:
            # residual spot-check of the direct solve: grad/div are a
            # compatible pair, so vol*div(u_new)/dt IS the solve residual;
            # noise floor C*eps*||area*uf||/dt, per-precision tolerance
            # table as in the JAX package (boussinesq.py:1284-1294)
            div_chk = st.divergence(geo, new_faces)
            rnorm = torch.sqrt(torch.sum((vol * div_chk) ** 2)) / dt
            bnorm = torch.sqrt(torch.sum(rhs_phi ** 2))
            epsf = float(np.finfo(self.dtype).eps)
            flux2 = None
            for d2 in range(3):
                t2 = torch.sum(
                    (st.metric(geo, "area_l", d2, u_star) * new_faces[d2])
                    ** 2)
                flux2 = t2 if flux2 is None else flux2 + t2
            floor = 16.0 * epsf * torch.sqrt(flux2) / dt
            prec = self.poisson_spectral.precision
            prec_tol = {"highest": 256.0 * epsf, "high": 1e-2,
                        "high-refine": 1e-3}[prec]
            tol = max(p.numerics.poisson_tol, prec_tol)
            poisson_ok = rnorm <= tol * bnorm + floor
            poisson_rnorm = rnorm
        return (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
                poisson_ok)

    # ------------------------------------------------------------------
    def step(self, state: State, dt: float):
        """One time step; returns (new_state, diagnostics). Diagnostics
        stay on the device until a field is read (one packed copy)."""
        return self._step_body(state, dt)

    def step_strong(self, state: State, dt: float):
        """Redo one step with the full CG solves — the escalation taken
        when ``diagnostics.solver_ok`` is False on the fast path
        (reference: boussinesq_model.tpp:1203-1232)."""
        old = self._force_cg
        self._force_cg = True
        try:
            return self._step_body(state, dt)
        finally:
            self._force_cg = old

    def multi_step(self, *args, **kwargs):
        raise NotImplementedError(
            "not ported yet (ROADMAP.md: multi_step / --chunk)")

    # ------------------------------------------------------------------
    def _dt_scaling_const(self) -> float:
        return 0.25 / (2.1 * 3 * math.sqrt(3.0))

    def compute_time_step(self, cfl: float) -> float:
        """The reference's CFL formula (boussinesq_model.tpp:1104-1125)."""
        deg = max(self.params.temperature_degree,
                  self.params.nse_velocity_degree)
        return self._dt_scaling_const() / (deg * max(cfl, 1e-30))

    def _fast_penalty(self) -> int:
        return getattr(self, "_fast_penalty_now", self._fast_rearm_steps)

    def _escalate(self) -> None:
        """Open (or re-open) the full-CG escalation window; each repeat
        miss doubles it up to ``_fast_rearm_cap``."""
        pen = self._fast_penalty()
        self._strong_steps_left = pen
        self._fast_penalty_now = min(2 * pen, self._fast_rearm_cap)
        self.escalations += 1

    # ------------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None, callback=None,
            state: Optional[State] = None) -> Tuple[State, List[Dict]]:
        """Time loop mirroring the reference's run()
        (boussinesq_model.tpp:1785-1927) with the re-arming CG
        escalation. Starts from ``state`` (default: the initial state).
        Returns the final state and per-step diagnostic records."""
        p = self.params
        if state is None:
            state = self.initial_state()
        dt = p.time_step
        history: List[Dict] = []
        time_index = float(state.time)
        n = 0
        while time_index <= p.final_time:
            if max_steps is not None and n >= max_steps:
                break
            state_prev = state
            escalated = self._strong_steps_left > 0
            if escalated:
                # escalation window: full-CG steps; each clean one counts
                # toward re-arming the fast path
                state, diag = self.step_strong(state, dt)
                if diag.solver_ok:
                    self._strong_steps_left -= 1
            else:
                state, diag = self.step(state, dt)
            if not escalated and p.numerics.fixed_solver_iters > 0:
                if not diag.solver_ok:
                    # redo the step with full CG (NoConvergence retry)
                    self._escalate()
                    state, diag = self.step_strong(state_prev, dt)
                else:
                    self._fast_penalty_now = self._fast_rearm_steps
            rec = {
                "step": n,
                "time": time_index,
                "dt": dt,
                "cfl": float(diag.cfl),
                "max_velocity": float(diag.max_velocity),
                "T_min": float(diag.T_min),
                "T_max": float(diag.T_max),
                "div_norm": float(diag.div_norm),
                "poisson_iters": int(diag.poisson_iters),
                "temperature_iters": int(diag.temperature_iters),
            }
            history.append(rec)
            if callback is not None:
                callback(state, rec)
            time_index += dt / p.NSE_solver_interval
            n += 1
            if p.adapt_time_step and n % p.NSE_solver_interval == 0:
                dt = self.compute_time_step(float(diag.cfl))
        return state, history
