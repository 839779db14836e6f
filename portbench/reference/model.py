"""The plain reference of one benchmark configuration: the standard
personality's step on the shell and the annulus, as the port's
``BoussinesqModel._step_impl`` computes it on its plain path, written
out from the frozen copies beside this file and the configuration's own
numbers (it reads no object of the program):

  1. explicit forcing     rhs_u = u + dt forcing(u, u_faces, p, T)
                          T_adv = T - dt u . grad T           (Eulerian)
  2. Helmholtz predictor  (V - dt/Re L) u* = V rhs_u
  3. temperature          (V - dt/Pe L) T = V T_adv + dt/Pe L_offset
  4. Poisson projection   -L phi = -V div(U*)/dt   (fast diagonalization)
  5. correction           U = U* - dt grad_f phi, u = u* - dt grad_c phi,
                          p = p + phi

Steps 2-3 are ``fixed solver iters`` Jacobi-Richardson sweeps with their
residuals tracked (the shell), or the direct solves (the annulus with
``helmholtz solver = direct``). The gate's verdict of a step is the
Richardson residuals against their tolerances and the Poisson residual
spot-check, as the port gates a fast step.

``dtype`` is what the reference computes in (float64 for the
comparison); the scalars the port rounds to its working dtype (dt, the
solves' coefficients) are rounded the same way. ``tf32`` rounds every
matrix product's operands to TF32: the control.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import stencil as st
from .bc import BC, BCSpec
from .forcing import Forcing
from .grid import make_annulus, make_shell
from .projection import cell_to_faces, correct_plain, faces_div_plain
from .solvers import (AnnulusHelmholtzDirect, AnnulusPoissonFastDiag,
                      ShellPoissonFastDiag, cg, dot, richardson_solve,
                      weak_laplacian_diagonal)

WORKING = {"float32": torch.float32, "float64": torch.float64}


class Fields(NamedTuple):
    u: torch.Tensor                   # (dim, *cells)
    u_faces: Tuple[torch.Tensor, ...]
    p: torch.Tensor
    T: torch.Tensor


def _gaussian(p, center, precision, dim):
    d = p - torch.as_tensor(center, dtype=p.dtype, device=p.device)
    quad = precision * torch.sum(d * d, dim=-1)
    return (precision ** (dim / 2.0) * torch.exp(-0.5 * quad)
            / math.sqrt((2.0 * math.pi) ** dim))


class TemperatureIC:
    """The reference's double-Gaussian temperature of the shell and the
    annulus (physics/initial_data.py ``TemperatureInitialValues``)."""

    def __init__(self, dim: int, R0: float, R1: float, width_scale: float):
        dR = R1 - R0
        self.dim = dim
        self.precision = 20.0 / (dR / 2.0) / float(width_scale) ** 2
        self.amp = float(width_scale) ** dim
        self.c1 = np.zeros(dim)
        self.c1[0] = R0 + dR * 0.35
        self.c2 = np.zeros(dim)
        self.c2[1] = R0 + dR * 0.65
        if dim == 2:                    # R (R c), R the rotation by pi/3
            a = math.pi / 3.0
            R = np.asarray([[math.cos(a), -math.sin(a)],
                            [math.sin(a), math.cos(a)]])
            self.c1 = R @ (R @ self.c1)
            self.c2 = R @ (R @ self.c2)

    def __call__(self, p: torch.Tensor) -> torch.Tensor:
        return self.amp * (_gaussian(p, self.c1, self.precision, self.dim)
                           + _gaussian(p, self.c2, self.precision, self.dim))


def cartesian(geo, axis_values, device) -> torch.Tensor:
    """Cartesian points (*cells, dim) at the given axis values, float64."""
    grids = torch.meshgrid(*[torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                             device=device)
                             for a in axis_values], indexing="ij")
    if geo.kind == "annulus":
        r, phi = grids
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    r, lat, lon = grids
    return torch.stack([r * torch.cos(lat) * torch.cos(lon),
                        r * torch.cos(lat) * torch.sin(lon),
                        r * torch.sin(lat)], dim=-1)


class Settings(NamedTuple):
    """The numbers of one configuration that the step reads."""
    kind: str
    shape: Tuple[int, ...]
    R0: float
    R1: float
    one_over_Re: float
    one_over_Pe: float
    beta: float
    T_ref: float
    g_hat_scale: float
    gravity_constant: float
    omega_hat: float
    coriolis_mode: str
    buoyancy: str
    scheme: str
    incremental: bool
    zero_mean_p: bool
    fixed_iters: int
    momentum_iters: int
    direct: bool
    helmholtz_tol: float
    temperature_tol: float
    poisson_tol: float
    poisson_precision: str
    ic_width_scale: float
    max_cg_iters: int
    working: str


def settings(config: dict, shape) -> Settings:
    """``Settings`` from a configuration file's groups (portbench/configs)
    and the traffic's grid: the same derivations as the upstream
    parameter classes (Re = U L / nu, nu = mu / rho; Pe = U L / kappa,
    kappa = k / (c_p p); R1 = R0 + atm height; lengths over L)."""
    ref = config["reference_quantities"]
    pc = config["physical_constants"]
    num = config["numerics"]
    top = config
    U, L = ref["velocity"], ref["length"]
    nu = pc["dynamic_viscosity"] / pc["density"]
    kappa = pc["thermal_conductivity"] / (pc["specific_heat_p"]
                                          * pc["pressure"])
    mom = num.get("momentum_fixed_iters", 0) or num["fixed_solver_iters"]
    if top["NSE_solver_interval"] != 1 or top["use_FEEC_solver"]:
        raise ValueError("the reference steps the standard personality "
                         "with NSE solver interval 1")
    if num.get("temperature_advection", "eulerian") != "eulerian":
        raise ValueError("the reference transports T by the Eulerian scheme")
    return Settings(
        kind="shell" if top["space_dimension"] == 3 else "annulus",
        shape=tuple(shape), R0=pc["R0"] / L,
        R1=(pc["R0"] + pc["atm_height"]) / L,
        one_over_Re=1.0 / (U * L / nu), one_over_Pe=1.0 / (U * L / kappa),
        beta=pc["expansion_coefficient"], T_ref=ref["temperature_ref"],
        g_hat_scale=L / U ** 2, gravity_constant=pc["gravity_constant"],
        omega_hat=L * pc["omega"] / U,
        coriolis_mode=num.get("coriolis_mode", "reference"),
        buoyancy=num.get("buoyancy", "perturbation"),
        scheme=num.get("advection_scheme", "muscl"),
        incremental=num.get("projection", "incremental") == "incremental",
        zero_mean_p=bool(top["correct_pressure_to_zero_mean"]),
        fixed_iters=num["fixed_solver_iters"], momentum_iters=mom,
        direct=num.get("helmholtz_solver", "auto") == "direct",
        helmholtz_tol=num.get("helmholtz_tol", 1e-8),
        temperature_tol=num.get("temperature_tol", 1e-12),
        poisson_tol=num.get("poisson_tol", 1e-8),
        poisson_precision=num.get("poisson_precision", "auto"),
        ic_width_scale=num.get("ic_width_scale", 1.0),
        max_cg_iters=num.get("max_cg_iters", 500),
        working=num["dtype"])


class Reference:
    """The configuration's step in plain PyTorch on ``device``, computing
    in ``dtype``. With ``tables=False`` only the grid, the boundary rules
    and the initial temperature are made (what the seeded inputs need)."""

    def __init__(self, s: Settings, device, dtype=torch.float64,
                 tf32: bool = False, tables: bool = True):
        self.s = s
        self.device = torch.device(device)
        self.dtype = dtype
        wd = WORKING[s.working]
        self.eps = float(torch.finfo(wd).eps)
        self.round = lambda x: float(torch.tensor(float(x), dtype=wd))
        if s.kind == "shell":
            self.geo = geo = make_shell(*s.shape, s.R0, s.R1)
        else:
            self.geo = geo = make_annulus(*s.shape, s.R0, s.R1)
        AS, NEU = BC.ANTISYM, BC.NEUMANN
        if geo.kind == "annulus":
            self.u_specs = [[BCSpec(AS, AS), None], [BCSpec(AS, NEU), None]]
            self.p_specs = [BCSpec(NEU, NEU), None]
            rest = [None]
        else:
            PO, PF = BC.POLE, BC.POLE_FLIP
            self.u_specs = [[BCSpec(AS, AS), BCSpec(PO, PO), None],
                            [BCSpec(AS, NEU), BCSpec(PF, PF), None],
                            [BCSpec(AS, NEU), BCSpec(PF, PF), None]]
            self.p_specs = [BCSpec(NEU, NEU), BCSpec(PO, PO), None]
            rest = [BCSpec(PO, PO), None]
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=self.device)
        shape = geo.cell_shape
        vol = np.broadcast_to(geo.vol, shape)
        self.vol = t(vol)
        self.diameter = t(geo.cell_diameter())
        gvec = np.zeros((geo.dim,) + shape)
        r = np.broadcast_to(geo.extras["r_centers"], shape)
        g0 = s.gravity_constant
        gvec[0] = np.where(r > 1.0, -g0, -g0 * np.sqrt(r))
        ic = TemperatureIC(geo.dim, s.R0, s.R1, s.ic_width_scale)
        centers = [a.centers for a in geo.axes]
        wall = [geo.axes[0].faces[:1]] + centers[1:]
        # the port evaluates the Gaussians at coordinates of its working
        # dtype and rounds the result to it
        pts = lambda axes: cartesian(geo, axes, self.device).to(wd).double()
        T_init = ic(pts(centers)).to(wd)
        self.T_init = T_init
        if not tables:
            return
        T_wall = ic(pts(wall))[0].to(wd)
        # rho(volume-mean initial T), summed as the port sums its host
        # arrays of the working dtype
        hd = np.float64 if wd == torch.float64 else np.float32
        T0 = T_init.cpu().numpy().astype(hd)
        v0 = vol.astype(hd)
        T_mean0 = float((T0 * v0).sum() / v0.sum())
        rho_background = float(1.0 - s.beta * (T_mean0 - s.T_ref))
        self.T_specs = [BCSpec(BC.DIRICHLET, NEU,
                               lo_value=T_wall.to(dtype))] + rest
        self.T_specs_hom = [BCSpec(AS, NEU)] + rest
        zero = torch.zeros(shape, dtype=dtype, device=self.device)
        self.T_lap_offset = st.weak_laplacian(geo, zero, self.T_specs)
        self.forcing = Forcing(
            geo, beta=s.beta, T_ref=s.T_ref, rho_background=rho_background,
            gravity=s.g_hat_scale * gvec, one_over_Re=s.one_over_Re,
            omega_hat=s.omega_hat, coriolis_mode=s.coriolis_mode,
            buoyancy=s.buoyancy, scheme=s.scheme,
            include_gradp=s.incremental, u_specs=self.u_specs,
            p_specs=self.p_specs, T_specs=self.T_specs)
        if geo.kind == "shell":
            self.poisson = ShellPoissonFastDiag(geo, dtype, self.device, tf32)
            prec = s.poisson_precision
            prec_tol = {"auto": 256.0 * self.eps, "highest": 256.0 * self.eps,
                        "high": 1e-2, "high-refine": 1e-3}[prec]
        else:
            self.poisson = AnnulusPoissonFastDiag(geo, dtype, self.device,
                                                  tf32)
            prec_tol = max(256.0 * self.eps,
                           AnnulusPoissonFastDiag.check_amp * self.eps)
        self.check_tol = max(s.poisson_tol, prec_tol)
        self.helm_diags = t(np.stack([
            -weak_laplacian_diagonal(geo, self.u_specs[c])
            for c in range(geo.dim)]))
        self.T_diag = t(-weak_laplacian_diagonal(geo, self.T_specs_hom))
        self.helm_direct = self.temp_direct = None
        if s.direct:
            if geo.kind != "annulus":
                raise ValueError("the reference's direct solves are the "
                                 "annulus's")
            self.helm_direct = AnnulusHelmholtzDirect(
                geo, [self.u_specs[c][0] for c in range(geo.dim)], dtype,
                self.device, tf32)
            self.temp_direct = AnnulusHelmholtzDirect(
                geo, [self.T_specs_hom[0]], dtype, self.device, tf32)

    # ------------------------------------------------------------------
    def _fast_solve(self, op, b, x0, diag, iters, rtol):
        """The fast step's Jacobi-Richardson sweeps, their residual
        against ``rtol`` clamped to 16 eps of the working dtype (as the
        port gates them)."""
        return richardson_solve(op, b, x0, diag=diag, iters=iters,
                                rtol=max(rtol, 16.0 * self.eps))

    def _strong_solve(self, op, b, x0, diag, iters, rtol):
        """The strong step's Jacobi-CG to ``rtol``."""
        return cg(op, b, x0, rtol=rtol, maxiter=self.s.max_cg_iters,
                  preconditioner=lambda r: r / diag)

    def faces(self, u: torch.Tensor):
        """Face-normal velocities of a collocated field, wall faces 0."""
        return tuple(cell_to_faces(self.geo, self.u_specs, u))

    def _weak_lap(self, x, specs):
        return st.weak_laplacian(self.geo, x, specs)

    def step(self, f: Fields, dt: float, strong: bool = False):
        """One step: (new Fields, the gate's verdict as a bool tensor,
        the diagnostics {cfl, max_velocity, T_min, T_max, div_norm}).
        ``strong``: the step that redoes a missed one, every iterative
        solve by CG to its configured tolerance (the Poisson CG
        preconditioned by the fast solve), as the port's ``step_strong``;
        the direct solves stay direct."""
        s, geo, vol = self.s, self.geo, self.vol
        dt = self.round(dt)
        dt_T = self.round(dt)
        u, u_faces, pres, T = f
        rhs_u = u + dt * self.forcing.explicit_forcing(u, u_faces, pres, T)
        T_adv = self.forcing.advected_temperature(u_faces, T, dt_T)
        kT = self.round(self.round(dt_T) * self.round(s.one_over_Pe))
        coef = self.round(self.round(dt) * self.round(s.one_over_Re))
        rhs_T = vol * T_adv + kT * self.T_lap_offset
        if self.helm_direct is not None:
            u_star = self.helm_direct.solve(vol[None] * rhs_u, coef)
            T_new = self.temp_direct.solve(rhs_T[None], kT)[0]
            ok = torch.ones((), dtype=torch.bool, device=self.device)
        else:
            dim = geo.dim
            solve = self._strong_solve if strong else self._fast_solve

            def helm_op(x):
                return vol[None] * x - coef * torch.stack([
                    self._weak_lap(x[c], self.u_specs[c])
                    for c in range(dim)])

            def temp_op(x):
                return vol * x - kT * self._weak_lap(x, self.T_specs_hom)

            ru = solve(helm_op, vol[None] * rhs_u, rhs_u,
                       vol[None] + coef * self.helm_diags, s.momentum_iters,
                       s.helmholtz_tol)
            rT = solve(temp_op, rhs_T, T, vol + kT * self.T_diag,
                       s.fixed_iters, s.temperature_tol)
            u_star, T_new = ru.x, rT.x
            ok = torch.logical_and(ru.converged, rT.converged)
        *uf_star, rhs_raw, total = faces_div_plain(geo, self.u_specs,
                                                   u_star, dt)
        rhs_phi = rhs_raw - total / float(geo.n_cells)
        if strong:
            res = cg(lambda x: -self._weak_lap(x, self.p_specs), rhs_phi,
                     torch.zeros_like(rhs_phi), rtol=s.poisson_tol,
                     maxiter=s.max_cg_iters, preconditioner=self.poisson.solve)
            phi, ok = res.x, torch.logical_and(ok, res.converged)
        else:
            phi = self.poisson.solve(rhs_phi)
        u_new, *new_faces, p_new = correct_plain(
            geo, self.p_specs, u_star, uf_star, phi, pres, dt,
            st.volume_mean(geo, phi), incremental=s.incremental)
        if s.zero_mean_p:
            p_new = p_new - st.volume_mean(geo, p_new)
        # the Poisson residual spot-check: vol div(u_new) / dt is the
        # solve's residual; a noise floor of 16 eps of the face fluxes
        div_new = st.divergence(geo, new_faces)
        if not strong:
            rnorm = torch.sqrt(torch.sum((vol * div_new) ** 2)) / dt
            bnorm = torch.sqrt(dot(rhs_phi, rhs_phi))
            flux2 = sum(torch.sum((st.metric(geo, "area_l", d, u_star)
                                   * new_faces[d]) ** 2)
                        for d in range(geo.dim))
            floor = 16.0 * self.eps * torch.sqrt(flux2) / dt
            ok = torch.logical_and(ok,
                                   rnorm <= self.check_tol * bnorm + floor)
        speed = st.cell_max_speed(geo, u_new)
        diag = dict(cfl=torch.max(torch.clamp(speed, min=1e-10)
                                  / self.diameter),
                    max_velocity=torch.max(speed), T_min=torch.min(T_new),
                    T_max=torch.max(T_new),
                    div_norm=torch.max(torch.abs(div_new)))
        return Fields(u_new, tuple(new_faces), p_new, T_new), ok, diag
