"""MimeticBoussinesqModel — the staggered C-grid FEEC personality on
PyTorch (counterpart of the JAX package's ``models/mimetic.py``).

The structure-preserving counterpart of the reference's
ExteriorCalculus::BoussinesqModel (reference:
include/core/boussineq_model_FEEC.{h,tpp}): the FACE-NORMAL velocities
are the prognostic variables on the MAC lattice, and the dynamics go
through the discrete de Rham complex of ops/staggered.py:

  * advection is the vector-invariant rotational form
    omega x u + grad|u|^2/2 with omega the EDGE vorticity
    (reference explicit advection: FEEC.tpp:786-805), Sadourny
    double-averaged; Coriolis enters as planetary vorticity added to the
    edge vorticity before the cross product;
  * viscosity is the mimetic -curl(curl u) (FEEC.tpp:753-769), solved
    implicitly by Jacobi-CG on the SPD operator W + dt/Re C^T M C;
  * the pressure projection acts on the prognostic faces through the
    parent's ``_solve_pressure_poisson`` (any `poisson solver`): div u = 0
    to the solve's accuracy afterwards, and the correction never changes
    the discrete vorticity.

Geometries: the 3D box (z walls, or fully periodic), the 2D slab, the
annulus and the shell (the half-turn antipodal ghost rules for the edge
algebra, mirrored |cos| ghost metrics, zero-area polar dual loops with
zero vorticity and zero viscous weight). Everything else — the
temperature solve (K4 with ``helmholtz solver = direct`` on the shell
and the annulus), ``run`` with its gate and escalation, ``multi_step``,
the temperature substeps, the I/O — is inherited; the temperature is
transported in the conservative flux form with the prognostic faces.
The step runs no other hand kernel: as in the JAX package it is plain
array code throughout, so the shell's K1, K2, K3 and K5 wrappers are not
built. Its momentum CG reads its stopping test back every iteration, so
``multi_step`` chunks run eagerly (no CUDA graph). On a mesh of the shell
(``prepare_sharded``) the same step runs on the shards: the staggered
operators on each shard's window (parallel/sharded_mimetic.py), the CG
and the projection with the mesh's inner product and sharded solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dycoreplanet_tpu_torch.base import nondim
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.models.boussinesq import (
    BoussinesqModel, State, _as_dtype, _MeshStages)
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.staggered import StaggeredOps
from dycoreplanet_tpu_torch.parallel.mesh import Mesh, Sharded, is_sharded
from dycoreplanet_tpu_torch.parallel.sharded_mimetic import (
    ShardedStaggered, StagFields)
from dycoreplanet_tpu_torch.solvers.cg import cg


class MimeticBoussinesqModel(BoussinesqModel):
    """Staggered (C-grid) structure-preserving Boussinesq driver."""

    def __init__(self, params: Parameters,
                 geometry: Optional[Geometry] = None, device=None):
        super().__init__(params, geometry, device)
        geo = self.geo
        self.stag = StaggeredOps(geo, self.u_specs, self.p_specs)
        sg = self.stag
        dtn = self.dtype

        # face mass weights w = A*h in the cell-shaped layout, the Jacobi
        # diagonal of the viscous operator, and gravity at the axis-0
        # faces (the radial law of the cell-centred field,
        # core_model_data.tpp:97-106): made in numpy as in the JAX model,
        # put on the device once; the host arrays (the working dtype's
        # values) stay for a mesh's shards (parallel/sharded_mimetic.py)
        self._w_stack_host = self._host(np.stack([
            np.broadcast_to(st._left_metric(geo, d, sg.w_face[d]),
                            geo.cell_shape).astype(dtn)
            for d in range(geo.dim)]))
        self._cc_diag_host = self._host(np.stack([
            np.broadcast_to(np.asarray(dg), geo.cell_shape).astype(dtn)
            for dg in sg.curlcurl_diag()]))
        self._w_stack = self._tensor(self._w_stack_host)
        self._cc_diag = self._tensor(self._cc_diag_host)
        g0 = params.physical_constants.gravity_constant
        if geo.kind == "cuboid":
            g0f = np.full(geo.cell_shape, -g0)
        else:
            rf = np.asarray(geo.axes[0].faces[:-1])  # left faces
            grf = np.where(rf > 1.0, -g0, -g0 * np.sqrt(np.maximum(rf, 0.0)))
            shape1 = (geo.cell_shape[0],) + (1,) * (geo.dim - 1)
            g0f = np.broadcast_to(grf.reshape(shape1), geo.cell_shape)
        self._gravity_face0_host = self._host(
            (self.g_hat_scale * g0f).astype(dtn))
        self._gravity_face0 = self._tensor(self._gravity_face0_host)

        # planetary vorticity on the shell's edges (physical mode):
        # 2 Omega sin(lat) at the r-edges (lat faces), 2 Omega cos(lat)
        # at the lat-edges (lat centres)
        self._plan_vort0 = self._plan_vort1 = self._plan_vort_host = None
        if geo.kind == "shell":
            om = 2.0 * self.omega_hat
            lat_f = np.asarray(geo.axes[1].faces, np.float64)
            lat_c = np.asarray(geo.axes[1].centers, np.float64)
            self._plan_vort_host = tuple(self._host(a.astype(dtn)) for a in (
                (om * np.sin(lat_f)).reshape(1, -1, 1),
                (om * np.cos(lat_c)).reshape(1, -1, 1)))
            self._plan_vort0, self._plan_vort1 = (
                self._tensor(a) for a in self._plan_vort_host)

    def _build_shell_kernels(self, forcing: dict) -> None:
        """None: the mimetic step runs none of the shell's kernels."""

    def prepare_sharded(self, mesh: Mesh, kernels: bool = True
                        ) -> "MimeticBoussinesqModel":
        """Set this model up for sharded states on the geometry's mesh
        (the shell's ("lat", "lon"), the box's ("y", "x"), the annulus's
        ("phi",), the slab's ("x",); the JAX package runs the mimetic
        step there through GSPMD's plain path): the staggered operators
        on every shard's window (parallel/sharded_mimetic.py), the
        momentum Jacobi-CG and the temperature solve on the shards (the
        sharded direct solve with ``helmholtz solver = direct``, K4 once
        a device), the projection with the geometry's sharded Poisson
        solve (Jacobi-CG with ``poisson solver = cg``) and the plain
        correction. The step runs no other hand kernel, so ``kernels``
        changes nothing."""
        from dycoreplanet_tpu_torch.parallel.sharded_transport import (
            ShardedSemiLagrangian)

        common = self._mesh_common(mesh)
        stag = ShardedStaggered(self, mesh)
        transport = (ShardedSemiLagrangian(self._semi_lagrangian, mesh)
                     if self._semi_lagrangian is not None
                     else stag.transport)
        self._mesh = _MeshStages(mesh=mesh, forcing=None, richardson=None,
                                 transport=transport, kernels=False,
                                 staggered=stag, **common)
        return self

    @property
    def _fixed_gate(self) -> bool:
        """The momentum solve is always CG here: the gate redoes a step
        only for the fixed-iteration temperature solve."""
        return self.params.numerics.fixed_solver_iters > 0

    def _graphable(self, adaptive: bool, force_cg: bool) -> bool:
        """Never: the momentum CG reads its stopping test back every
        iteration."""
        return False

    # ------------------------------------------------------------------
    def _face_tendency(self, U, pres, T, fields: StagFields = None):
        """Explicit face-normal momentum tendency from step n:
        vector-invariant advection + Coriolis (as planetary vorticity) +
        buoyancy + grad p^n (incremental). Full-face input, list of
        full-face outputs. ``fields``: the operators and face constants
        of the grid (default) or of a shard's window on a mesh."""
        geo = self.geo
        num = self.params.numerics
        f = self._grid_fields() if fields is None else fields
        sg = f.stag
        dim = geo.dim

        zeta = sg.vorticity(U)
        if dim == 2:
            # q = zeta_cyc + f; the reference's 2D Coriolis is the
            # unscaled 2 u_perp (boussinesq_model.tpp:663-667)
            f_cor = (2.0 if self.coriolis_mode == "reference"
                     else 2.0 * self.omega_hat)
            q = zeta + f_cor
        else:
            # q = -zeta_cyc + 2 Omega_hat (z_hat . e_c) (left-handed array
            # order, ops/staggered.py). Cuboid: rotation about array axis
            # 0 in both modes. Shell: "reference" adds no Coriolis (the
            # reference's 3D shell quirk), "physical" the planetary
            # vorticity z_hat = sin(lat) r_hat + cos(lat) lat_hat at the
            # edge latitudes
            om = 2.0 * self.omega_hat
            if geo.kind == "cuboid":
                q = [-zeta[0] + om, -zeta[1], -zeta[2]]
            elif self.coriolis_mode == "physical":
                q = [-zeta[0] + f.plan_vort0,
                     -zeta[1] + f.plan_vort1, -zeta[2]]
            else:
                q = [-zeta[0], -zeta[1], -zeta[2]]
        tend = sg.cross(q, U)

        gradK = sg.grad_faces(sg.kinetic_energy(U), self.p_specs)
        tend = [tend[d] - gradK[d] for d in range(dim)]

        # buoyancy: rho(T) g on the gravity-axis faces (the well-balanced
        # perturbation split of the parent)
        rho = nondim.density_scaling(self.beta, T, self.T_ref)
        if num.buoyancy == "perturbation":
            rho = rho - self.rho_background
        rho_f = sg.avg_c2f(rho, 0, self.p_specs[0])
        gf = f.gravity_face0
        # full faces: the cell-shaped gravity padded with its wall value
        # (the tendency at walls is dropped by contract)
        if not geo.axes[0].periodic:
            gf = torch.cat([gf, gf[-1:]], dim=0)
        tend[0] = tend[0] + rho_f * gf

        if num.projection == "incremental":
            gp = sg.grad_faces(pres, self.p_specs)
            tend = [tend[d] - gp[d] for d in range(dim)]
        return tend

    def _grid_fields(self) -> StagFields:
        """The whole grid's operators and face constants."""
        return StagFields(self.stag, self._gravity_face0, self._plan_vort0,
                          self._plan_vort1)

    def _face_rhs(self, u_faces, pres, T, dt: float,
                  fields: StagFields = None) -> torch.Tensor:
        """The stacked cell-shaped faces U + dt * tendency: the right-hand
        side of the viscous solve (``fields`` as ``_face_tendency``'s)."""
        sg = self.stag if fields is None else fields.stag
        U = sg.expand(list(u_faces))
        tend = self._face_tendency(U, pres, T, fields)
        return torch.stack(sg.contract(
            [U[d] + dt * tend[d] for d in range(self.geo.dim)]))

    # ------------------------------------------------------------------
    def _solve_momentum_mimetic(self, uf_star_rhs, dt: float):
        """Implicit mimetic viscous solve: (W + dt/Re C^T M C) u* =
        W rhs on the stacked cell-shaped face layout (SPD; Jacobi-CG; the
        reference's w-u coupling block of the 3x3 FEEC system,
        FEEC.tpp:753-769). Jacobi-Richardson does not converge here at
        production grids (the JAX package's measurement), so CG it is."""
        sg = self.stag
        dim = self.geo.dim
        num = self.params.numerics
        coef = self._product(dt, self.one_over_Re)
        if isinstance(uf_star_rhs, Sharded):   # on a mesh
            ops = self._ops(uf_star_rhs)
            stag = self._mesh.staggered
            w, cc_diag = stag.memo(ops.dtype, lambda: (
                ops.cut(self._w_stack_host, ops.dtype),
                ops.cut(self._cc_diag_host, ops.dtype)))
            curlcurl = stag.curlcurl
        else:
            ops = self._grid_ops
            w, cc_diag = self._w_stack, self._cc_diag

            def curlcurl(x):
                U = sg.expand([x[d] for d in range(dim)])
                return torch.stack(sg.contract(sg.curlcurl_weighted(U)))

        def helm_op(x):
            return w * x + coef * curlcurl(x)

        diag = w + coef * cc_diag
        res = cg(helm_op, w * uf_star_rhs, x0=uf_star_rhs,
                 rtol=self._rtol(num.helmholtz_tol),
                 maxiter=num.max_cg_iters,
                 preconditioner=lambda r: r / diag, dot=ops.dot)
        return res.x, res.iterations, res.residual_norm, res.converged

    # ------------------------------------------------------------------
    def _step_impl(self, state: State, dt: float, full: bool = True):
        """One mimetic NSE step (JAX model: ``_step_body``). Returns
        (new_state, packed diagnostics, ok) as the parent's."""
        if is_sharded(state):
            return self._mesh_step(state, dt, full)
        if self._in_float32(state):
            return self._float32_step(self._step_impl, state, dt, full)
        geo = self.geo
        p = self.params
        sg = self.stag
        dim = geo.dim
        vol = self._vol_t
        pres, T = state.p, state.T
        dt = self._scalar(dt)
        dt_T = self._dt_T(dt)

        # ---------------- explicit tendency on the faces ---------------
        rhs_faces = self._face_rhs(state.u_faces, pres, T, dt)

        # ---------------- implicit mimetic viscosity -------------------
        u_star, helm_it, helm_rnorm, helm_ok = self._solve_momentum_mimetic(
            rhs_faces, dt)
        uf_star = [self._apply_wall_face_values(u_star[d], d)
                   for d in range(dim)]

        # ---------------- pressure projection on the faces -------------
        rhs_phi = -vol * st.divergence(geo, uf_star) / dt
        rhs_phi = rhs_phi - torch.mean(rhs_phi)
        phi, poisson_iters, poisson_rnorm, poisson_ok = \
            self._solve_pressure_poisson(rhs_phi)
        phi = phi - st.volume_mean(geo, phi)
        new_faces = [self._apply_wall_face_values(
            uf_star[d] - dt * st.grad_left_faces(geo, phi, d,
                                                 self.p_specs[d]), d)
            for d in range(dim)]
        p_new = pres + phi if p.numerics.projection == "incremental" else phi
        if p.correct_pressure_to_zero_mean:
            p_new = p_new - st.volume_mean(geo, p_new)

        # diagnostic cell-centred velocity (local-frame components)
        U_new = sg.expand(new_faces)
        u_new = torch.stack([sg.avg_f2c(U_new[c], c) for c in range(dim)])

        # ---------------- temperature (conservative flux form) ---------
        T_adv = self._advected_temperature(state.u, state.u_faces, T, dt_T)
        kT = self._product(dt_T, self.one_over_Pe)
        rhs_T = vol * T_adv + kT * self._T_lap_offset_t
        T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
            rhs_T, kT, T)

        new_state = self._stored(State(
            u=u_new, u_faces=tuple(new_faces), p=p_new, T=T_new,
            time=self._advance_time(state.time, dt_T),
            step_number=state.step_number + 1))
        u_new, new_faces, T_new = (new_state.u, list(new_state.u_faces),
                                   new_state.T)
        ok = torch.logical_and(torch.logical_and(T_ok, poisson_ok), helm_ok)
        if not full:
            return new_state, None, self._f32(ok)
        speed = st.cell_max_speed(geo, u_new)
        cfl = torch.max(torch.clamp(speed, min=1e-10) / self._diameter_t)
        div_new = st.divergence(geo, new_faces)
        packed = self._pack(
            cfl, torch.max(speed), torch.min(T_new), torch.max(T_new),
            torch.max(torch.abs(div_new)), poisson_iters, T_iters,
            [helm_it] * dim, helmholtz_residual=helm_rnorm,
            poisson_residual=poisson_rnorm, temperature_residual=T_rnorm,
            solver_ok=ok)
        return new_state, packed, packed[10]

    def _mesh_step(self, state: State, dt: float, full: bool = True):
        """``_step_impl`` on a sharded state: the tendency, C^T M C and the
        cell velocity on the shards' windows (parallel/sharded_mimetic.py),
        the momentum Jacobi-CG and the temperature solve on the shards, the
        projection with the sharded Poisson solve and the plain
        correction; the step of one device, operation for operation. A
        bfloat16 state computes in float32 on the widened shards and the
        new state is rounded once, as on one device (``_in_float32``)."""
        mesh = self._mesh
        if mesh is None:
            raise ValueError("a sharded state needs prepare_sharded first")
        if state.T.dtype == torch.bfloat16:
            state = _as_dtype(state, torch.float32)
        stag = mesh.staggered
        ops = self._ops(state.T)
        p = self.params
        dim = self.geo.dim
        pres, T = state.p, state.T
        dt = self._scalar(dt)
        dt_T = self._dt_T(dt)

        rhs_faces = stag.apply(
            lambda w, *fw: self._face_rhs(
                fw[:dim], fw[dim], fw[dim + 1], dt,
                w.constants(fw[dim + 1].dtype)[0]),
            *state.u_faces, pres, T)
        u_star, helm_it, helm_rnorm, helm_ok = self._solve_momentum_mimetic(
            rhs_faces, dt)
        uf_star = ops.wall_faces([u_star.map(lambda x, d=d: x[d])
                                  for d in range(dim)])
        rhs_phi = ops.poisson_rhs(uf_star, dt)
        phi, poisson_iters, poisson_rnorm, poisson_ok = \
            self._solve_pressure_poisson(rhs_phi)
        # the face correction of the projection (the cell part unused)
        _, new_faces, p_new = ops.correct(
            self.p_specs, u_star, uf_star, phi, pres, dt,
            p.numerics.projection == "incremental")
        if p.correct_pressure_to_zero_mean:
            p_new = ops.less_volume_mean(p_new)
        u_new = stag.cell_velocity(new_faces)

        T_adv = mesh.transport(state.u, state.u_faces, T, dt_T)
        kT = self._product(dt_T, self.one_over_Pe)
        rhs_T = T_adv.map(lambda t, v, o: v * t + kT * o, ops.vol,
                          ops.T_lap_offset)
        T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
            rhs_T, kT, T)

        new_state = self._stored(State(
            u=u_new, u_faces=tuple(new_faces), p=p_new, T=T_new,
            time=self._advance_time(state.time, dt_T),
            step_number=state.step_number + 1))
        ok = torch.logical_and(torch.logical_and(T_ok, poisson_ok), helm_ok)
        if not full:
            return new_state, None, self._f32(ok)
        packed = self._mesh_pack(
            new_state.u, new_state.T, mesh.ops.divergence(new_state.u_faces),
            poisson_iters, T_iters, [helm_it] * dim,
            helmholtz_residual=helm_rnorm, poisson_residual=poisson_rnorm,
            temperature_residual=T_rnorm, solver_ok=ok)
        return new_state, packed, packed[10]

    # ------------------------------------------------------------------
    def _advected_temperature(self, u, u_faces, T, dt_T):
        """Conservative flux-form transport with the (divergence-free)
        prognostic face fluxes: the total heat sum(V T) is conserved
        exactly in flux-closed domains. The semi-Lagrangian transport is
        the parent's."""
        if self._semi_lagrangian is not None:
            return super()._advected_temperature(u, u_faces, T, dt_T)
        adv_T = st.advect_scalar(self.geo, list(u_faces), T, self.T_specs,
                                 scheme=self.advection_scheme, form="flux")
        return T - dt_T * adv_T

    # ------------------------------------------------------------------
    def faces_from_velocity(self, fn) -> tuple:
        """Sample an analytic velocity (callable: component index d,
        coordinate meshgrid tuple -> array) at the face-normal points;
        returns the cell-shaped face tuple (test/IC helper)."""
        geo = self.geo
        out = []
        for d in range(geo.dim):
            cs = [(a.faces[: a.n] if not a.periodic else a.faces)
                  if e == d else a.centers for e, a in enumerate(geo.axes)]
            mesh = np.meshgrid(*cs, indexing="ij")
            vals = np.asarray(fn(d, mesh), dtype=self.dtype)
            uf = self._tensor(np.broadcast_to(vals, geo.cell_shape))
            out.append(self._apply_wall_face_values(uf, d))
        return tuple(out)

    def state_from_faces(self, u_faces, T=None) -> State:
        """Initial state with prescribed staggered faces (the cell-centred
        velocity reconstructed by averaging)."""
        sg = self.stag
        U = sg.expand(list(u_faces))
        u = torch.stack([sg.avg_f2c(U[c], c) for c in range(self.geo.dim)])
        base = self.initial_state()
        return base._replace(
            u=u, u_faces=tuple(u_faces),
            T=base.T if T is None else self._tensor(np.asarray(T)))
