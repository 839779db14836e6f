"""BoussinesqModel — the time stepper of the shell, the annulus and the
cuboid on PyTorch (counterpart of the JAX package's
``models/boussinesq.py``).

Solves the nondimensional rotating buoyancy Boussinesq system with the
IMEX-Euler splitting and the incremental pressure projection:

  1. explicit forcing     rhs_u = u + dt (-adv u + cor u + buoy T
                                          + visc_curv u - grad p)     [K2]
  2. Helmholtz predictor  (V - dt/Re L) u* = V rhs_u
  3. temperature          (V - dt/Pe L) T = V T_adv + dt/Pe L_offset
  4. Poisson projection   -L phi = -V div(U*)/dt  (fast diagonalization)
  5. correction           U = U* - dt grad_f phi, u = u* - dt grad_c phi,
                          p = p + phi                                  [K5]

On the fast path steps 2-3 are fixed-iteration Jacobi-Richardson
solves with the projection head fused (kernel K1, ops/richardson.py).
Their exactly tracked residuals and the Poisson residual spot-check
gate every step; a miss redoes the step with full CG (``step_strong``),
which runs the faces_div kernel K3 (ops/projection.py) — the
reference's NoConvergence retry, boussinesq_model.tpp:1203-1232. With
``helmholtz solver = direct`` steps 2-3 are exact fast-diagonalization
solves whose radial tridiagonals go through K4 (solvers/helmholtz.py,
ops/tridiag.py), followed by K3; only the Poisson spot-check gates
them. Every projection ends in the correction kernel K5. The JAX
model's ``_explicit_forcing`` and Eulerian ``_advected_temperature``
are ``Forcing.explicit_forcing`` / ``.advected_temperature`` here
(ops/forcing.py), the plain version of K2 on the shell. With ``temperature advection =
semi-lagrangian`` the step runs K2m, the forcing without the transport,
and the temperature is transported by ops/semi_lagrangian.py with the
cell velocity of step n, in the NSE step and in every temperature
substep (``_advected_temperature``).

With ``residual check interval`` = M > 1 the tracked K1 (and its gate)
runs on every M-th step and K1's residual-free variant K1u in between
(residual norms -1, "not checked"); ``run`` then rewinds a missed check
over the unchecked window. With ``NSE solver interval`` > 1 the steps
between NSE solves are temperature-only substeps
(``temperature_step``: plain PyTorch transport and a Richardson, CG or
direct temperature solve, as in the JAX package). ``multi_step`` runs a
chunk of steps with the chunk-level gate and escalation; on the card a
chunk with a fixed dt that runs no CG is one replay of a captured CUDA
graph (models/graphs.py).

On the 2D annulus and the cuboid (the 3D box, periodic in x and y with
z walls, or fully periodic, and the 2D (z, x) slab) the JAX package
builds none of its Pallas kernels but K4 (its factories return None off
the shell), and neither does the port: the step is the model's own plain
PyTorch, operation for operation the JAX package's jnp path
(``_explicit_forcing``, the Eulerian ``_advected_temperature``,
Jacobi-Richardson solves that track every residual, with CG escalation,
the projection and the geometry's fast-diagonalization Poisson solve),
chosen when the model is built from ``geo.kind``. With ``helmholtz
solver = direct`` the annulus Helmholtz solves run K4, two launches a
step; the cuboid's are full fast diagonalizations, no K4 (the 2D slab
has no direct solver, as in the JAX package).

On a mesh of shards (``prepare_sharded``: one process, the shards on
one or more devices, or W processes, each its own block of shards on
its card; parallel/) the shell step runs the forcing and the
Richardson stage as K2o and K1o on every shard (parallel/sharded_pallas.py,
parallel/sharded_richardson.py), the Poisson solve as
``ShardedShellPoissonFastDiag``, and the rest in plain PyTorch on the
shards (parallel/sharded_step.py); a semi-Lagrangian model runs K2mo
(K2m's operands mode) and the transport on the shards
(parallel/sharded_transport.py), and temperature substeps run the
transport and the temperature solve on the shards. Where K1o does not
run (escalated steps, ``step_verbose``, configurations outside its
gates, ``prepare_sharded(mesh, kernels=False)``) the model's own
Richardson and CG solves run on the shards: they take the whole grid's
operators (``_GridOps``) or the mesh's (``ShardedStep``), and the
one loop of solvers/ runs on global and on Sharded fields. ``step``,
``step_strong``, ``step_verbose``, ``temperature_step``, ``run`` and
``multi_step`` take a sharded state and run eagerly. The annulus, the
box and the slab run on their own meshes (("phi",), ("y", "x"), ("x",):
parallel/mesh.py) with the same plain stages, the plain forcing and
transport on the shards, and their sharded fast diagonalizations
(solvers/spectral.py).

``step_verbose`` (`solver diagnostics level` >= 3) also returns each
solve's residual trail; as in the JAX model it takes the unfused branch
(K1 records no iterate's residual), so K2, K3 and K5 run, not K1.

The FEEC personality (``use FEEC solver = true``) advects in the
rotational form omega x u + grad(|u|^2 / 2) (ops/vector.py), in the
plain forcing on every geometry: the JAX package builds no forcing
kernel for it, so neither K2 nor K2m runs; with ``momentum solver =
projection`` the step is otherwise the standard one (K1, K1u, K3, K5 on
the shell). ``momentum solver = coupled`` (the default for FEEC)
replaces the predictor and the projection by a monolithic
velocity-pressure solve with Rhie-Chow faces, plain PyTorch as it is
jnp in the JAX package, which runs no kernel there: the 2x2 system by
block-preconditioned FGMRES(30) with a strong-preconditioner retry, or
its pressure Schur complement by GMRES around an inner CG (``use schur
complement solver``), and on the FEEC shell the 3x3
vorticity-velocity-pressure system by flexible FGMRES(16)
(solvers/gmres.py, linear_algebra/). Its temperature solve is the
standard one (K4 with ``helmholtz solver = direct``). The Krylov loops
read their stopping tests back every iteration, so coupled chunks run
eagerly. On a mesh the coupled solves run the same loops on Sharded
block vectors, their blocks the mesh's operators, and the plain forcing
and transport on the shards (``ShardedPlainForcing``).

The Poisson solve (``_solve_pressure_poisson``, shared with the mimetic
model) is the fast diagonalization by default; ``poisson solver = mg``
runs CG preconditioned by a multigrid V-cycle whose line smoother runs
K4 (solvers/multigrid.py), ``= cg`` Jacobi-CG. Both read their stopping
tests back every iteration, so their chunks run eagerly. On a mesh the
V-cycle relaxes along the radial lines alone, as the JAX package's mesh
rebuilds it, K4 on every shard's own columns (``ShardedPoissonMultigrid``;
the shell and the annulus; the walled box's V-cycle smooths by Jacobi);
the stretched shell's spectral CG runs whole on every distinct device
after one field-sized sum (``ShardedShellPoissonSpectral``). With
``helmholtz solver = direct`` the mesh step runs the sharded direct
solves (solvers/helmholtz.py: one field-sized sum, then K4 once a
device on one device's layout; the box's matrix products), K3's plain
faces and divergence, the sharded Poisson solve and the plain
correction.

This slice runs the 3D spherical shell, the 2D annulus and the cuboid,
both personalities (FEEC in its collocated realization here, and in its
mimetic C-grid one, ``models/mimetic.py``, built by ``make_model``; the
FEEC 3x3 solve and the rotational form need a 3D curl, so the 2D slab
runs the collocated standard personality only, as in the JAX package),
incremental projection or the coupled solves, with the Richardson/CG or
the direct Helmholtz solves, and every Poisson strategy, on one device
and on the mesh. A parameter outside these raises ``NotImplementedError``
(base/params.py); none quietly runs another path.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch import linear_algebra as la
from dycoreplanet_tpu_torch.base import dtypes, nondim
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.factory import make_geometry
from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.ops.diagonal import weak_laplacian_diagonal
from dycoreplanet_tpu_torch.ops.forcing import Forcing, ShellForcing
from dycoreplanet_tpu_torch.ops.projection import (
    ShellProjection, apply_wall_face_values, cell_to_faces, correct_plain,
    faces_div_plain)
from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson
from dycoreplanet_tpu_torch.ops.semi_lagrangian import SemiLagrangian
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, Sharded, is_sharded, shard_state)
from dycoreplanet_tpu_torch.physics.closures import radial_gravity_scalar
from dycoreplanet_tpu_torch.physics.initial_data import (
    TemperatureInitialValues, TemperatureInitialValuesCuboid)
from dycoreplanet_tpu_torch.solvers.cg import _dot, _zeros_like, cg
from dycoreplanet_tpu_torch.solvers.fixed import richardson_solve
from dycoreplanet_tpu_torch.solvers.gmres import gmres
from dycoreplanet_tpu_torch.solvers.helmholtz import make_helmholtz_solver
from dycoreplanet_tpu_torch.solvers.multigrid import PoissonMultigrid
from dycoreplanet_tpu_torch.solvers.spectral import make_poisson_solver

class State(NamedTuple):
    u: torch.Tensor                     # (dim, *cells) velocity, local frame
    u_faces: Tuple[torch.Tensor, ...]   # cell-shaped LEFT-face velocities
    p: torch.Tensor                     # (*cells) pressure
    T: torch.Tensor                     # (*cells) temperature
    time: float
    step_number: int


def _as_dtype(state: State, dtype: torch.dtype) -> State:
    """``state`` with its fields in ``dtype`` (the same tensors where they
    have it)."""
    c = lambda x: x.to(dtype)  # noqa: E731
    return state._replace(u=c(state.u), u_faces=tuple(
        c(f) for f in state.u_faces), p=c(state.p), T=c(state.T))


class _MeshStages(NamedTuple):
    """The stages of the mesh step (``prepare_sharded``)."""
    mesh: Mesh
    forcing: object          # ShardedShellForcing (K2o, or K2mo for SL,
                             # on every shard; their plain versions with
                             # kernels=False); None for the mimetic model
    richardson: object       # ShardedShellRichardson (K1o on every
                             # shard), or None where its gates fail or
                             # kernels=False: the plain solves
    poisson: object          # the sharded fast diagonalization or
                             # spectral CG, or None (poisson solver = cg
                             # | mg)
    ops: object              # ShardedStep: the plain rest
    transport: object        # ShardedSemiLagrangian (SL: every step and
                             # substep) or ShardedPlainForcing (Eulerian:
                             # the substeps, and the steps without K2o),
                             # the mimetic model's flux-form transport
    kernels: bool            # False: prepare_sharded(mesh, kernels=False)
    staggered: object = None  # the mimetic model's ShardedStaggered
    plain_forcing: object = None  # ShardedPlainForcing: the forcing
                             # where no K2o runs (the coupled solves, the
                             # rotational form); None for the mimetic
                             # model
    multigrid: object = None  # ShardedPoissonMultigrid (poisson solver =
                             # mg): the CG's preconditioner
    helmholtz: object = None  # the sharded direct momentum solve
                             # (helmholtz solver = direct), else None
    temperature: object = None  # the sharded direct temperature solve


class StepDiagnostics:
    """Per-step diagnostics packed into ONE float32 device vector, slot
    for slot as in the JAX package: [cfl, max|u|, T_min, T_max,
    max|div u|, poisson_iters, temperature_iters, helmholtz_residual,
    poisson_residual, temperature_residual, solver_ok, helmholtz_iters
    x dim] (``BoussinesqModel._pack``). The host pays one device->host
    copy when a field is first read; a host row (numpy, one row of a
    multi_step chunk already pulled) is read as it is. Iteration counts
    / residuals of -1 mean "direct solve, not measured" or, for the
    residuals in interval mode, "not checked on this step"."""

    def __init__(self, packed, dim: int):
        self.packed = packed
        self._dim = dim
        self._host_vals: Optional[np.ndarray] = (
            packed if isinstance(packed, np.ndarray) else None)

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


class _GridOps:
    """The whole grid's side of the operators the model's solves take
    (``ShardedStep``, parallel/sharded_step.py, is a mesh's), so that
    one Richardson, CG and GMRES code and one set of coupled blocks run
    on global fields and on Sharded ones (``BoussinesqModel._ops``)."""

    dot = staticmethod(_dot)
    total = None        # no mesh to sum over (the solvers' default)

    def __init__(self, model: "BoussinesqModel"):
        self.geo = model.geo
        self.vol = model._vol_t
        self.T_diag = model._T_diag_t
        self.helm_diags = model._helm_diags_t
        self.poisson_diag = model._poisson_diag_t

    def weak_laplacian(self, x, specs):
        return st.weak_laplacian(self.geo, x, specs)

    def vector_laplacian(self, u, u_specs):
        return torch.stack([st.weak_laplacian(self.geo, u[c], u_specs[c])
                            for c in range(self.geo.dim)])

    def gradient(self, x, specs):
        return torch.stack([st.centered_gradient(self.geo, x, d, specs[d])
                            for d in range(self.geo.dim)])

    def cell_faces(self, u_specs, u):
        return cell_to_faces(self.geo, u_specs, u)

    def grad_faces(self, x, specs):
        return [st.grad_left_faces(self.geo, x, d, specs[d])
                for d in range(self.geo.dim)]

    def wall_faces(self, faces):
        return [apply_wall_face_values(self.geo, f, d)
                for d, f in enumerate(faces)]

    def divergence(self, faces):
        return st.divergence(self.geo, faces)

    def curl(self, u, u_specs):
        return vec.curl_3d(self.geo, u, u_specs)

    @staticmethod
    def less_mean(x):
        return x - torch.mean(x)

    def less_volume_mean(self, x):
        return x - st.volume_mean(self.geo, x)


def _rows(x, i: int, j: Optional[int] = None):
    """x[i:j] (x[i] for j None) of a block vector, global or Sharded."""
    take = (lambda t: t[i]) if j is None else (lambda t: t[i:j])
    return x.map(take) if isinstance(x, Sharded) else take(x)


def _block(ndim: int, *parts):
    """The block vector of ``parts`` along a new leading axis (a part of
    ``ndim`` axes, one cell field, counts one row), global or Sharded."""
    def cat(*ts):
        return torch.cat([t if t.dim() > ndim else t[None] for t in ts], 0)
    if isinstance(parts[0], Sharded):
        return parts[0].map(cat, *parts[1:])
    return cat(*parts)


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
        self.device = resolve_device(device)
        self.params = params
        self._consts: Dict[Tuple[float, torch.dtype], torch.Tensor] = {}
        self.geo = geometry if geometry is not None else make_geometry(params)
        num = params.numerics
        self.torch_dtype = dtypes.TORCH[num.dtype]
        # the host constants' numpy dtype: float32 arrays of
        # bfloat16-rounded values for a bfloat16 model (base/dtypes.py)
        self.dtype = np.dtype(dtypes.host_dtype(self.torch_dtype))
        self.eps = dtypes.eps(self.torch_dtype)
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
        self.advection_form = ("rotational" if params.use_FEEC_solver
                               else "advective")
        # 'auto': FEEC runs the monolithic coupled system, as the
        # reference's FEEC configs do (boussineq_model_FEEC.tpp:1268-1477);
        # the standard personality the projection
        ms = num.momentum_solver
        if ms == "auto":
            ms = "coupled" if params.use_FEEC_solver else "projection"
        self.momentum_solver = ms
        self.momentum_iters = num.momentum_fixed_iters or num.fixed_solver_iters
        # the coupled FGMRES's retry with the stronger preconditioner on
        # outer non-convergence (reference: boussinesq_model.tpp:1203-1232);
        # the tests turn it off to show the stiff-config failure it prevents
        self._enable_solver_fallback = True

        self._setup_bcs()
        self._setup_static_fields()
        # the shell's hand kernels K1, K1u, K2 / K2m, K3 and K5; on the
        # annulus the step is the model's plain PyTorch (the JAX package's
        # jnp path), and only the direct solves' K4 is a hand kernel
        forcing = dict(
            beta=self.beta, T_ref=self.T_ref,
            rho_background=self.rho_background, gravity=self.gravity,
            one_over_Re=self.one_over_Re, omega_hat=self.omega_hat,
            coriolis_mode=self.coriolis_mode, buoyancy=num.buoyancy,
            scheme=self.advection_scheme,
            include_gradp=num.projection == "incremental",
            u_specs=self.u_specs, p_specs=self.p_specs,
            T_specs=self.T_specs, advection_form=self.advection_form)
        self._forcing = self._proj = None
        self._richardson = self._richardson_free = None
        # semi-Lagrangian temperature transport (K = 2 ghost layers, the
        # JAX package's default) on every geometry, its tables on the
        # device from the start
        self._semi_lagrangian = None
        if num.temperature_advection == "semi-lagrangian":
            self._semi_lagrangian = SemiLagrangian(self.geo, self.T_specs)
            self._semi_lagrangian.tables(self._vol_t.device,
                                         self.torch_dtype)
        if self.geo.kind == "shell":
            self._build_shell_kernels(forcing)
        # the plain forcing and Eulerian transport (ShellForcing is one)
        self._plain_forcing = self._forcing or Forcing(self.geo, **forcing)
        # the CUDA graphs of multi_step's chunks (models/graphs.py),
        # made at the first chunk on the card
        self.chunk_graphs = None
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
        # True inside step_verbose: the solves record their residual
        # trails into _trace_sink (`solver diagnostics level` >= 3)
        self._solver_trace = False
        self._trace_sink: List[Tuple[str, torch.Tensor]] = []
        # the mesh step's stages (prepare_sharded)
        self._mesh = None

    def _build_shell_kernels(self, forcing: dict) -> None:
        """The wrappers of the shell's hand kernels, gated as the JAX
        package's Pallas factories gate theirs (its
        ``models/boussinesq.py:228-248``): on the shell only, none for the
        coupled solves, and no forcing kernel for the rotational form
        (its ``ops/pallas_stencil.py:1048-1049``); ``forcing``:
        ``Forcing``'s arguments."""
        geo = self.geo
        params = self.params
        num = params.numerics
        if self.momentum_solver == "coupled":
            return
        if self.advection_form == "advective":
            self._forcing = ShellForcing(
                geo, **forcing, T_wall=self.T_wall,
                dt_T_factor=1.0 / params.NSE_solver_interval,
                advect_T=num.temperature_advection == "eulerian")
        self._proj = ShellProjection(
            geo, self.u_specs, self.p_specs,
            incremental=num.projection == "incremental")
        # the fused K1 stage runs only beside iterative temperature
        # solves (JAX model: `self.temperature_direct is None`)
        if num.fixed_solver_iters > 0 and self.temperature_direct is None:
            self._richardson = ShellRichardson(
                geo, one_over_Re=self.one_over_Re,
                one_over_Pe=self.one_over_Pe,
                nse_interval=params.NSE_solver_interval,
                helm_diags=self.helm_diags, T_diag=self.T_diag,
                iters_u=self.momentum_iters,
                iters_T=num.fixed_solver_iters,
                u_specs=self.u_specs, T_specs_hom=self.T_specs_hom)
        # residual-free variant [K1u] for the steps between honesty
        # checks (`residual check interval` > 1): the same iterates, fewer
        # stencil applies, residual norms -1
        if (self._richardson is not None
                and num.residual_check_interval > 1):
            self._richardson_free = ShellRichardson(
                geo, one_over_Re=self.one_over_Re,
                one_over_Pe=self.one_over_Pe,
                nse_interval=params.NSE_solver_interval,
                helm_diags=self.helm_diags, T_diag=self.T_diag,
                iters_u=self.momentum_iters,
                iters_T=num.fixed_solver_iters,
                u_specs=self.u_specs, T_specs_hom=self.T_specs_hom,
                track_residual=False)

    # ------------------------------------------------------------------
    def kernels(self) -> Dict[str, object]:
        """The kernel wrappers the model built, by name (their
        ``launches`` count the CUDA launches): on the annulus and for
        the coupled solves K4's alone, for the shell's rotational
        projection step no forcing kernel."""
        out = {}
        if self._forcing is not None:
            out["forcing" if self._forcing.advect_T
                else "forcing_momentum"] = self._forcing
        if self._proj is not None:
            out["faces_div"] = self._proj.faces_div_count
            out["correct"] = self._proj.correct_count
        out["tridiag"] = self._tridiag
        if self._richardson is not None:
            out["richardson"] = self._richardson
        if self._richardson_free is not None:
            out["richardson_free"] = self._richardson_free
        if self._mesh is not None and self._mesh.forcing is not None:
            kf = self._mesh.forcing.kern
            out["forcing_operands" if kf.advect_T
                else "forcing_momentum_operands"] = kf
        if self._mesh is not None and self._mesh.richardson is not None:
            out["richardson_operands"] = self._mesh.richardson.kern
        return out

    # ------------------------------------------------------------------
    def prepare_sharded(self, mesh: Mesh, kernels: bool = True
                        ) -> "BoussinesqModel":
        """Set this model up for sharded states on ``mesh`` (the
        geometry's layout, parallel/mesh.py: ("lat", "lon") on the shell,
        ("phi",) on the annulus, ("y", "x") on the box, ("x",) on the
        slab; this process's first shard on the model's device: on a
        mesh that spans processes each rank prepares its own model, and
        the stages hold its own shards). On the shell: the
        forcing as K2o (K2mo with the semi-Lagrangian
        transport) and, within its gates, the Richardson stage as K1o on
        every shard, the Poisson solve as ``ShardedShellPoissonFastDiag``
        (``ShardedShellPoissonSpectral`` on a stretched shell) or, for
        ``poisson solver = mg``, CG preconditioned by the radial
        V-cycle on the shards (``_mesh_common``), as the JAX package's
        ``prepare_sharded`` on a platform that runs its kernels, the
        temperature transport on the shards. The models that run no
        forcing kernel on one device (the coupled solves, the rotational
        form, every geometry but the shell) run the plain forcing and
        Eulerian transport on the shards (``ShardedPlainForcing``), the
        geometry's sharded fast diagonalization, and their coupled solves
        on Sharded block vectors, as the JAX package runs them through
        GSPMD. Where K1o's
        gates fail (``fixed solver iters`` = 0, Richardson momentum beside
        CG temperature, a ghost depth beyond one radial block or shard),
        on escalated steps, in ``step_verbose`` and in temperature
        substeps the solves run plain on the shards (Richardson or
        Jacobi-CG; ``poisson solver = cg`` Jacobi-CG), as the JAX package
        runs them through GSPMD. With ``helmholtz solver = direct`` (no
        K1o) the geometry's sharded direct solves run on every step,
        escalated ones too, as on one device. ``kernels=False`` (the JAX
        package's ``prepare_sharded(mesh, pallas=False)``) runs the mesh
        step with no hand kernel, on any device: K2o's and K2mo's plain
        versions on every shard and the plain solves. ``step``, ``step_strong``,
        ``step_verbose``, ``temperature_step``, ``run`` and ``multi_step``
        then take sharded states (``parallel.mesh.shard_state``); global
        states still run the single-device step. A mesh that does not
        divide the grid, and shards too thin for the forcing's halos,
        raise ValueError, as in the JAX package."""
        from dycoreplanet_tpu_torch.parallel.sharded_pallas import (
            ShardedPlainForcing, ShardedShellForcing)
        from dycoreplanet_tpu_torch.parallel.sharded_richardson import (
            make_sharded_richardson)
        from dycoreplanet_tpu_torch.parallel.sharded_transport import (
            ShardedSemiLagrangian)

        num = self.params.numerics
        common = self._mesh_common(mesh)
        # the plain forcing (for the coupled solves and the rotational
        # form, which run no forcing kernel on one device either: the JAX
        # package's GSPMD path) and the Eulerian transport
        plain = ShardedPlainForcing(self._plain_forcing, self.T_wall, mesh)
        forcing = (ShardedShellForcing(self._forcing, mesh, kernels=kernels)
                   if self._forcing is not None else None)
        richardson = make_sharded_richardson(self, mesh) if kernels else None
        if num.residual_check_interval > 1:
            warnings.warn(
                f"prepare_sharded: residual check interval = "
                f"{num.residual_check_interval} has no sharded kernel "
                "variant; running per-step residual checks on the mesh",
                RuntimeWarning, stacklevel=2)
        transport = (ShardedSemiLagrangian(self._semi_lagrangian, mesh)
                     if self._semi_lagrangian is not None else plain)
        self._mesh = _MeshStages(mesh=mesh, forcing=forcing,
                                 richardson=richardson, transport=transport,
                                 kernels=bool(kernels), plain_forcing=plain,
                                 **common)
        return self

    def _mesh_common(self, mesh: Mesh) -> dict:
        """The stages every personality's mesh shares, as ``_MeshStages``
        fields: the sharded Poisson solve (``poisson``: the geometry's
        fast diagonalization or the stretched shell's spectral CG; None
        for the Krylov strategies), the plain stages (``ops``), the
        sharded direct Helmholtz solves (``helmholtz``, ``temperature``;
        None without ``helmholtz solver = direct``) and, for ``poisson
        solver = mg``, the sharded V-cycle (``multigrid``, else None):
        the model's ``poisson_precond`` is rebuilt with its line smoother
        on the unsharded radial axis alone, as the JAX package's mesh
        rebuilds it on every geometry (a line solve along a sharded axis
        would gather whole lines), and that V-cycle runs on the shards. A
        mesh whose axes are not the geometry's layout (parallel/mesh.py
        ``mesh_axes``), and a level of the hierarchy that the mesh does
        not divide, raise ValueError."""
        from dycoreplanet_tpu_torch.parallel.mesh import mesh_axes
        from dycoreplanet_tpu_torch.parallel.sharded_step import (
            ShardedStep)
        from dycoreplanet_tpu_torch.solvers.helmholtz import (
            make_sharded_helmholtz_solver)
        from dycoreplanet_tpu_torch.solvers.multigrid import (
            ShardedPoissonMultigrid)
        from dycoreplanet_tpu_torch.solvers.spectral import (
            make_sharded_poisson_solver)

        if mesh.axis_names != mesh_axes(self.geo):
            raise ValueError(f"a {self.geo.kind} mesh has axes "
                             f"{mesh_axes(self.geo)}, not {mesh.axis_names}")
        if mesh.own_device != self.device:
            raise ValueError(f"this process's first shard lies on "
                             f"{mesh.own_device}, the model on "
                             f"{self.device}")
        sharded = lambda s, make: (  # noqa: E731
            make(s, mesh) if s is not None else None)
        multigrid = None
        if self.poisson_precond is not None:
            radial = PoissonMultigrid(
                self.geo, self.p_specs, dtype=self.torch_dtype,
                device=self.device, tridiag=self._tridiag,
                line_axes_allowed=(0,))
            multigrid = ShardedPoissonMultigrid(radial, mesh)
            self.poisson_precond = radial
        return dict(
            poisson=sharded(self.poisson_spectral,
                            make_sharded_poisson_solver),
            ops=ShardedStep(self.geo, mesh, self), multigrid=multigrid,
            helmholtz=sharded(self.helmholtz_direct,
                              make_sharded_helmholtz_solver),
            temperature=sharded(self.temperature_direct,
                                make_sharded_helmholtz_solver))

    def sharded_kernels(self) -> Dict[str, str]:
        """Which implementation each hot stage of the mesh step runs, as
        the JAX package reports it (its ``sharded_kernels``: "jnp" for a
        plain stage), so that a dropped opt-in is visible."""
        m = self._mesh
        if m is None:
            raise ValueError("sharded_kernels: call prepare_sharded first")
        tag = lambda on: "pallas-sharded" if on else "jnp"  # noqa: E731
        report = {"forcing": tag(m.forcing is not None and m.kernels),
                  "richardson": tag(m.richardson is not None),
                  "poisson": (type(m.poisson).__name__
                              if m.poisson is not None else
                              "mg-cg" if m.multigrid is not None
                              else "jacobi-cg")}
        M_chk = self.params.numerics.residual_check_interval
        if M_chk > 1:
            report["residual_check_interval"] = (
                f"requested {M_chk}, running per-step (no sharded "
                "residual-free variant)")
        return report

    def _prepare_dt(self, dt: float) -> None:
        """Fill the dt-dependent tables the step reads (K1's 1/D tables)
        for ``dt`` on the model's device: a CUDA graph captured with this
        dt calls it before each replay (models/graphs.py)."""
        for rk in (self._richardson, self._richardson_free):
            if rk is not None:
                rk.tables(self._scalar(dt), self.device, self.torch_dtype)

    def _tensor(self, a) -> torch.Tensor:
        return dtypes.tensor_from_numpy(a, self.torch_dtype, self.device)

    def _const(self, value, dtype=torch.float32) -> torch.Tensor:
        """A 0-d device constant, made once (by a fill kernel, no host
        copy) and reused: the step's Python numbers (iteration counts,
        sentinels) reach the packed diagnostics through these, so that a
        step can be captured into a CUDA graph. A graph's warm-up makes
        every constant its capture reads; one first asked for during a
        capture would hold nothing until a replay, so that raises."""
        key = (float(value), dtype)
        t = self._consts.get(key)
        if t is None:
            if (self.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"constant {value!r} first made during a CUDA graph "
                    "capture (the warm-up did not reach it)")
            t = torch.full((), float(value), dtype=dtype, device=self.device)
            self._consts[key] = t
        return t

    def _f32(self, v) -> torch.Tensor:
        """One slot of the packed diagnostics: a 0-d float32 tensor."""
        if not torch.is_tensor(v):
            return self._const(v)
        return v.to(torch.float32).reshape(())

    def _pack(self, cfl, max_velocity, T_min, T_max, div_norm,
              poisson_iters, temperature_iters, helmholtz_iters,
              helmholtz_residual=0.0, poisson_residual=0.0,
              temperature_residual=0.0, solver_ok=1.0) -> torch.Tensor:
        """The packed diagnostics vector (slot order: StepDiagnostics)."""
        return torch.stack([self._f32(v) for v in (
            cfl, max_velocity, T_min, T_max, div_norm, poisson_iters,
            temperature_iters, helmholtz_residual, poisson_residual,
            temperature_residual, solver_ok, *helmholtz_iters)])

    def _scalar(self, x) -> float:
        """A Python float holding ``x`` rounded to the working dtype."""
        return dtypes.round_scalar(x, self.torch_dtype)

    def _product(self, a, b) -> float:
        """a * b in the working dtype: both rounded, then the product."""
        return self._scalar(self._scalar(a) * self._scalar(b))

    def _host(self, a) -> np.ndarray:
        """A host array of the working dtype (base/dtypes.py)."""
        return dtypes.to_host(a, self.torch_dtype)

    def _in_float32(self, state: State) -> bool:
        """Whether a step from ``state`` computes on float32 copies of it:
        a bfloat16 state on a path that runs none of the shell's hand
        kernels (the annulus, the cuboid, the coupled solves, the mimetic
        personality). The kernels read bfloat16 and compute in float32;
        these paths do the same as a whole, as the JAX package's compiled
        bfloat16 step keeps excess precision inside its fusions: the new
        state is rounded once (``_stored``), before its diagnostics, and
        the solvers keep the bfloat16 tolerance clamps (``_rtol``)."""
        return not is_sharded(state) and self._kernel_free_bf16(state)

    def _kernel_free_bf16(self, state: State) -> bool:
        """``_in_float32``'s test, global or sharded: a bfloat16 state on
        a path that runs none of the shell's hand kernels (on a mesh the
        coupled solves, which widen the shards alike)."""
        return (self.torch_dtype == torch.bfloat16
                and state.u.dtype == torch.bfloat16
                and self._forcing is None and self._richardson is None
                and self._proj is None)

    def _float32_step(self, impl, state: State, dt: float, full: bool):
        """``impl`` (a step or substep) on float32 copies of ``state``."""
        return impl(_as_dtype(state, torch.float32), dt, full)

    def _rtol(self, rtol: float) -> float:
        """A solve's relative tolerance clamped to 16 eps of the working
        dtype, as the JAX package's solvers clamp it on operands of that
        dtype: the solvers clamp to their operands' eps, and a bfloat16
        model's float32 steps (``_in_float32``) keep bfloat16's."""
        return max(rtol, 16.0 * float(self.eps))

    def _stored(self, state: State) -> State:
        """A new state as the model stores it: its fields in the working
        dtype (rounded once from a float32 step, ``_in_float32``)."""
        return _as_dtype(state, self.torch_dtype)

    def _advance_time(self, time: float, dt_T: float) -> float:
        """The state's time after a step of ``dt_T``: a Python float that
        holds a value of the time's dtype, added in it: float64 beside
        float64 fields, float32 beside float32 ones (the JAX package's
        time is the model's dtype) and bfloat16 ones (in bfloat16, 4.0 +
        0.01 is 4.0: the JAX package's time stalls, ROADMAP.md Queue 3).
        A checkpoint stores it in that dtype, so a restart resumes at the
        saved time exactly."""
        if self.torch_dtype == torch.float64:
            return time + dt_T
        return float(np.float32(np.float32(time) + np.float32(dt_T)))

    # ------------------------------------------------------------------
    def _setup_bcs(self) -> None:
        """Ghost rules replacing the reference's constraint sets
        (no-slip inner or bottom / no-normal-flux outer or top wall, pole
        closure on the shell, periodic phi on the annulus, periodic x and
        y on the cuboid; reference: boussinesq_model.tpp:259-387). The
        fully periodic cuboid (``make_cuboid(periodic_z=True)``, no
        reference analogue) has no wall anywhere."""
        geo = self.geo
        AS, NEU = BC.ANTISYM, BC.NEUMANN
        if geo.kind == "cuboid" and geo.axes[0].periodic:
            self.u_specs = [[None] * geo.dim for _ in range(geo.dim)]
            self.p_specs = [None] * geo.dim
            return
        if geo.kind == "cuboid":
            # z walls: no-slip bottom, w = 0 and free slip on top; the 2D
            # (z, x) slab as the 3D box (planet_geometry.tpp:29-57)
            rest = [None] * (geo.dim - 1)
            self.u_specs = ([[BCSpec(AS, AS)] + rest]
                            + [[BCSpec(AS, NEU)] + rest
                               for _ in range(geo.dim - 1)])
            self.p_specs = [BCSpec(NEU, NEU)] + rest
            return
        if geo.kind == "annulus":
            self.u_specs = [
                [BCSpec(AS, AS), None],                # u_r: zero both walls
                [BCSpec(AS, NEU), None],               # u_phi
            ]
            self.p_specs = [BCSpec(NEU, NEU), None]
            return
        PO, PF = BC.POLE, BC.POLE_FLIP
        self.u_specs = [
            [BCSpec(AS, AS), BCSpec(PO, PO), None],    # u_r
            [BCSpec(AS, NEU), BCSpec(PF, PF), None],   # u_lat
            [BCSpec(AS, NEU), BCSpec(PF, PF), None],   # u_lon
        ]
        self.p_specs = [BCSpec(NEU, NEU), BCSpec(PO, PO), None]

    def _cartesian(self, axis_values) -> np.ndarray:
        """Cartesian points (*cells, dim) at the given axis values (cell
        centres, or one wall for an axis): the reference's initial-data
        functions are Cartesian. On the cuboid the grid's axes are (z, y,
        x), or (z, x) on the slab, and the points are in the reference's
        (x, y, z), or (x, z), order."""
        if self.geo.kind == "cuboid":
            grid = np.meshgrid(*axis_values, indexing="ij")
            return np.stack(grid[::-1], axis=-1)
        if self.geo.kind == "annulus":
            r, phi = np.meshgrid(*axis_values, indexing="ij")
            return np.stack([r * np.cos(phi), r * np.sin(phi)], axis=-1)
        r, lat, lon = np.meshgrid(*axis_values, indexing="ij")
        return np.stack([r * np.cos(lat) * np.cos(lon),
                         r * np.cos(lat) * np.sin(lon),
                         r * np.sin(lat)], axis=-1)

    def _cell_center_coords(self) -> np.ndarray:
        """Cartesian coordinates of the cell centres, (*cells, dim)."""
        return self._cartesian([a.centers for a in self.geo.axes])

    def _wall_coords(self) -> np.ndarray:
        """Cartesian coordinates of the inner radial wall, or the
        cuboid's bottom, (*cells[1:], dim): where the Dirichlet
        temperature is given."""
        axes = [a.centers for a in self.geo.axes]
        axes[0] = self.geo.axes[0].faces[:1]
        return self._cartesian(axes)[0]

    def _setup_static_fields(self) -> None:
        """Host numpy constants (the same arrays the JAX model builds)
        and their device copies."""
        geo = self.geo
        params = self.params
        dt_np = self.dtype
        self.vol = self._host(np.broadcast_to(geo.vol, geo.cell_shape))
        self.diameter = self._host(geo.cell_diameter())
        # gravity along axis 0: -g e_z on the cuboid
        # (core_model_data.tpp:86-95); radial on the shell and the
        # annulus, -g for r > 1, else -g sqrt(r) (tpp:97-106)
        g0 = params.physical_constants.gravity_constant
        gvec = np.zeros((geo.dim,) + geo.cell_shape)
        if geo.kind == "cuboid":
            gvec[0] = -g0
        else:
            r = np.broadcast_to(geo.extras["r_centers"], geo.cell_shape)
            gvec[0] = radial_gravity_scalar(r, g0)
        self.gravity = self._host(self.g_hat_scale * gvec)

        # hydrostatic background pressure of the constant-density part,
        # grad p_h = g_vec_hat (a face-midpoint integral along the radius),
        # scaled by rho_background below: output only (the well-balanced
        # `buoyancy = perturbation` dynamics never read it), as in the
        # JAX package
        g_line = gvec[0].reshape(geo.cell_shape[0], -1)[:, 0]
        dr = np.diff(geo.axes[0].centers)
        p_line = self.g_hat_scale * np.concatenate(
            [[0.0], np.cumsum(0.5 * (g_line[:-1] + g_line[1:]) * dr)])
        shape1 = (geo.cell_shape[0],) + (1,) * (geo.dim - 1)
        p_h = self._host(np.broadcast_to(p_line.reshape(shape1),
                                         geo.cell_shape))
        p_h = p_h - (p_h * self.vol).sum() / self.vol.sum()

        if geo.kind == "cuboid":
            ic = TemperatureInitialValuesCuboid(
                geo.dim, geo.extras["center"], float(geo.extras["diameter"]))
        else:
            ic = TemperatureInitialValues(
                geo.dim, float(geo.axes[0].faces[0]),
                float(geo.axes[0].faces[-1]),
                width_scale=params.numerics.ic_width_scale)
        self.T_init = self._host(ic(self._host(self._cell_center_coords())))
        # boundary values: the IC on the inner wall (the cuboid's bottom);
        # none on the fully periodic cuboid
        periodic = geo.axes[0].periodic
        self.T_wall = (None if periodic else self._host(
            ic(self._host(self._wall_coords()))))
        # reference-state density rho(volume-mean initial T): the constant
        # part of 1 - beta (T - T_ref) is a pure gradient absorbed into
        # rho_background * p_hydro (with the production T_ref = 273.15 it
        # is O(1))
        T_mean0 = float((self.T_init * self.vol).sum() / self.vol.sum())
        self.rho_background = float(1.0 - self.beta * (T_mean0 - self.T_ref))
        self.p_hydro = self._host(self.rho_background * p_h)

        NEU = BC.NEUMANN
        if periodic:
            self.T_specs = [None] * geo.dim
            self.T_specs_hom = [None] * geo.dim
        else:
            wall = BCSpec(BC.DIRICHLET, NEU,
                          lo_value=self._tensor(self.T_wall))
            wall_hom = BCSpec(BC.ANTISYM, NEU)
            # the shell's lat axis closes at the poles; the annulus's and
            # the cuboid's other axes are periodic (the JAX model lists
            # three specs on the 2D slab too)
            rest = {"shell": [BCSpec(BC.POLE, BC.POLE), None],
                    "annulus": [None]}.get(geo.kind, [None, None])
            self.T_specs = [wall] + rest
            self.T_specs_hom = [wall_hom] + rest
        # affine offset of the inhomogeneous-Dirichlet weak Laplacian:
        # weak_lap_inhom(x) = weak_lap_hom(x) + offset
        zero = torch.zeros(geo.cell_shape, dtype=self.torch_dtype,
                           device=self.device)
        self.T_lap_offset = self._host(st.weak_laplacian(
            geo, zero, self.T_specs).cpu().double().numpy())

        # the direct solves' radial tridiagonals, the multigrid line
        # smoother and the non-uniform shell's spectral-CG radial lines
        # share one K4 wrapper
        self._tridiag = TridiagSolve()
        # Poisson strategy, as in the JAX package: 'auto'/'fft' the
        # fast-diagonalization solve ("auto" precision resolves as the
        # JAX package does off the TPU, "highest"; every precision
        # computes full-precision transforms here and keeps its
        # residual-check tolerance), 'mg' CG preconditioned by a
        # multigrid V-cycle (solvers/multigrid.py), 'cg' Jacobi-CG
        self.poisson_spectral = None
        self.poisson_precond = None
        solver_choice = params.numerics.poisson_solver
        if solver_choice in ("auto", "fft"):
            prec = params.numerics.poisson_precision
            if prec == "auto":
                prec = "highest"
            # the shell's CG (ShellPoissonSpectral, on a non-uniform
            # radial spacing) stops at `poisson tol` and `max cg iters`,
            # as the JAX package passes them
            kw = {}
            if geo.kind == "shell":
                kw = dict(rtol=params.numerics.poisson_tol,
                          maxiter=params.numerics.max_cg_iters)
            self.poisson_spectral = make_poisson_solver(
                geo, dtype=dt_np, precision=prec,
                refine_op=lambda x: -st.weak_laplacian(geo, x, self.p_specs),
                device=self.device, tridiag=self._tridiag, **kw)
        elif solver_choice == "mg":
            self.poisson_precond = PoissonMultigrid(
                geo, self.p_specs, dtype=self.torch_dtype, device=self.device,
                tridiag=self._tridiag)
        self.poisson_diag = self._host(
            -weak_laplacian_diagonal(geo, self.p_specs))
        self.helm_diags = np.stack([
            self._host(-weak_laplacian_diagonal(geo, self.u_specs[c]))
            for c in range(geo.dim)])
        self.T_diag = self._host(
            -weak_laplacian_diagonal(geo, self.T_specs_hom))

        # direct (non-iterative) Helmholtz solvers for the implicit
        # momentum and temperature systems (solvers/helmholtz.py)
        self.helmholtz_direct = None
        self.temperature_direct = None
        if params.numerics.helmholtz_solver == "direct":
            self.helmholtz_direct = make_helmholtz_solver(
                geo, [self.u_specs[c][0] for c in range(geo.dim)],
                dtype=dt_np,
                tridiag=self._tridiag, device=self.device)
            self.temperature_direct = make_helmholtz_solver(
                geo, [self.T_specs_hom[0]], dtype=dt_np,
                tridiag=self._tridiag, device=self.device)
            if self.helmholtz_direct is None or self.temperature_direct is None:
                raise ValueError(
                    "helmholtz solver = direct requires a separable "
                    "geometry (uniform radial spacing)")

        self._vol_t = self._tensor(self.vol)
        self._diameter_t = self._tensor(self.diameter)
        self._T_lap_offset_t = self._tensor(self.T_lap_offset)
        self._helm_diags_t = self._tensor(self.helm_diags)
        self._T_diag_t = self._tensor(self.T_diag)
        self._poisson_diag_t = self._tensor(self.poisson_diag)
        self._grid_ops = _GridOps(self)

    # ------------------------------------------------------------------
    def initial_state(self) -> State:
        shp = self.geo.cell_shape
        dim = self.geo.dim
        z = lambda *s: torch.zeros(s, dtype=self.torch_dtype,
                                   device=self.device)
        return State(u=z(dim, *shp),
                     u_faces=tuple(z(*shp) for _ in range(dim)),
                     p=z(*shp), T=self._tensor(self.T_init), time=0.0,
                     step_number=0)

    def interp_to_faces(self, u: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Face-normal velocities of a collocated field (wall faces 0)."""
        return tuple(cell_to_faces(self.geo, self.u_specs, u))

    def _apply_wall_face_values(self, uf: torch.Tensor, d: int
                                ) -> torch.Tensor:
        """Zero normal velocity on the wall faces of axis d (the JAX
        model's method of this name)."""
        return apply_wall_face_values(self.geo, uf, d)

    # ------------------------------------------------------------------
    def _dt_T(self, dt: float) -> float:
        """The temperature substep dt / NSE solver interval, rounded to
        the working dtype (the step's time increment)."""
        return self._scalar(self._scalar(dt) / self.params.NSE_solver_interval)

    def _step_impl(self, state: State, dt: float, full: bool = True):
        """One NSE step. Returns (new_state, packed diagnostics, ok): ok
        is the gate's verdict as a 0-d float32 tensor (1 or 0). With
        ``full=False`` only the gate's reductions run and packed is None
        (the earlier steps of a multi_step chunk without diagnostics)."""
        if is_sharded(state):
            return self._mesh_step_impl(state, dt, full)
        if self._in_float32(state):
            return self._float32_step(self._step_impl, state, dt, full)
        geo = self.geo
        p = self.params
        vol = self._vol_t
        u, u_faces, pres, T = state.u, state.u_faces, state.p, state.T
        dt = self._scalar(dt)
        dt_T = self._dt_T(dt)

        # ------- explicit forcing from step n [K2, or K2m + transport;
        # the model's plain PyTorch on the annulus and in the rotational
        # form] ----------------------------------------------------------
        if self._forcing is None:
            forcing = self._plain_forcing.explicit_forcing(
                u, u_faces, pres, T)
            rhs_u = u + dt * forcing
            T_adv = self._advected_temperature(u, u_faces, T, dt_T)
        elif self._forcing.advect_T:
            rhs_u, T_adv = self._forcing(u, u_faces, T, pres, dt)
        else:
            rhs_u = self._forcing(u, u_faces, T, pres, dt)
            T_adv = self._advected_temperature(u, u_faces, T, dt_T)
        kT = self._product(dt_T, self.one_over_Pe)
        rhs_T = vol * T_adv + kT * self._T_lap_offset_t

        if self.momentum_solver == "coupled":
            (u_new, p_new, new_faces, helm_iters, poisson_iters, helm_rnorm,
             poisson_rnorm, momentum_ok) = self._coupled_momentum(
                 u, forcing, pres, dt)
            T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
                rhs_T, kT, T)
        elif (self._richardson is not None and not self._force_cg
                and not self._solver_trace):
            # fused implicit stage [K1]: both Richardson solves + the
            # projection head (not in step_verbose, as in the JAX model:
            # K1 records no iterate's residual)
            rk = self._richardson
            if (self._richardson_free is not None and state.step_number
                    % p.numerics.residual_check_interval != 0):
                # `residual check interval` = M > 1: the tracked
                # residuals and their gate run on every M-th step; in
                # between the residual-free variant [K1u] reports -1
                rk = self._richardson_free
            u_star, T_new, prefused, (rn_u, bn_u, rn_T, bn_T) = \
                rk(rhs_u, rhs_T, T, dt)
            # rn < 0: not checked on this step (interval mode)
            helm_ok = torch.logical_or(
                rn_u < 0, rn_u <= self._rtol(p.numerics.helmholtz_tol) * bn_u)
            T_ok = torch.logical_or(
                rn_T < 0,
                rn_T <= self._rtol(p.numerics.temperature_tol) * bn_T)
            (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
             poisson_ok) = self._project_velocity(u_star, pres, dt,
                                                  prefused=prefused)
            helm_iters = [rk.iters_u] * geo.dim
            T_iters = rk.iters_T
            helm_rnorm, T_rnorm = rn_u, rn_T
            momentum_ok = torch.logical_and(helm_ok, poisson_ok)
        else:
            (u_new, p_new, new_faces, helm_iters, poisson_iters,
             helm_rnorm, poisson_rnorm, momentum_ok) = \
                self._solve_momentum_projection(rhs_u, pres, dt)
            T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
                rhs_T, kT, T)

        new_state = self._stored(State(
            u=u_new, u_faces=tuple(new_faces), p=p_new, T=T_new,
            time=self._advance_time(state.time, dt_T),
            step_number=state.step_number + 1))
        u_new, new_faces, T_new = (new_state.u, list(new_state.u_faces),
                                   new_state.T)
        ok = torch.logical_and(momentum_ok, T_ok)
        if not full:
            return new_state, None, self._f32(ok)
        # ---------------- diagnostics ----------------------------------
        speed = st.cell_max_speed(geo, u_new)
        cfl = torch.max(torch.clamp(speed, min=1e-10) / self._diameter_t)
        div_new = st.divergence(geo, new_faces)
        packed = self._pack(
            cfl, torch.max(speed), torch.min(T_new), torch.max(T_new),
            torch.max(torch.abs(div_new)), poisson_iters, T_iters,
            helm_iters, helmholtz_residual=helm_rnorm,
            poisson_residual=poisson_rnorm, temperature_residual=T_rnorm,
            solver_ok=ok)
        return new_state, packed, packed[10]

    def _mesh_step_impl(self, state: State, dt: float, full: bool = True):
        """``_step_impl`` on a sharded state: K2o (or K2mo and the sharded
        semi-Lagrangian transport; their plain versions with
        ``kernels=False``), then K1o, or where K1o does not run (its gates,
        ``kernels=False``, escalated steps, ``step_verbose``,
        ``helmholtz solver = direct``) the plain solves on the shards:
        Richardson or Jacobi-CG momentum (the sharded direct solve of vol
        rhs_u), K3's plain version, and Richardson, Jacobi-CG or the
        sharded direct temperature solve; the sharded
        Poisson solve (under ``_force_cg`` CG preconditioned by it, as the
        JAX escalated step's ``_poisson_cg``; ``poisson solver = cg``
        Jacobi-CG, ``= mg`` CG preconditioned by the sharded V-cycle) and
        the plain correction. Without K2o (the coupled solves, the
        rotational form) the plain forcing and transport on the shards;
        the coupled solves then as on one device (``_coupled_momentum``),
        on Sharded block vectors. The gate's verdict and the packed
        diagnostics on the model's device (this process's first shard's),
        from replicated sums: every rank of a process mesh reads the same
        bits, and takes the same escalation, retry and rewind. A bfloat16
        state's plain stages, and the whole of a coupled step, compute in
        float32 on the widened shards and the new state is rounded once
        (``_stored``)."""
        mesh = self._mesh
        if mesh is None:
            raise ValueError("a sharded state needs prepare_sharded first")
        p = self.params
        coupled = self.momentum_solver == "coupled"
        bf16 = self.torch_dtype == torch.bfloat16
        if self._kernel_free_bf16(state):
            state = _as_dtype(state, torch.float32)
        ops = self._ops(state.T)
        u, u_faces, pres, T = state.u, state.u_faces, state.p, state.T
        dt = self._scalar(dt)
        dt_T = self._dt_T(dt)
        if mesh.forcing is None:
            # the coupled solves and the rotational form (no K2o)
            forcing = mesh.plain_forcing.explicit_forcing(u, u_faces, pres,
                                                          T)
            rhs_u = u + dt * forcing
            T_adv = mesh.transport(u, u_faces, T, dt_T)
        elif mesh.forcing.kern.advect_T:
            rhs_u, T_adv = mesh.forcing(u, u_faces, T, pres, dt)
        else:
            rhs_u = mesh.forcing(u, u_faces, T, pres, dt)
            T_adv = mesh.transport(u, u_faces, T, dt_T)
        kT = self._product(dt_T, self.one_over_Pe)
        rk = mesh.richardson
        if coupled:
            rhs_T = T_adv.map(lambda t, v, o: v * t + kT * o, ops.vol,
                              ops.T_lap_offset)
            (u_new, p_new, new_faces, helm_iters, poisson_iters, helm_rnorm,
             poisson_rnorm, helm_ok) = self._coupled_momentum(
                 u, forcing, pres, dt)
            helm_iters, poisson_ok = helm_iters[0], helm_ok
            T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
                rhs_T, kT, T)
            new_state = self._stored(State(
                u=u_new, u_faces=tuple(new_faces), p=p_new, T=T_new,
                time=self._advance_time(state.time, dt_T),
                step_number=state.step_number + 1))
            div_new = mesh.ops.divergence(new_state.u_faces)
        elif (rk is not None and not self._force_cg
              and not self._solver_trace):
            rhs_T = T_adv.map(lambda t, v, o: v * t + kT * o, ops.vol,
                              ops.T_lap_offset)
            u_star, T_new, (uf0, uf1, uf2, rhs_phi), \
                (rn_u, bn_u, rn_T, bn_T) = rk(rhs_u, rhs_T, T, dt)
            helm_ok = rn_u <= self._rtol(p.numerics.helmholtz_tol) * bn_u
            T_ok = rn_T <= self._rtol(p.numerics.temperature_tol) * bn_T
            u_new, new_faces, p_new, div_new, poisson_iters, \
                poisson_rnorm, poisson_ok = self._mesh_project(
                    u_star, (uf0, uf1, uf2), rhs_phi, pres, dt)
            helm_iters, T_iters = rk.iters_u, rk.iters_T
            helm_rnorm, T_rnorm = rn_u, rn_T
            new_state = State(u=u_new, u_faces=new_faces, p=p_new, T=T_new,
                              time=self._advance_time(state.time, dt_T),
                              step_number=state.step_number + 1)
        else:
            if bf16:
                wide = lambda x: x.to(torch.float32)  # noqa: E731
                rhs_u, T_adv, T, pres = map(wide, (rhs_u, T_adv, T, pres))
            ops = self._ops(rhs_u)
            rhs_T = T_adv.map(lambda t, v, o: v * t + kT * o, ops.vol,
                              ops.T_lap_offset)
            if mesh.helmholtz is not None:
                # the direct solve of vol rhs_u (under _force_cg too, as
                # on one device)
                u_star = mesh.helmholtz.solve(
                    rhs_u.map(lambda r, v: v[None] * r, ops.vol),
                    self._product(dt, self.one_over_Re))
                helm_iters, helm_rnorm, helm_ok = (
                    -1, self._const(-1.0), self._const(True, torch.bool))
            else:
                u_star, helm_iters, helm_rnorm, helm_ok = \
                    self._helmholtz_solve(rhs_u, dt)
            uf_star, rhs_phi = ops.faces_div(self.u_specs, u_star, dt)
            u_new, new_faces, p_new, div_new, poisson_iters, \
                poisson_rnorm, poisson_ok = self._mesh_project(
                    u_star, uf_star, rhs_phi, pres, dt)
            T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
                rhs_T, kT, T)
            new_state = State(u=u_new, u_faces=new_faces, p=p_new, T=T_new,
                              time=self._advance_time(state.time, dt_T),
                              step_number=state.step_number + 1)
            if bf16:
                new_state = self._stored(new_state)
                div_new = mesh.ops.divergence(new_state.u_faces)
        ok = torch.logical_and(torch.logical_and(helm_ok, poisson_ok), T_ok)
        if not full:
            return new_state, None, self._f32(ok)
        packed = self._mesh_pack(
            new_state.u, new_state.T, div_new, poisson_iters, T_iters,
            [helm_iters] * self.geo.dim, helmholtz_residual=helm_rnorm,
            poisson_residual=poisson_rnorm, temperature_residual=T_rnorm,
            solver_ok=ok)
        return new_state, packed, packed[10]

    def _mesh_project(self, u_star, uf_star, rhs_phi, pres, dt):
        """The projection on the mesh (``_project_velocity``'s): the
        Poisson solve, the plain correction on the shards and, after the
        fast solve, the residual spot-check from the fixed-order sums.
        Returns (u_new, faces, p_new, div_new, poisson_iters,
        poisson_rnorm, poisson_ok)."""
        mesh = self._mesh
        ops = self._ops(u_star)
        p = self.params
        phi, iters, rnorm, ok = self._solve_pressure_poisson(rhs_phi)
        u_new, new_faces, p_new = ops.correct(
            self.p_specs, u_star, uf_star, phi, pres, dt,
            p.numerics.projection == "incremental")
        if p.correct_pressure_to_zero_mean:
            p_new = ops.less_volume_mean(p_new)
        div_new = ops.divergence(new_faces)
        if mesh.poisson is not None and not self._force_cg:
            vol_div = div_new.map(lambda d, v: torch.sum((v * d) ** 2),
                                  ops.vol)
            rnorm = torch.sqrt(ops.total(vol_div)) / dt
            bnorm = torch.sqrt(ops.total(rhs_phi.map(
                lambda r: torch.sum(r ** 2))))
            floor = (16.0 * float(self.eps)
                     * torch.sqrt(ops.face_flux2(new_faces)) / dt)
            ok = rnorm <= self._poisson_check_tol(mesh.poisson) * bnorm + floor
        return u_new, new_faces, p_new, div_new, iters, rnorm, ok

    def _mesh_pack(self, u_new, T_new, div_new, *counts, **rest):
        """The packed diagnostics of a mesh step from its fixed-order
        maxima (``_pack``'s slots: ``counts`` are poisson_iters,
        temperature_iters, helmholtz_iters)."""
        ops = self._mesh.ops
        speed = u_new.map(lambda x: st.cell_max_speed(self.geo, x))
        cfl = ops.max(speed.map(lambda sp, d: torch.clamp(sp, min=1e-10) / d,
                                ops.diameter))
        return self._pack(cfl, ops.max(speed), ops.min(T_new),
                          ops.max(T_new), ops.max(div_new.map(torch.abs)),
                          *counts, **rest)

    def _temperature_step_impl(self, state: State, dt: float,
                               full: bool = True):
        """Temperature-only substep with the velocity frozen — the steps
        between NSE solves when ``NSE solver interval`` > 1 (JAX model:
        ``_temperature_step_body``; reference: the run loop solves the
        NSE every interval-th step and the temperature every step,
        boussinesq_model.tpp:1875-1905). Plain PyTorch transport and the
        temperature solve (Richardson, CG or direct), as in the JAX
        package, which runs no Pallas kernel here. Returns as
        ``_step_impl``."""
        if is_sharded(state):
            return self._mesh_temperature_step_impl(state, dt, full)
        if self._in_float32(state):
            return self._float32_step(self._temperature_step_impl, state, dt,
                                      full)
        geo = self.geo
        T = state.T
        dt_T = self._dt_T(dt)
        T_adv = self._advected_temperature(state.u, state.u_faces, T, dt_T)
        kT = self._product(dt_T, self.one_over_Pe)
        rhs_T = self._vol_t * T_adv + kT * self._T_lap_offset_t
        T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
            rhs_T, kT, T)
        new_state = self._stored(state._replace(
            T=T_new, time=self._advance_time(state.time, dt_T),
            step_number=state.step_number + 1))
        T_new = new_state.T
        if not full:
            return new_state, None, self._f32(T_ok)
        speed = st.cell_max_speed(geo, state.u)
        packed = self._pack(
            torch.max(torch.clamp(speed, min=1e-10) / self._diameter_t),
            torch.max(speed), torch.min(T_new), torch.max(T_new),
            torch.max(torch.abs(st.divergence(geo, list(state.u_faces)))),
            0, T_iters, [0] * geo.dim, temperature_residual=T_rnorm,
            solver_ok=T_ok)
        return new_state, packed, packed[10]

    def _mesh_temperature_step_impl(self, state: State, dt: float,
                                    full: bool = True):
        """``_temperature_step_impl`` on a sharded state: the transport
        (``_MeshStages.transport``) and the temperature solve
        (Richardson, or Jacobi-CG when escalated or with ``fixed solver
        iters`` = 0) on the shards, the diagnostics of the frozen velocity
        from the fixed-order maxima; a bfloat16 state of a kernel-free
        model in float32, rounded once, as on one device."""
        mesh = self._mesh
        if mesh is None:
            raise ValueError("a sharded state needs prepare_sharded first")
        wide = self._kernel_free_bf16(state)
        if wide:
            state = _as_dtype(state, torch.float32)
        ops = self._ops(state.T)
        T = state.T
        dt_T = self._dt_T(dt)
        T_adv = mesh.transport(state.u, state.u_faces, T, dt_T)
        kT = self._product(dt_T, self.one_over_Pe)
        rhs_T = T_adv.map(lambda t, v, o: v * t + kT * o, ops.vol,
                          ops.T_lap_offset)
        T_new, T_iters, T_rnorm, T_ok = self._solve_temperature_system(
            rhs_T, kT, T)
        new_state = state._replace(
            T=T_new, time=self._advance_time(state.time, dt_T),
            step_number=state.step_number + 1)
        if wide:
            new_state = self._stored(new_state)
        if not full:
            return new_state, None, self._f32(T_ok)
        packed = self._mesh_pack(
            state.u, new_state.T, ops.divergence(state.u_faces), 0, T_iters,
            [0] * self.geo.dim, temperature_residual=T_rnorm,
            solver_ok=T_ok)
        return new_state, packed, packed[10]

    def _advected_temperature(self, u, u_faces, T, dt_T):
        """T after the explicit transport sub-step: the semi-Lagrangian
        departure-point interpolation with the cell velocity ``u``, or the
        Eulerian T - dt_T u . grad T with the face velocities (JAX model:
        ``_advected_temperature``)."""
        if self._semi_lagrangian is not None:
            return self._semi_lagrangian(u, T, dt_T)
        return self._plain_forcing.advected_temperature(u_faces, T, dt_T)

    # ------------------------------------------------------------------
    def _solve_temperature_system(self, rhs_T, kT, x0):
        """(vol - kT * weak_lap_hom) T = rhs_T, direct when configured,
        else by fixed-iteration Jacobi-Richardson (``fixed solver iters``
        > 0, not under ``_force_cg``) or Jacobi-CG (reference:
        temperature CG at 1e-12*rhs, tpp:1426-1440). Returns (T_new,
        iterations, residual_norm, converged); -1 = direct, not
        measured."""
        if self.temperature_direct is not None:
            if isinstance(rhs_T, Sharded):
                T_new = self._mesh.temperature.solve(
                    rhs_T.map(lambda t: t[None]), kT).map(lambda t: t[0])
            else:
                T_new = self.temperature_direct.solve(rhs_T[None], kT)[0]
            return (T_new, -1, self._const(-1.0),
                    self._const(True, torch.bool))
        ops = self._ops(rhs_T)
        vol = ops.vol
        num = self.params.numerics
        diag_T = vol + kT * ops.T_diag

        def temp_op(x):
            return vol * x - kT * ops.weak_laplacian(x, self.T_specs_hom)

        k_fix = 0 if self._force_cg else num.fixed_solver_iters
        if k_fix > 0:
            res = richardson_solve(temp_op, rhs_T, x0, diag=diag_T,
                                   iters=k_fix,
                                   rtol=self._rtol(num.temperature_tol),
                                   record_history=self._hist_n(),
                                   dot=ops.dot)
            self._stash_history("temperature richardson", res)
        else:
            res = cg(temp_op, rhs_T, x0=x0,
                     rtol=self._rtol(num.temperature_tol),
                     maxiter=num.max_cg_iters,
                     preconditioner=lambda r: r / diag_T,
                     record_history=self._hist_n(), dot=ops.dot)
            self._stash_history("temperature CG", res)
        return res.x, res.iterations, res.residual_norm, res.converged

    def _ops(self, x):
        """The operators of the solves for field ``x``: the whole grid's,
        or on a mesh its stages' with their constants in ``x``'s dtype,
        but in the working dtype where a bfloat16 step computes in
        float32 (``_in_float32``: the single-device step's float32 fields
        meet the model's bfloat16 constants, as in the JAX package)."""
        if isinstance(x, Sharded):
            widened = (self.torch_dtype == torch.bfloat16
                       and self._forcing is None
                       and self._richardson is None and self._proj is None)
            return self._mesh.ops.like(self.torch_dtype if widened
                                       else x.dtype)
        return self._grid_ops

    def _solve_pressure_poisson(self, rhs_phi):
        """-weak_lap(phi) = rhs_phi via the configured strategy: the
        fast-diagonalization solve, or CG preconditioned by the multigrid
        V-cycle (`mg`) or by Jacobi (`cg`). Under ``_force_cg`` a
        fast-diagonalization configuration runs CG with the fast solve as
        its preconditioner (a corrupted fast-diag then only slows the
        iteration). Shared by the projection and the mimetic step.
        Returns (phi, iters, residual_norm, converged) with the -1
        sentinel for the direct solve (replaced by the spot-check in
        _project_velocity)."""
        fast = self._fast_poisson(rhs_phi)
        if fast is not None and not self._force_cg:
            phi, iters = fast.solve(rhs_phi)
            return (phi, iters, self._const(-1.0),
                    self._const(True, torch.bool))
        res = self._poisson_cg(rhs_phi, record_history=self._hist_n())
        self._stash_history("poisson CG", res)
        return res.x, res.iterations, res.residual_norm, res.converged

    def _fast_poisson(self, rhs_phi):
        """The fast Poisson solve for ``rhs_phi``: the model's, or on a
        mesh the sharded one; None for the Krylov strategies."""
        if isinstance(rhs_phi, Sharded):
            return self._mesh.poisson
        return self.poisson_spectral

    def _poisson_cg(self, rhs_phi, record_history: int = 0):
        """CG on -weak_lap(phi) = rhs_phi, preconditioned by the multigrid
        V-cycle, else the fast solve, else Jacobi."""
        ops = self._ops(rhs_phi)
        fast = self._fast_poisson(rhs_phi)
        mg = (self._mesh.multigrid if isinstance(rhs_phi, Sharded)
              else self.poisson_precond)
        precond = (mg if mg is not None
                   else (fast if fast is not None
                         else (lambda r: r / ops.poisson_diag)))
        return cg(lambda x: -ops.weak_laplacian(x, self.p_specs),
                  rhs_phi, rtol=self._rtol(self.params.numerics.poisson_tol),
                  maxiter=self.params.numerics.max_cg_iters,
                  preconditioner=precond, record_history=record_history,
                  dot=ops.dot)

    def _solve_momentum_projection(self, rhs_u, pres, dt):
        """Helmholtz predictor + projection: the direct solve when
        configured (under ``_force_cg`` too, as in the JAX model), else
        fixed-iteration Jacobi-Richardson off the shell (where K1 does
        not run) or full CG (the escalated path), all components in one
        stacked solve."""
        dim = self.geo.dim
        if self.helmholtz_direct is not None:
            coef = self._product(dt, self.one_over_Re)
            u_star = self.helmholtz_direct.solve(
                self._vol_t[None] * rhs_u, coef)
            (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
             poisson_ok) = self._project_velocity(u_star, pres, dt)
            return (u_new, p_new, new_faces, [-1] * dim, poisson_iters,
                    self._const(-1.0), poisson_rnorm, poisson_ok)
        u_star, iters, rnorm, helm_ok = self._helmholtz_solve(rhs_u, dt)
        (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
         poisson_ok) = self._project_velocity(u_star, pres, dt)
        return (u_new, p_new, new_faces, [iters] * dim, poisson_iters,
                rnorm, poisson_rnorm, torch.logical_and(helm_ok, poisson_ok))

    def _helmholtz_solve(self, rhs_u, dt):
        """(vol - dt/Re L) u* = vol rhs_u, all components in one stacked
        solve: fixed-iteration Jacobi-Richardson (``momentum iters`` > 0,
        not escalated) or Jacobi-CG, on the whole grid or the shards.
        Returns (u*, iterations, residual norm, converged)."""
        ops = self._ops(rhs_u)
        vol = ops.vol
        coef = self._product(dt, self.one_over_Re)

        def helm_op(x):
            return vol * x - coef * ops.vector_laplacian(x, self.u_specs)

        helm_diag = vol + coef * ops.helm_diags
        b = vol * rhs_u
        tol = self._rtol(self.params.numerics.helmholtz_tol)
        k_fix = 0 if self._force_cg else self.momentum_iters
        if k_fix > 0:
            res = richardson_solve(helm_op, b, rhs_u, diag=helm_diag,
                                   iters=k_fix, rtol=tol,
                                   record_history=self._hist_n(),
                                   dot=ops.dot)
            self._stash_history("helmholtz richardson", res)
        else:
            res = cg(helm_op, b, x0=rhs_u, rtol=tol,
                     maxiter=self.params.numerics.max_cg_iters,
                     preconditioner=lambda r: r / helm_diag,
                     record_history=self._hist_n(), dot=ops.dot)
            self._stash_history("helmholtz CG", res)
        return res.x, res.iterations, res.residual_norm, res.converged

    # ------------------------------------------------------------------
    def _project_velocity(self, u_star, pres, dt, prefused=None):
        """Faces + compatible RHS (from K1's head, or K3; plain PyTorch on
        the annulus), Poisson solve, face/cell correction [K5; plain on
        the annulus], residual spot-check. Returns (u_new, p_new,
        new_faces, poisson_iters, poisson_rnorm, poisson_ok)."""
        geo = self.geo
        p = self.params
        vol = self._vol_t
        if prefused is not None:
            uf_star = list(prefused[:3])
            rhs_phi = prefused[3]
        else:
            if self._proj is None:
                *uf_star, rhs_raw, total = faces_div_plain(
                    geo, self.u_specs, u_star, dt)
            else:
                *uf_star, rhs_raw, total = self._proj.faces_div(u_star, dt)
            # compatibility: the constant spans the weak Laplacian's
            # nullspace, so sum(rhs) must vanish; subtract the float drift
            # (K3's sum is float32 under bfloat16 fields)
            rhs_phi = (rhs_raw - total / float(geo.n_cells)).to(
                rhs_raw.dtype)

        phi, poisson_iters, poisson_rnorm, poisson_ok = \
            self._solve_pressure_poisson(rhs_phi)

        args = (u_star, uf_star, phi, pres, dt, st.volume_mean(geo, phi))
        if self._proj is None:
            u_new, *new_faces, p_new = correct_plain(
                geo, self.p_specs, *args,
                incremental=p.numerics.projection == "incremental")
        else:
            u_new, *new_faces, p_new = self._proj.correct(*args)
        if p.correct_pressure_to_zero_mean:
            p_new = p_new - st.volume_mean(geo, p_new)

        if self.poisson_spectral is not None and not self._force_cg:
            # residual spot-check of the direct solve: grad/div are a
            # compatible pair, so vol*div(u_new)/dt IS the solve residual;
            # noise floor C*eps*||area*uf||/dt, per-precision tolerance
            # table as in the JAX package (boussinesq.py:1284-1294)
            div_chk = st.divergence(geo, new_faces)
            rnorm = torch.sqrt(torch.sum((vol * div_chk) ** 2)) / dt
            bnorm = torch.sqrt(torch.sum(rhs_phi ** 2))
            epsf = float(self.eps)
            flux2 = None
            for d2 in range(geo.dim):
                t2 = torch.sum(
                    (st.metric(geo, "area_l", d2, u_star) * new_faces[d2])
                    ** 2)
                flux2 = t2 if flux2 is None else flux2 + t2
            floor = 16.0 * epsf * torch.sqrt(flux2) / dt
            tol = self._poisson_check_tol(self.poisson_spectral)
            poisson_ok = rnorm <= tol * bnorm + floor
            poisson_rnorm = rnorm
        return (u_new, p_new, new_faces, poisson_iters, poisson_rnorm,
                poisson_ok)

    def _poisson_check_tol(self, solver) -> float:
        """The residual spot-check's relative tolerance for a fast
        Poisson solver: per precision as in the JAX package
        (boussinesq.py:1284-1294), or the bound a solver whose transforms
        amplify round-off declares (the annulus fast diagonalization)."""
        epsf = float(self.eps)
        prec_tol = {"highest": 256.0 * epsf, "high": 1e-2,
                    "high-refine": 1e-3}[solver.precision]
        amp = getattr(solver, "check_amp", None)
        if amp is not None:
            prec_tol = max(prec_tol, float(amp) * epsf)
        return max(self.params.numerics.poisson_tol, prec_tol)

    # ------------------------------------------------------------------
    # the coupled momentum solves: plain PyTorch, as they are jnp in the
    # JAX package, which runs no kernel there. Every block takes the
    # operators of ``_ops``, so that the same solves run on global fields
    # and on Sharded ones (a block vector [w | u | p] is one Sharded whose
    # shards hold the stacked blocks)
    def _coupled_momentum(self, u, forcing, pres, dt):
        """The momentum and pressure of a coupled step from the explicit
        ``forcing`` (which holds -grad p^n under the incremental
        projection: the coupled system takes it without, so the JAX model
        adds grad p^n back): the FEEC shell's 3x3 solve or the 2x2 one.
        Returns (u, p, faces, helm_iters, poisson_iters, helm_rnorm,
        poisson_rnorm, converged), the outer solve's count and residual
        in both slots."""
        p = self.params
        dim = self.geo.dim
        if p.numerics.projection == "incremental":
            forcing = forcing + self._ops(pres).gradient(pres, self.p_specs)
        coupled = (self._solve_momentum_coupled_feec
                   if p.use_FEEC_solver and dim == 3
                   and not p.use_schur_complement_solver
                   else self._solve_momentum_coupled)
        (u_new, p_new, new_faces, outer_iters, outer_rnorm,
         momentum_ok) = coupled(u + dt * forcing, dt)
        return (u_new, p_new, new_faces, [outer_iters] * dim, outer_iters,
                outer_rnorm, outer_rnorm, momentum_ok)

    def _coupled_blocks(self, dt: float, ops):
        """The blocks both coupled systems share, for the Rhie-Chow
        stabilized collocated pair: (G, D, stab, poisson_inv) with
        G p = dt V grad_c p, D u = V div(face-averaged u), stab p = dt
        (L_compact - L_wide) p, the pressure-velocity coupling that removes
        the collocated checkerboard mode, and poisson_inv the exact
        fast-diagonalization inverse of -L between zero-mean projections
        (``ops``: the grid's or the mesh's)."""
        vol = ops.vol

        def G_op(pp):
            return dt * vol * ops.gradient(pp, self.p_specs)

        def D_op(u):
            return vol * ops.divergence(ops.cell_faces(self.u_specs, u))

        def stab(pp):
            return dt * (ops.weak_laplacian(pp, self.p_specs)
                         - D_op(ops.gradient(pp, self.p_specs)))

        def poisson_inv(rp):
            rp0 = ops.less_mean(rp)
            fast = self._fast_poisson(rp0)
            if fast is not None:
                phi, _ = fast.solve(rp0)
            else:
                phi = self._poisson_cg(rp0).x
            return ops.less_volume_mean(phi)

        return G_op, D_op, stab, poisson_inv

    def _solve_momentum_coupled(self, rhs_u, dt):
        """The monolithic velocity-pressure saddle-point solve (JAX model:
        ``_solve_momentum_coupled``; reference: the coupled 2x2 block
        system of solve_NSE_block_preconditioned / _Schur_complement,
        boussinesq_model.tpp:1131-1414):

            A u + G p     = V rhs_u      A = V + dt/Re (-L)
            D u - stab(p) = 0

        ``use schur complement solver`` false: FGMRES(30) on the block
        system, right-preconditioned by the block-triangular (Poisson,
        Jacobi) sweep; when it misses, a retry from its iterate with the
        stronger sweep (an inner CG on the velocity block, flexible
        FGMRES(50); reference tpp:1203-1232), a host branch where the JAX
        model has ``lax.cond``. True: GMRES(30) on the pressure Schur
        complement D A^{-1} G + stab, A^{-1} an inner CG to 1e-6
        (reference tpp:1248-1414). Returns (u, p, faces, outer
        iterations, outer residual norm, converged)."""
        p = self.params
        num = p.numerics
        dim = self.geo.dim
        ops = self._ops(rhs_u)
        vol = ops.vol
        coef = self._product(dt, self.one_over_Re)

        def A_op(u):
            return vol * u - coef * ops.vector_laplacian(u, self.u_specs)

        helm_diag = vol + coef * ops.helm_diags
        G_op, D_op, stab, poisson_inv = self._coupled_blocks(dt, ops)
        f = vol * rhs_u
        total = ops.total

        if p.use_schur_complement_solver:
            A_inv = la.inverse_operator(
                A_op, preconditioner=lambda r: r / helm_diag,
                rtol=self._rtol(1e-6),
                maxiter=num.max_cg_iters, total=total)
            DAinvG = la.schur_complement(D_op, A_inv, G_op)
            res = gmres(lambda pp: DAinvG(pp) + stab(pp), D_op(A_inv(f)),
                        rtol=self._rtol(1e-6), restart=30,
                        maxiter=num.max_cg_iters,
                        preconditioner=lambda r: -poisson_inv(r) / dt,
                        record_history=self._hist_n(), total=total)
            self._stash_history("schur GMRES", res)
            p_sol = res.x
            u_sol = A_inv(f - G_op(p_sol))
        else:
            def K_op(xx):
                u, pp = _rows(xx, 0, dim), _rows(xx, dim)
                return _block(dim, A_op(u) + G_op(pp), D_op(u) - stab(pp))

            def M_inv(rr):
                ru, rp = _rows(rr, 0, dim), _rows(rr, dim)
                phat = -poisson_inv(rp) / dt
                uhat = (ru - G_op(phat)) / helm_diag
                return _block(dim, uhat, phat)

            def M_inv_strong(rr):
                ru, rp = _rows(rr, 0, dim), _rows(rr, dim)
                phat = -poisson_inv(rp) / dt
                inner = cg(A_op, ru - G_op(phat), rtol=self._rtol(1e-6),
                           maxiter=50,
                           preconditioner=lambda r: r / helm_diag,
                           dot=ops.dot)
                return _block(dim, inner.x, phat)

            b = _block(dim, f, _zeros_like(_rows(f, 0)))
            res = gmres(K_op, b, rtol=self._rtol(num.helmholtz_tol),
                        restart=30,
                        maxiter=num.max_cg_iters, preconditioner=M_inv,
                        record_history=self._hist_n(), total=total)
            self._stash_history("coupled FGMRES", res)
            if self._enable_solver_fallback and not bool(res.converged):
                # flexible: M_inv_strong holds an inner iterative CG
                res = gmres(K_op, b, x0=res.x,
                            rtol=self._rtol(num.helmholtz_tol),
                            restart=50, maxiter=num.max_cg_iters,
                            preconditioner=M_inv_strong, flexible=True,
                            record_history=self._hist_n(), total=total)
            u_sol, p_sol = _rows(res.x, 0, dim), _rows(res.x, dim)
        return self._coupled_result(u_sol, p_sol, dt, res)

    def _coupled_result(self, u_sol, p_sol, dt, res):
        """A coupled solve's return: the pressure (zero mean if asked)
        and the Rhie-Chow faces of (u_sol, p_sol), and the outer solve's
        iterations, residual norm and verdict."""
        p_new = p_sol
        if self.params.correct_pressure_to_zero_mean:
            p_new = self._ops(p_sol).less_volume_mean(p_new)
        return (u_sol, p_new, self._rhie_chow_faces(u_sol, p_sol, dt),
                res.iterations, res.residual_norm, res.converged)

    def _rhie_chow_faces(self, u_sol, p_sol, dt):
        """Staggered faces of a collocated coupled solve: the face-averaged
        velocity corrected by the compact-minus-wide pressure-gradient
        difference (discretely divergence-free to the solver's
        tolerance)."""
        ops = self._ops(p_sol)
        ufs = ops.cell_faces(self.u_specs, u_sol)
        gcfs = ops.cell_faces(self.u_specs, ops.gradient(p_sol, self.p_specs))
        gfs = ops.grad_faces(p_sol, self.p_specs)
        return list(ops.wall_faces([uf - dt * (gf - gcf)
                                    for uf, gf, gcf in zip(ufs, gfs, gcfs)]))

    def _solve_momentum_coupled_feec(self, rhs_u, dt):
        """The monolithic 3x3 vorticity-velocity-pressure solve of the FEEC
        shell (JAX model: ``_solve_momentum_coupled_feec``; reference:
        ExteriorCalculus solve_NSE_block_preconditioned,
        boussineq_model_FEEC.tpp:1268-1477), on x = [w (3) | u (3) | p]:

            Mw w - Cw u           = 0       (w = curl u weakly)
            B10 w + Mu u + G p    = V rhs_u (B10 = dt/Re V curl)
            D u - stab(p)         = 0

        by flexible FGMRES(16), right-preconditioned by the
        block-triangular sweep w -> u -> p: w_hat = Mw^{-1} rw, u_hat the
        shifted Schur complement Mu - B10 Mw^{-1} B01 inverted by a
        truncated Jacobi-preconditioned GMRES(3) (reference
        shifted_schur_complement.hpp:155-171, 277-298), p_hat the exact
        Poisson solve. The inner GMRES is nonlinear in its input, so the
        outer solve stores its Z vectors. On a mesh the curls cross the
        pole with the velocity's sign pattern, the vorticity's as the
        velocity's (``ShardedStep.curl``)."""
        num = self.params.numerics
        dim = self.geo.dim
        ops = self._ops(rhs_u)
        vol = ops.vol
        k_visc = self._product(dt, self.one_over_Re)
        G_op, D_op, stab, poisson_inv = self._coupled_blocks(dt, ops)

        def curl(v):
            return ops.curl(v, self.u_specs)

        def mass(w):              # Mw and Mu: the diagonal mass
            return vol * w

        def Mw_inv(rw):
            return rw / vol

        def B01_op(u):            # the w row's coupling: -V curl u
            return -vol * curl(u)

        def B10_op(w):            # the u row's: dt/Re V curl w
            return k_visc * vol * curl(w)

        sh_diag = vol + k_visc * ops.helm_diags
        shifted_inv = la.approximate_inverse(
            la.shifted_schur_complement(mass, B10_op, Mw_inv, B01_op),
            n_iter=3, rtol=self._rtol(0.0), solver="gmres", restart=3,
            preconditioner=lambda r: r / sh_diag, total=ops.total)

        def K_op(xx):
            w, u, pp = (_rows(xx, 0, dim), _rows(xx, dim, 2 * dim),
                        _rows(xx, 2 * dim))
            return _block(dim, mass(w) + B01_op(u),
                          B10_op(w) + mass(u) + G_op(pp),
                          D_op(u) - stab(pp))

        def M_inv(rr):
            rw, ru, rp = (_rows(rr, 0, dim), _rows(rr, dim, 2 * dim),
                          _rows(rr, 2 * dim))
            what = Mw_inv(rw)
            uhat = shifted_inv(ru - B10_op(what))
            phat = -poisson_inv(rp) / dt
            return _block(dim, what, uhat, phat)

        f = vol * rhs_u
        b = _block(dim, _zeros_like(f), f, _zeros_like(_rows(f, 0)))
        res = gmres(K_op, b, rtol=self._rtol(num.helmholtz_tol), restart=16,
                    maxiter=num.max_cg_iters, preconditioner=M_inv,
                    flexible=True, record_history=self._hist_n(),
                    total=ops.total)
        self._stash_history("FEEC 3x3 FGMRES", res)
        return self._coupled_result(_rows(res.x, dim, 2 * dim),
                                    _rows(res.x, 2 * dim), dt, res)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _strong(self, on: bool = True):
        """Every solve inside takes the full CG path (``on``)."""
        old = self._force_cg
        self._force_cg = old or on
        try:
            yield
        finally:
            self._force_cg = old

    def step(self, state: State, dt: float):
        """One time step; returns (new_state, diagnostics). Diagnostics
        stay on the device until a field is read (one packed copy)."""
        new_state, packed, _ = self._step_impl(state, dt)
        return new_state, StepDiagnostics(packed, self.geo.dim)

    _HIST_CAP = 48  # recorded residual-trail length per solve

    def _hist_n(self) -> int:
        """record_history length for the solver calls (0 disables;
        reference: deallog depth from 'solver diagnostics level',
        main.cxx:89-90)."""
        return self._HIST_CAP if self._solver_trace else 0

    def _stash_history(self, name: str, res) -> None:
        if self._solver_trace and res.history is not None:
            self._trace_sink.append((name, res.history))

    def step_verbose(self, state: State, dt: float):
        """One step that also returns the per-iteration residual trails
        of its solves — the CLI path for `solver diagnostics level` >= 3
        (JAX model: ``step_verbose``). As there, the step takes the
        unfused branch (Richardson or CG solves, then the projection), as
        K1 records no iterate's residual; K2 and K5 still run. The trails
        reach the host in one copy. Returns (new_state, diagnostics,
        {solver name: float32 numpy trail, NaN-padded to _HIST_CAP})."""
        old = self._solver_trace
        self._solver_trace = True
        self._trace_sink = []
        try:
            new_state, packed, _ = self._step_impl(state, dt)
            sink, self._trace_sink = self._trace_sink, []
        finally:
            self._solver_trace = old
        hists = {}
        if sink:
            flat = torch.cat([h for _, h in sink]).cpu().numpy()
            for i, (name, _) in enumerate(sink):
                hists[name] = flat[i * self._HIST_CAP:
                                   (i + 1) * self._HIST_CAP]
        return new_state, StepDiagnostics(packed, self.geo.dim), hists

    def step_strong(self, state: State, dt: float):
        """Redo one step with the full CG solves — the escalation taken
        when ``diagnostics.solver_ok`` is False on the fast path
        (reference: boussinesq_model.tpp:1203-1232)."""
        with self._strong():
            new_state, packed, _ = self._step_impl(state, dt)
        return new_state, StepDiagnostics(packed, self.geo.dim)

    def temperature_step(self, state: State, dt: float):
        """One temperature-only substep (``NSE solver interval`` > 1)."""
        new_state, packed, _ = self._temperature_step_impl(state, dt)
        return new_state, StepDiagnostics(packed, self.geo.dim)

    def temperature_step_strong(self, state: State, dt: float):
        with self._strong():
            new_state, packed, _ = self._temperature_step_impl(state, dt)
        return new_state, StepDiagnostics(packed, self.geo.dim)

    # ------------------------------------------------------------------
    def _next_dt(self, packed: torch.Tensor) -> float:
        """The CFL time step from a step's packed diagnostics, rounded as
        the JAX package's scan computes it (in the working dtype)."""
        rnd = self._scalar
        deg = max(self.params.temperature_degree,
                  self.params.nse_velocity_degree)
        cfl = max(rnd(float(packed[0])), rnd(1e-30))
        return rnd(rnd(self._dt_scaling_const()) / rnd(rnd(deg) * cfl))

    def _chunk(self, state: State, dt: float, n_steps: int,
               collect: bool, adaptive: bool):
        """The steps of one multi_step chunk, eagerly (on the card also
        the body that models/graphs.py captures). Each step is an NSE
        step or a temperature substep by ``step_number % NSE solver
        interval``. With ``adaptive`` the CFL dt is recomputed after
        every step whose new step count is an interval boundary (one
        device->host read each). Returns (state, packed[n_steps, k] or
        packed[1, k], dt_out)."""
        interval = self.params.NSE_solver_interval
        dt_now = self._scalar(dt)
        rows, okmin, packed = [], None, None
        for j in range(n_steps):
            full = collect or adaptive or j == n_steps - 1
            impl = (self._step_impl if state.step_number % interval == 0
                    else self._temperature_step_impl)
            state, packed, ok = impl(state, dt_now, full)
            okmin = ok if okmin is None else torch.minimum(okmin, ok)
            if collect:
                rows.append(packed)
            if adaptive and state.step_number % interval == 0:
                dt_now = self._next_dt(packed)
        if collect:
            return state, torch.stack(rows), dt_now
        # solver_ok reports the AND over every step of the chunk
        last = torch.cat([packed[:10], okmin.reshape(1), packed[11:]])
        return state, last[None], dt_now

    @property
    def _fixed_gate(self) -> bool:
        """Whether the gate redoes a missed fast step (or chunk) with full
        CG: whenever a fixed-iteration solve runs on the fast path, that
        is ``fixed solver iters`` > 0 (Richardson temperature, and
        momentum beside it), or Richardson momentum beside CG
        temperature (``momentum fixed iters`` > 0 on the projection path
        without the direct Helmholtz solve). The JAX package keys its
        gate on ``fixed solver iters`` > 0 alone (its ``multi_step`` and
        ``run``), so that there a momentum Richardson miss beside CG
        temperature is reported as solver_ok false and never redone
        (ROADMAP.md Queue 3)."""
        num = self.params.numerics
        return num.fixed_solver_iters > 0 or (
            self.momentum_iters > 0 and self.momentum_solver == "projection"
            and self.helmholtz_direct is None)

    def _graphable(self, adaptive: bool, force_cg: bool) -> bool:
        """Whether a chunk runs as a CUDA graph: on the card, with a
        fixed dt (``dt`` reaches K1, K2 and K5 as a host double, so an
        adaptive chunk's graph would be stale after its first boundary),
        and no Krylov solve (the CG and GMRES loops read their stopping
        tests back every iteration: escalated chunks, ``fixed solver
        iters`` = 0 without the direct Helmholtz solves, Richardson
        momentum beside CG temperature included, the coupled solves, the
        Poisson CG of ``poisson solver = cg | mg`` and the fast solve's
        own CG on a shell of non-uniform radial spacing,
        ``ShellPoissonSpectral``)."""
        no_cg = (self.params.numerics.fixed_solver_iters > 0
                 or self.helmholtz_direct is not None)
        return (self.device.type == "cuda" and not adaptive
                and not force_cg and no_cg
                and self.momentum_solver != "coupled"
                and self.poisson_spectral is not None
                and not getattr(self.poisson_spectral, "iterative", False))

    def multi_step(self, state: State, dt: float, n_steps: int,
                   collect_diagnostics: bool = True, adaptive: bool = False,
                   force_cg: bool = False):
        """Advance ``n_steps`` steps in one chunk — the JAX package's
        jitted ``lax.scan`` (models/boussinesq.py multi_step); on the
        card a chunk with a fixed dt that runs no CG is one replay of a
        captured CUDA graph (models/graphs.py), one host launch instead
        of ~120 a step. ``NSE solver interval`` sub-cycling and, with
        ``adaptive=True``, the CFL dt at interval boundaries run inside
        the chunk.

        Returns (final_state, packed[n_steps, k], dt_out), the rows
        pulled to the host in one copy; with ``collect_diagnostics=
        False`` only the last step's diagnostics are computed (packed[1,
        k]), its solver_ok the AND over every step (each step still runs
        the gate's reductions).

        The gate: if any step of a fast chunk misses, the whole chunk is
        redone with full CG from the original state (host-level
        NoConvergence retry, reference boussinesq_model.tpp:1203-1232),
        and the escalation window counts down by ``n_steps`` on clean
        strong chunks. Escalated and adaptive chunks run eagerly."""
        if n_steps < 1:
            raise ValueError(f"multi_step needs n_steps >= 1, not {n_steps}")
        escalated = self._strong_steps_left > 0
        if escalated:
            # escalation window: straight to full CG, no doomed fast try
            force_cg = True
        if not is_sharded(state) and self._graphable(adaptive, force_cg):
            if self.chunk_graphs is None:
                from dycoreplanet_tpu_torch.models.graphs import ChunkGraphs
                self.chunk_graphs = ChunkGraphs(self)
            out = self.chunk_graphs.run(state, dt, n_steps,
                                        collect_diagnostics)
        else:
            with self._strong(force_cg):
                out = self._chunk(state, dt, n_steps, collect_diagnostics,
                                  adaptive)
        if self._fixed_gate:
            ok = float(out[1][:, 10].min())     # one pull per chunk
            if not force_cg:
                if ok < 0.5:
                    warnings.warn(
                        "fixed-iteration solver missed tolerance; retrying "
                        "chunk with full CG (fast path retried after "
                        f"{self._fast_penalty()} clean strong steps)",
                        RuntimeWarning, stacklevel=2)
                    self._escalate()
                    return self.multi_step(state, dt, n_steps,
                                           collect_diagnostics, adaptive,
                                           force_cg=True)
                # clean fast chunk: reset the repeat-miss penalty
                self._fast_penalty_now = self._fast_rearm_steps
            elif escalated and ok >= 0.5:
                self._strong_steps_left = max(
                    0, self._strong_steps_left - n_steps)
        return out

    # ------------------------------------------------------------------
    def _dt_scaling_const(self) -> float:
        dim = self.geo.dim
        scaling = 0.25 if dim == 3 else 1.0
        return scaling / (2.1 * dim * math.sqrt(1.0 * dim))

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
        escalation, the JAX package's run line for line. Starts from
        ``state`` (default: the initial state). Returns the final state
        and per-step diagnostic records."""
        p = self.params
        if state is None:
            state = self.initial_state()
            if self._mesh is not None:
                state = shard_state(state, self.geo, self._mesh.mesh)
        dt = p.time_step
        history: List[Dict] = []
        time_index = float(state.time)
        n = 0
        # `residual check interval` = M > 1: NSE residuals are evaluated
        # on every M-th NSE step only. Keep a snapshot of the last
        # verified state, so that a checked-step miss rewinds and redoes
        # the whole unchecked window under the full-CG escalation window
        use_rewind = (p.numerics.residual_check_interval > 1
                      and p.numerics.fixed_solver_iters > 0)
        chk_snapshot = ((state, 0, time_index, dt, 0) if use_rewind
                        else None)
        while time_index <= p.final_time:
            if max_steps is not None and n >= max_steps:
                break
            # NSE solved at step 0 and every interval-th step; the other
            # iterations advance temperature only (reference:
            # boussinesq_model.tpp:1867-1905)
            nse_step = n % p.NSE_solver_interval == 0
            state_prev = state
            escalated = self._strong_steps_left > 0
            if escalated:
                # escalation window: full-CG steps; each clean one counts
                # toward re-arming the fast path
                if nse_step:
                    state, diag = self.step_strong(state, dt)
                else:
                    state, diag = self.temperature_step_strong(state, dt)
                if diag.solver_ok:
                    self._strong_steps_left -= 1
            elif nse_step:
                state, diag = self.step(state, dt)
            else:
                state, diag = self.temperature_step(state, dt)
            if not escalated and self._fixed_gate:
                if not diag.solver_ok:
                    self._escalate()
                    if (chk_snapshot is not None and nse_step
                            and chk_snapshot[1] < n):
                        # interval-mode rewind: the unchecked steps since
                        # the last verified state carry no residual
                        # evidence of their own; discard them all and
                        # redo the window under the escalation just
                        # opened (at most M * interval - 1 re-steps)
                        state, n, time_index, dt, hlen = chk_snapshot
                        self._strong_steps_left = max(
                            self._strong_steps_left,
                            len(history) - hlen + 1)
                        del history[hlen:]
                        continue
                    # redo the step with full CG (NoConvergence retry)
                    if nse_step:
                        state, diag = self.step_strong(state_prev, dt)
                    else:
                        state, diag = self.temperature_step_strong(
                            state_prev, dt)
                else:
                    # clean fast step: reset the repeat-miss penalty
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
            # adaptive dt (reference: recompute only for step > 0 at
            # NSE-interval boundaries, tpp:1845-1850)
            if p.adapt_time_step and n % p.NSE_solver_interval == 0:
                dt = self.compute_time_step(float(diag.cfl))
            # interval mode: advance the verified snapshot on NSE steps
            # whose residuals were evaluated (checked fast steps, strong
            # redos, escalation-window steps) and passed
            if (chk_snapshot is not None and nse_step and diag.solver_ok
                    and (escalated
                         or float(diag.helmholtz_residual) >= 0.0)):
                chk_snapshot = (state, n, time_index, dt, len(history))
        return state, history
