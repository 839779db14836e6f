"""Typed configuration mirroring the reference's parameter system.

Three structs, each reading its own subsection of the same ``.prm`` file,
with the reference's names, defaults and derived quantities:

  * ``Parameters``          — "Boussinesq Model" (+ "Mesh parameters")
                              (reference: source/model_data/boussinesq_model_parameters.cc:52-239)
  * ``ReferenceQuantities`` — "Boussinesq Model/Reference quantities"
                              (reference: source/model_data/reference_quantities.cc:37-88)
  * ``PhysicalConstants``   — "Physical Constants"
                              (reference: source/model_data/physical_constants.cc:50-167)

Derived at parse time exactly like the reference:
  time = length / velocity                          (reference_quantities.cc:87)
  kinematic_viscosity = dynamic_viscosity / density (physical_constants.cc:150)
  thermal_diffusivity = k / (c_p * pressure)        (physical_constants.cc:156;
      note the reference divides by *pressure*, not density — reproduced
      deliberately for parity)
  R1 = R0 + atm_height                              (physical_constants.cc:164)

The reference has a chained-assignment typo
``adapt_time_step = use_FEEC_solver = prm.get_bool("adapt time step")``
(boussinesq_model_parameters.cc:207) that is immediately overwritten and
therefore harmless; we implement the intended semantics.

TPU-specific numerics knobs live in the separate "Numerics" subsection
(all optional, defaulted) so reference ``.prm`` files work unmodified.

This module is a copy of the JAX package's ``base/params.py`` so that
both packages parse the same ``.prm`` text into the same values; the
comments on TPU behaviour describe the JAX package. The PyTorch port
raises ``NotImplementedError`` for the knobs it does not run yet
(models/boussinesq.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

from dycoreplanet_tpu_torch.base.prm import ParameterFileError, PrmHandler

_BM = ("Boussinesq Model",)
_MESH = ("Boussinesq Model", "Mesh parameters")
_REF = ("Boussinesq Model", "Reference quantities")
_PC = ("Physical Constants",)
_NUM = ("Numerics",)


@dataclass
class ReferenceQuantities:
    velocity: float = 10.0
    length: float = 1.0e4
    temperature_ref: float = 273.15
    temperature_change: float = 5.0
    # derived
    time: float = field(init=False, default=0.0)

    def __post_init__(self) -> None:
        self.time = self.length / self.velocity


@dataclass
class PhysicalConstants:
    pressure: float = 1.01325e5
    omega: float = 7.272205e-5
    density: float = 1.29
    universal_gas_constant: float = 8.31446261815324
    specific_gas_constant_dry: float = 287.0
    expansion_coefficient: float = 0.003661
    dynamic_viscosity: float = 1.82e-5
    specific_heat_p: float = 1.005
    specific_heat_v: float = 0.718
    thermal_conductivity: float = 2.62e-2
    radiogenic_heating: float = 7.4e-12
    gravity_constant: float = 9.81
    speed_of_sound: float = 331.5
    atm_height: float = 1.0e5
    R0: float = 6.371e6
    # derived
    kinematic_viscosity: float = field(init=False, default=0.0)
    thermal_diffusivity: float = field(init=False, default=0.0)
    R1: float = field(init=False, default=0.0)

    def __post_init__(self) -> None:
        self.kinematic_viscosity = self.dynamic_viscosity / self.density
        # Reference divides by pressure (physical_constants.cc:156).
        self.thermal_diffusivity = self.thermal_conductivity / (
            self.specific_heat_p * self.pressure
        )
        self.R1 = self.R0 + self.atm_height


@dataclass
class Numerics:
    """TPU-framework numerics (new; no reference analogue).

    The reference's resolution axis is ``initial global refinement`` on a
    coarse mesh of 12 (2D) / 6 (3D) cells; our structured grids derive
    their point counts from the same refinement integer (see
    grid/resolution.py) unless explicitly overridden here.
    """

    dtype: str = "float32"            # compute dtype: float32|float64|bfloat16
    use_pallas: Optional[bool] = None  # None = auto (TPU only)
    poisson_solver: str = "auto"       # auto|fft|cg|mg
    # implicit momentum/temperature Helmholtz solves: "auto"/"cg" use
    # Jacobi-CG (fastest at the reference configs: the mass-dominated
    # operator converges in a handful of iterations), "direct" the
    # exact fast-diagonalization solver (flat cost — best for stiff
    # regimes where CG iteration counts grow; solvers/helmholtz.py)
    helmholtz_solver: str = "auto"     # auto|direct|cg
    # momentum solve strategy: "projection" (TPU-native incremental
    # pressure projection) or "coupled" (monolithic velocity-pressure
    # saddle-point solve like the reference's; then `use schur
    # complement solver` picks FGMRES-block vs Schur path, reference:
    # boussinesq_model.tpp:1131-1414). "auto" = coupled for FEEC runs
    # (the reference's FEEC configs always run the monolithic 3x3
    # block-preconditioned solve, boussineq_model_FEEC.tpp:1268-1477),
    # projection otherwise.
    momentum_solver: str = "auto"
    # buoyancy formulation: "perturbation" applies (rho(T)-1) g with the
    # constant-density hydrostatic part absorbed analytically into a
    # background pressure (well-balanced: no discrete spurious currents
    # from the large gradient force); "full" applies rho(T) g like the
    # reference's RHS (boussinesq_model.tpp:643-650) and leaves the
    # hydrostatic balance to the discrete pressure
    buoyancy: str = "perturbation"
    # advection face reconstruction: muscl (2nd-order van Leer TVD,
    # default — accuracy peer of the reference's Q2 transport),
    # upwind (1st order), centered (2nd order, unlimited)
    advection_scheme: str = "muscl"
    # temperature transport: "eulerian" (MUSCL/upwind flux form) or
    # "semi-lagrangian" (unconditionally stable backward-trajectory
    # gather — pairs with NSE-interval sub-cycling at large CFL)
    temperature_advection: str = "eulerian"
    # Coriolis handling: "reference" reproduces the reference's quirks
    # (no Coriolis in the 3D shell standard path, un-scaled 2D term —
    # SURVEY.md section 7.5); "physical" applies the documented
    # equations (2 Omega x u everywhere)
    coriolis_mode: str = "reference"
    # FEEC personality realization: "coupled" solves the monolithic 3x3
    # w-u-p block system on the collocated grid with rotational-form
    # advection (reference parity: boussineq_model_FEEC.tpp:1268-1477);
    # "staggered" runs the fully mimetic C-grid model — prognostic
    # face-flux velocity, edge vorticity, exact div/curl identities in
    # the dynamics (models/mimetic.py; cuboid + annulus geometries)
    feec_formulation: str = "coupled"
    # with helmholtz_solver = "auto"/"cg": number of straight-line
    # Jacobi-Richardson steps tried BEFORE falling back to the CG
    # while_loop (solvers/fixed.py). The mass-dominated systems at the
    # reference configs converge within these, so the common path has
    # no while_loop scaffolding; tolerance semantics are unchanged
    # (exact residual check + lax.cond fallback). 0 = always CG.
    fixed_solver_iters: int = 2
    # Richardson iteration count for the MOMENTUM Helmholtz solve only
    # (temperature keeps fixed_solver_iters). The momentum tolerance
    # (1e-8, reference tpp:1166) sits four orders looser than
    # temperature's 1e-12 (tpp:1431), so one fewer iteration usually
    # suffices — measured at the 32x128x256 bench config: k=1 momentum
    # residual 4.6e-10 vs the 1e-8 tolerance. 0 = same as
    # fixed_solver_iters (the conservative default); the tracked-
    # residual honesty gate escalates to full CG if the count proves
    # insufficient. Production opt-in: `momentum fixed iters = 1`.
    momentum_fixed_iters: int = 0
    # Check the exactly tracked Richardson residuals every N steps
    # (1 = every step, the reference's per-solve semantics,
    # tpp:1203-1232 — the default). N > 1 is a measured-performance
    # opt-in for the fused Pallas implicit stage: the in-between steps
    # run a residual-free kernel variant (the last update of each
    # system skips its r-update and the radial ghost depth drops by
    # one — ~45% fewer stencil applies), report residual = -1
    # ("unchecked") in the step diagnostics, and the honesty gate /
    # CG escalation fires from the checked steps. The ITERATION COUNTS
    # and the iterates themselves are identical either way (to f32 reassociation)
    # (pinned in tests/test_pallas_richardson.py).
    residual_check_interval: int = 1
    # widen the shell IC Gaussians by this factor (1.0 = reference
    # widths; see physics/initial_data.py and PARITY.md "Known quirks")
    ic_width_scale: float = 1.0
    # MXU pass mode of the fast-diagonalization Poisson transforms
    # (TPU-only distinction): "highest" = f32-accurate bf16x6 passes;
    # "high" = bf16x3 (measured at 32x128x256 f32: 0.046 vs 0.100 ms,
    # solve rel err 2.3e-5 — the canonical figure; full table in
    # PERF.md. No measurable effect on the projected trajectory, see
    # models/boussinesq.py); "high-refine" = bf16x3 + ONE exact-stencil
    # refinement pass (rel err 1.7e-7, but slower than "highest":
    # 0.152 ms). "auto" = high for float32 on TPU when `poisson tol`
    # >= 1e-4 (so the 2.3e-5 direct-solve error demonstrably meets the
    # configured tolerance), highest otherwise.
    poisson_precision: str = "auto"
    helmholtz_tol: float = 1e-8        # momentum solve rel tol (reference: tpp:1166 1e-8*rhs)
    temperature_tol: float = 1e-12     # temperature CG rel tol (reference: tpp:1431 1e-12*rhs)
    poisson_tol: float = 1e-8
    max_cg_iters: int = 500
    projection: str = "incremental"    # incremental|pressure-free
    # explicit grid override (0 = derive from refinement)
    n_radial: int = 0
    n_lat: int = 0
    n_lon: int = 0
    nx: int = 0
    ny: int = 0
    nz: int = 0
    # sharding: names of mesh axes and sizes, e.g. "x:2,y:4" ("" = single device)
    mesh_axes: str = ""

    # allowed values per enumerated knob: a typo like 'driect' must fail
    # loudly instead of silently falling back to another solver path
    _CHOICES = {
        "dtype": ("float32", "float64", "bfloat16"),
        "poisson_solver": ("auto", "fft", "cg", "mg"),
        "poisson_precision": ("auto", "highest", "high", "high-refine"),
        "helmholtz_solver": ("auto", "direct", "cg"),
        "momentum_solver": ("auto", "projection", "coupled"),
        "buoyancy": ("perturbation", "full"),
        "advection_scheme": ("muscl", "upwind", "centered"),
        "temperature_advection": ("eulerian", "semi-lagrangian"),
        "coriolis_mode": ("reference", "physical"),
        "feec_formulation": ("coupled", "staggered"),
        "projection": ("incremental", "pressure-free"),
    }

    def __post_init__(self) -> None:
        for name, allowed in self._CHOICES.items():
            val = getattr(self, name)
            if val not in allowed:
                raise ValueError(
                    f"Numerics.{name} = {val!r} invalid; "
                    f"expected one of {allowed}")


@dataclass
class Parameters:
    """Full run configuration (reference: boussinesq_model_parameters.h:20-67)."""

    # Mesh parameters
    initial_global_refinement: int = 3
    cuboid_geometry: bool = False
    # Boussinesq Model
    space_dimension: int = 2
    final_time: float = 1.0
    time_step: float = 0.1
    adapt_time_step: bool = False
    nse_theta: float = 0.5
    nse_velocity_degree: int = 2
    use_FEEC_solver: bool = False
    use_block_preconditioner_feec: bool = True
    correct_pressure_to_zero_mean: bool = False
    use_locally_conservative_discretization: bool = True
    solver_diagnostics_print_level: int = 1
    use_schur_complement_solver: bool = False
    use_direct_solver: bool = False
    NSE_solver_interval: int = 1
    temperature_theta: float = 0.5
    temperature_degree: int = 2
    filename_output: str = "dycore"
    dirname_output: str = "data-output"
    hello_from_cluster: bool = False
    # nested structs
    reference_quantities: ReferenceQuantities = field(default_factory=ReferenceQuantities)
    physical_constants: PhysicalConstants = field(default_factory=PhysicalConstants)
    numerics: Numerics = field(default_factory=Numerics)

    # ------------------------------------------------------------------
    @staticmethod
    def _declare(prm: PrmHandler) -> None:
        d = prm.declare
        d(_MESH, "initial global refinement", "3", "integer",
          "The number of global refinement steps performed on the initial coarse mesh.")
        d(_MESH, "cuboid geometry", "false", "bool",
          "Sets the domain geometry to cuboid; all directions but z periodic.")
        d(_BM, "space dimension", "2", "integer", "Spatial dimension of the problem.")
        d(_BM, "final time", "1.0", "double", "The end time of the simulation.")
        d(_BM, "time step", "0.1", "double", "Time step size.")
        d(_BM, "adapt time step", "false", "bool",
          "Flag to adapt time step by recomputing the CFL number.")
        d(_BM, "nse theta", "0.5", "double", "Theta value for theta method.")
        d(_BM, "nse velocity degree", "2", "integer",
          "Polynomial degree for velocity (kept for CFL-formula parity).")
        d(_BM, "use FEEC solver", "false", "bool",
          "Use the structure-preserving (mimetic / vector-invariant) formulation.")
        d(_BM, "use block preconditioner feec", "true", "bool",
          "Use a block preconditioner for the FEEC system.")
        d(_BM, "correct pressure to zero mean", "false", "bool",
          "Use pressure correction for certain types of BCs.")
        d(_BM, "use locally conservative discretization", "true", "bool",
          "Locally conservative discretization (FV build is always conservative).")
        d(_BM, "solver diagnostics level", "1", "integer", "Solver output level.")
        d(_BM, "use schur complement solver", "false", "bool",
          "Reference solver-path flag (both paths map to projection here).")
        d(_BM, "use direct solver", "false", "bool", "Direct solver flag.")
        d(_BM, "NSE solver interval", "1", "integer",
          "Apply the NSE solver only every n-th time step.")
        d(_BM, "temperature theta", "0.5", "double", "Theta value for theta method.")
        d(_BM, "temperature degree", "2", "integer", "Polynomial degree for temperature.")
        d(_BM, "filename output", "dycore", "string", "Base filename for output.")
        d(_BM, "dirname output", "data-output", "string", "Name of output directory.")
        d(_BM, "hello from cluster", "false", "bool", "Per-process hello output.")
        # Reference quantities (reference: reference_quantities.cc:37-64)
        d(_REF, "velocity", "10", "double", "Reference velocity [m/s].")
        d(_REF, "length", "1e+4", "double", "Reference length [m].")
        d(_REF, "temperature", "273.15", "double", "Reference temperature at bottom [K].")
        d(_REF, "temperature change", "5", "double", "Reference temperature change [K].")
        # Physical constants (reference: physical_constants.cc:50-140)
        d(_PC, "average atm pressure", "1.01325e+5", "double", "Reference pressure [Pa].")
        d(_PC, "omega", "7.272205e-5", "double", "Planetary angular velocity [1/s].")
        d(_PC, "density", "1.29", "double", "Air density [kg/m^3].")
        d(_PC, "universal gas constant", "8.31446261815324", "double", "[J/(mol K)]")
        d(_PC, "specific gas constant dry", "287.0", "double", "[J/(kg K)]")
        d(_PC, "expansion coefficient", "0.003661", "double", "[1/K]")
        d(_PC, "dynamic viscosity", "1.82e-5", "double", "[kg/(m s)]")
        d(_PC, "specific heat p", "1.005", "double", "[J/(K kg)]")
        d(_PC, "specific heat v", "0.718", "double", "[J/(K kg)]")
        d(_PC, "thermal conductivity", "2.62e-2", "double", "[W/(m K)]")
        d(_PC, "radiogenic heating", "7.4e-12", "double", "[W/kg]")
        d(_PC, "gravity constant", "9.81", "double", "[m/s^2]")
        d(_PC, "speed of sound", "331.5", "double", "[m/s]")
        d(_PC, "atm height", "1.0e+5", "double", "[m]")
        d(_PC, "R0", "6.371000e+6", "double", "Inner radius [m].")
        # Numerics (new subsection; absent from reference files -> defaults)
        d(_NUM, "dtype", "float32", "string", "Compute dtype.")
        d(_NUM, "use pallas", "auto", "string", "Pallas kernels: auto|true|false.")
        d(_NUM, "poisson solver", "auto", "string", "auto|fft|cg|mg.")
        d(_NUM, "poisson precision", "auto", "string",
          "auto|highest|high|high-refine fast-diag transform precision.")
        d(_NUM, "helmholtz solver", "auto", "string",
          "auto|direct|cg implicit momentum/temperature solves.")
        d(_NUM, "helmholtz tol", "1e-8", "double", "Momentum solve relative tolerance.")
        d(_NUM, "temperature tol", "1e-12", "double", "Temperature CG relative tolerance.")
        d(_NUM, "poisson tol", "1e-8", "double", "Pressure Poisson relative tolerance.")
        d(_NUM, "max cg iters", "500", "integer", "CG iteration cap.")
        d(_NUM, "ic width scale", "1.0", "double",
          "Widen the shell IC Gaussians (1.0 = reference widths).")
        d(_NUM, "fixed solver iters", "2", "integer",
          "Jacobi-Richardson steps before the CG fallback (0 = always CG).")
        d(_NUM, "momentum fixed iters", "0", "integer",
          "Momentum-only Richardson count (0 = fixed solver iters).")
        d(_NUM, "residual check interval", "1", "integer",
          "Check tracked Richardson residuals every N steps (1 = "
          "every step; N>1 runs a residual-free fused kernel between "
          "checks, iterates identical).")
        d(_NUM, "projection", "incremental", "string", "incremental|pressure-free.")
        d(_NUM, "momentum solver", "auto", "string",
          "auto|projection|coupled (auto = coupled for FEEC, else projection).")
        d(_NUM, "buoyancy", "perturbation", "string",
          "perturbation|full (hydrostatic background split on/off).")
        d(_NUM, "advection scheme", "muscl", "string",
          "muscl|upwind|centered face reconstruction.")
        d(_NUM, "temperature advection", "eulerian", "string",
          "eulerian|semi-lagrangian temperature transport.")
        d(_NUM, "coriolis mode", "reference", "string",
          "reference|physical Coriolis treatment.")
        d(_NUM, "feec formulation", "coupled", "string",
          "coupled|staggered FEEC realization (staggered = mimetic C-grid).")
        d(_NUM, "n radial", "0", "integer", "Radial points override (0=derive).")
        d(_NUM, "n lat", "0", "integer", "Latitude points override.")
        d(_NUM, "n lon", "0", "integer", "Longitude points override.")
        d(_NUM, "nx", "0", "integer", "Cuboid x cells override.")
        d(_NUM, "ny", "0", "integer", "Cuboid y cells override.")
        d(_NUM, "nz", "0", "integer", "Cuboid z cells override.")
        d(_NUM, "mesh axes", "", "string", "Device mesh spec, e.g. 'x:2,y:4'.")

    @classmethod
    def handler(cls) -> PrmHandler:
        prm = PrmHandler()
        cls._declare(prm)
        return prm

    @classmethod
    def from_text(cls, text: str) -> "Parameters":
        prm = cls.handler()
        prm.read_text(text)
        return cls._parse(prm)

    @classmethod
    def from_file(cls, filename: str) -> "Parameters":
        """Load from a .prm file; on a missing file, write a template with
        defaults and raise (mirrors boussinesq_model_parameters.cc:32-42)."""
        if not os.path.exists(filename):
            prm = cls.handler()
            prm.write_template(filename)
            raise ParameterFileError(
                f"parameter file {filename!r} not found; a template with "
                "default values has been written to that path"
            )
        prm = cls.handler()
        prm.read(filename)
        return cls._parse(prm)

    @classmethod
    def _parse(cls, prm: PrmHandler) -> "Parameters":
        ref = ReferenceQuantities(
            velocity=prm.get_double(_REF, "velocity"),
            length=prm.get_double(_REF, "length"),
            temperature_ref=prm.get_double(_REF, "temperature"),
            temperature_change=prm.get_double(_REF, "temperature change"),
        )
        pc = PhysicalConstants(
            pressure=prm.get_double(_PC, "average atm pressure"),
            omega=prm.get_double(_PC, "omega"),
            density=prm.get_double(_PC, "density"),
            universal_gas_constant=prm.get_double(_PC, "universal gas constant"),
            specific_gas_constant_dry=prm.get_double(_PC, "specific gas constant dry"),
            expansion_coefficient=prm.get_double(_PC, "expansion coefficient"),
            dynamic_viscosity=prm.get_double(_PC, "dynamic viscosity"),
            specific_heat_p=prm.get_double(_PC, "specific heat p"),
            specific_heat_v=prm.get_double(_PC, "specific heat v"),
            thermal_conductivity=prm.get_double(_PC, "thermal conductivity"),
            radiogenic_heating=prm.get_double(_PC, "radiogenic heating"),
            gravity_constant=prm.get_double(_PC, "gravity constant"),
            speed_of_sound=prm.get_double(_PC, "speed of sound"),
            atm_height=prm.get_double(_PC, "atm height"),
            R0=prm.get_double(_PC, "R0"),
        )
        use_pallas_raw = prm.get(_NUM, "use pallas").lower()
        num = Numerics(
            dtype=prm.get(_NUM, "dtype"),
            use_pallas=None if use_pallas_raw == "auto" else use_pallas_raw == "true",
            poisson_solver=prm.get(_NUM, "poisson solver"),
            poisson_precision=prm.get(_NUM, "poisson precision"),
            helmholtz_solver=prm.get(_NUM, "helmholtz solver"),
            helmholtz_tol=prm.get_double(_NUM, "helmholtz tol"),
            temperature_tol=prm.get_double(_NUM, "temperature tol"),
            poisson_tol=prm.get_double(_NUM, "poisson tol"),
            max_cg_iters=prm.get_integer(_NUM, "max cg iters"),
            ic_width_scale=prm.get_double(_NUM, "ic width scale"),
            fixed_solver_iters=prm.get_integer(_NUM, "fixed solver iters"),
            momentum_fixed_iters=prm.get_integer(
                _NUM, "momentum fixed iters"),
            residual_check_interval=prm.get_integer(
                _NUM, "residual check interval"),
            projection=prm.get(_NUM, "projection"),
            momentum_solver=prm.get(_NUM, "momentum solver"),
            buoyancy=prm.get(_NUM, "buoyancy"),
            advection_scheme=prm.get(_NUM, "advection scheme"),
            temperature_advection=prm.get(_NUM, "temperature advection"),
            coriolis_mode=prm.get(_NUM, "coriolis mode"),
            feec_formulation=prm.get(_NUM, "feec formulation"),
            n_radial=prm.get_integer(_NUM, "n radial"),
            n_lat=prm.get_integer(_NUM, "n lat"),
            n_lon=prm.get_integer(_NUM, "n lon"),
            nx=prm.get_integer(_NUM, "nx"),
            ny=prm.get_integer(_NUM, "ny"),
            nz=prm.get_integer(_NUM, "nz"),
            mesh_axes=prm.get(_NUM, "mesh axes"),
        )
        return cls(
            initial_global_refinement=prm.get_integer(_MESH, "initial global refinement"),
            cuboid_geometry=prm.get_bool(_MESH, "cuboid geometry"),
            space_dimension=prm.get_integer(_BM, "space dimension"),
            final_time=prm.get_double(_BM, "final time"),
            time_step=prm.get_double(_BM, "time step"),
            adapt_time_step=prm.get_bool(_BM, "adapt time step"),
            nse_theta=prm.get_double(_BM, "nse theta"),
            nse_velocity_degree=prm.get_integer(_BM, "nse velocity degree"),
            use_FEEC_solver=prm.get_bool(_BM, "use FEEC solver"),
            use_block_preconditioner_feec=prm.get_bool(_BM, "use block preconditioner feec"),
            correct_pressure_to_zero_mean=prm.get_bool(_BM, "correct pressure to zero mean"),
            use_locally_conservative_discretization=prm.get_bool(
                _BM, "use locally conservative discretization"),
            solver_diagnostics_print_level=prm.get_integer(_BM, "solver diagnostics level"),
            use_schur_complement_solver=prm.get_bool(_BM, "use schur complement solver"),
            use_direct_solver=prm.get_bool(_BM, "use direct solver"),
            NSE_solver_interval=prm.get_integer(_BM, "NSE solver interval"),
            temperature_theta=prm.get_double(_BM, "temperature theta"),
            temperature_degree=prm.get_integer(_BM, "temperature degree"),
            filename_output=prm.get(_BM, "filename output"),
            dirname_output=prm.get(_BM, "dirname output"),
            hello_from_cluster=prm.get_bool(_BM, "hello from cluster"),
            reference_quantities=ref,
            physical_constants=pc,
            numerics=num,
        )
