"""dycoreplanet_tpu_torch — the PyTorch/CUDA port of dycoreplanet_tpu.

The rotating buoyancy Boussinesq dynamical core of the JAX package
(``dycoreplanet_tpu/``, the reference this port is held against),
rebuilt on PyTorch for an NVIDIA H100: plain tensor code in PyTorch, and
every Pallas kernel of the JAX package rewritten by hand in CUDA C++ for
Hopper (``csrc/``). It imports neither JAX nor the JAX package.

Layers (each mirrors its counterpart in the JAX package):
  base/        .prm parser, parameters, dimensionless numbers, dtypes
  grid/        the shell, annulus and cuboid (3D box, 2D slab) geometries
  physics/     initial data and closures of every geometry
  ops/         ghost rules, stencils, vector terms, the staggered (mimetic)
               operators, semi-Lagrangian transport, and the kernel
               wrappers: forcing (K2 / K2m), richardson (K1 / K1u),
               projection (K3, K5), tridiag (K4); kernel_lib builds csrc/
  solvers/     Krylov (CG, GMRES / FGMRES), fixed-iteration Richardson,
               multigrid (K4 line smoother), direct Helmholtz and the
               fast-diagonalization, direct and spectral Poisson solves,
               each with its sharded form
  linear_algebra/  operator algebra of the coupled solves (inverse
               operators, Schur complements)
  models/      BoussinesqModel (every geometry, both personalities:
               the standard advective form and FEEC's rotational form,
               the projection and the coupled 2x2 / Schur / FEEC 3x3
               solves) and MimeticBoussinesqModel (FEEC on the staggered
               C-grid); run and multi_step with the residual gate and CG
               escalation, CUDA graph chunks (graphs.py), presets
  parallel/    the mesh of shards (one process, or one a rank under
               torch.distributed: dist.py), halo transport, the sharded
               step and kernels (K1o, K2o, K2mo), the comm ledger
  diagnostics/ timers, device time from the profiler
  io/          VTK output (.vts, .pvd, mesh.vts, sharded .pvts) and
               checkpoints (.npz + .json), the JAX package's formats
  cli/         ``python -m dycoreplanet_tpu_torch -p file.prm``
  entry.py     ``entry()`` (one step of the flagship shell) and
               ``dryrun_multichip``

Entry points run on CUDA unless the caller passes ``device="cpu"``
(which runs each kernel's plain PyTorch version).
"""

__version__ = "0.1.0"

from dycoreplanet_tpu_torch.base.params import Parameters  # noqa: F401
from dycoreplanet_tpu_torch.models.boussinesq import (  # noqa: F401
    BoussinesqModel,
    State,
    StepDiagnostics,
)
