"""dycoreplanet_tpu_torch — the PyTorch/CUDA port of dycoreplanet_tpu.

The rotating buoyancy Boussinesq dynamical core of the JAX package
(``dycoreplanet_tpu/``, the reference this port is held against),
rebuilt on PyTorch for an NVIDIA H100: plain tensor code in PyTorch, and
every Pallas kernel of the JAX package rewritten by hand in CUDA C++ for
Hopper (``csrc/``). It imports neither JAX nor the JAX package.

Layers (each mirrors its counterpart in the JAX package):
  base/        .prm parser, parameters, dimensionless numbers (copies)
  grid/        structured shell geometry and metrics (copies)
  physics/     shell temperature initial data, radial gravity
  ops/         ghost rules, stencils, vector terms, and the kernel
               wrappers: forcing (K2), richardson (K1), projection (K3)
  solvers/     CG, fixed-iteration Richardson, fast-diagonalization Poisson
  models/      BoussinesqModel (shell, standard personality, projection)
  diagnostics/ timers
  io/          VTK output (.vts, .pvd, mesh.vts, sharded .pvts) and
               checkpoints (.npz + .json), the JAX package's formats
  cli/         ``python -m dycoreplanet_tpu_torch -p file.prm``

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
