from dycoreplanet_tpu_torch.solvers.cg import cg, CGResult  # noqa: F401
from dycoreplanet_tpu_torch.solvers.fixed import richardson_solve  # noqa: F401
