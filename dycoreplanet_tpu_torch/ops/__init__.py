from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec  # noqa: F401
from dycoreplanet_tpu_torch.ops import stencil  # noqa: F401
