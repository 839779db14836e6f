from dycoreplanet_tpu_torch.base import nondim, params, prm  # noqa: F401
