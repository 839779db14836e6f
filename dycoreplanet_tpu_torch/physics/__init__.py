from dycoreplanet_tpu_torch.physics import closures, initial_data  # noqa: F401
