from dycoreplanet_tpu_torch.diagnostics.timers import Timer, TimerRegistry  # noqa: F401
