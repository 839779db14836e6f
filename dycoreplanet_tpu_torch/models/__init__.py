from dycoreplanet_tpu_torch.models.boussinesq import (  # noqa: F401
    BoussinesqModel,
    State,
    StepDiagnostics,
)
