from dycoreplanet_tpu_torch.models.boussinesq import (  # noqa: F401
    BoussinesqModel,
    State,
    StepDiagnostics,
)


def make_model(params, geometry=None, device=None):
    """Model dispatch, as the JAX package's ``make_model`` (the
    reference's dim x use_FEEC_solver dispatch, source/main.cxx:92-125,
    extended by the `feec formulation` knob): FEEC + staggered -> the
    mimetic C-grid model (models/mimetic.py), everything else ->
    BoussinesqModel. ``device`` as BoussinesqModel's: None runs on CUDA
    and raises without it."""
    if (params.use_FEEC_solver
            and params.numerics.feec_formulation == "staggered"):
        from dycoreplanet_tpu_torch.models.mimetic import (
            MimeticBoussinesqModel)

        return MimeticBoussinesqModel(params, geometry, device=device)
    return BoussinesqModel(params, geometry, device=device)
