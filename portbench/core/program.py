"""The system under test, reached through its public constructor: the
port's ``Parameters`` filled from a configuration file and a traffic
file, ``BoussinesqModel(params)``, and the seeded inputs as its
``State``. The only module of the benchmark that imports the program."""

from __future__ import annotations

from reference.model import Fields

GROUPS = ("reference_quantities", "physical_constants", "numerics")


def parameters(config: dict, traffic: dict):
    """The port's Parameters of the configuration, its grid and dt from
    the traffic."""
    from dycoreplanet_tpu_torch.base.params import Parameters

    p = Parameters.from_text("")
    for key, value in config.items():
        if hasattr(p, key) and key not in GROUPS:
            setattr(p, key, value)
    for group in GROUPS:
        obj = getattr(p, group)
        for key, value in config[group].items():
            if not hasattr(obj, key):
                raise KeyError(f"{group}.{key} is no parameter of the port")
            setattr(obj, key, value)
        obj.__post_init__()
    grid = traffic["grid"]
    num = p.numerics
    if len(grid) == 3:
        num.n_radial, num.n_lat, num.n_lon = grid
    else:
        num.n_radial, num.n_lon = grid
    p.time_step = traffic["dt"]
    return p


def model(config: dict, traffic: dict, device=None):
    """``BoussinesqModel(params)`` on ``device`` (None: the card)."""
    from dycoreplanet_tpu_torch.models.boussinesq import BoussinesqModel

    return BoussinesqModel(parameters(config, traffic), device=device)


def state(fields: Fields):
    """The program's State holding ``fields`` at time 0, step 0."""
    from dycoreplanet_tpu_torch.models.boussinesq import State

    return State(u=fields.u, u_faces=tuple(fields.u_faces), p=fields.p,
                 T=fields.T, time=0.0, step_number=0)


def fields(state) -> Fields:
    return Fields(state.u, tuple(state.u_faces), state.p, state.T)
