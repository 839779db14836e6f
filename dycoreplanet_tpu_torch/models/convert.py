"""Carry a model state across the host boundary as numpy arrays — the
way the tests hand a state of the JAX package to the port and back."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from dycoreplanet_tpu_torch.models.boussinesq import BoussinesqModel, State


def state_from_numpy(model: BoussinesqModel, u, u_faces: Sequence, p, T,
                     time: float = 0.0, step_number: int = 0) -> State:
    """State on the model's device and dtype from numpy arrays: u
    (3, *cells), three cell-shaped left-face arrays, p and T (*cells)."""
    t = model._tensor
    return State(u=t(np.asarray(u)),
                 u_faces=tuple(t(np.asarray(f)) for f in u_faces),
                 p=t(np.asarray(p)), T=t(np.asarray(T)),
                 time=float(time), step_number=int(step_number))


def state_to_numpy(state: State) -> Tuple:
    """(u, (uf0, uf1, uf2), p, T, time, step_number) as numpy/host."""
    h = lambda x: x.detach().cpu().numpy()
    return (h(state.u), tuple(h(f) for f in state.u_faces), h(state.p),
            h(state.T), float(state.time), int(state.step_number))
