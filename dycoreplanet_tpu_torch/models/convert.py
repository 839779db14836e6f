"""Carry a model state across the host boundary as numpy arrays — the
way the tests hand a state of the JAX package to the port and back, in
any geometry (the shell, the annulus, the 3D cuboid and the 2D slab:
dim velocity components and dim face arrays). A JAX state, global or
sharded, reads as global numpy arrays; the port's sharded states are
cut onto the model's mesh and gathered back here."""

from __future__ import annotations

from typing import Sequence, Tuple

from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.models.boussinesq import BoussinesqModel, State
from dycoreplanet_tpu_torch.parallel.mesh import (
    is_sharded, shard_state, unshard_state)


def state_from_numpy(model: BoussinesqModel, u, u_faces: Sequence, p, T,
                     time: float = 0.0, step_number: int = 0) -> State:
    """State on the model's device and dtype from numpy arrays: u
    (dim, *cells), dim cell-shaped left-face arrays, p and T (*cells);
    bfloat16 arrays (the JAX package's) are taken bit for bit."""
    t = lambda a: dtypes.tensor_from_numpy(  # noqa: E731
        a, model.torch_dtype, model.device)
    return State(u=t(u), u_faces=tuple(t(f) for f in u_faces),
                 p=t(p), T=t(T),
                 time=float(time), step_number=int(step_number))


def sharded_state_from_numpy(model: BoussinesqModel, u, u_faces: Sequence,
                             p, T, time: float = 0.0,
                             step_number: int = 0) -> State:
    """state_from_numpy cut onto the model's mesh (prepare_sharded)."""
    if model._mesh is None:
        raise ValueError("sharded_state_from_numpy: call prepare_sharded "
                         "first")
    return shard_state(state_from_numpy(model, u, u_faces, p, T, time,
                                        step_number), model.geo,
                       model._mesh.mesh)


def state_to_numpy(state: State) -> Tuple:
    """(u, (uf0, ..., uf_{dim-1}), p, T, time, step_number) as
    numpy/host, global arrays (a sharded state is gathered; bfloat16
    fields widened to float32)."""
    if is_sharded(state):
        state = unshard_state(state, "cpu")
    h = dtypes.to_numpy
    return (h(state.u), tuple(h(f) for f in state.u_faces), h(state.p),
            h(state.T), float(state.time), int(state.step_number))
