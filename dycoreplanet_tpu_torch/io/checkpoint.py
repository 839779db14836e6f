"""Checkpoint and restore of the model state (counterpart of the JAX
package's ``io/checkpoint.py``; the reference has no checkpoints).

The format is the JAX package's, so that a checkpoint written by either
package loads in the other: one ``.npz`` with the keys ``u``, ``p``,
``T``, ``time`` (0-d, the model's dtype), ``step_number`` (0-d int32)
and ``u_face_{d}``, beside a ``.npz.json`` holding the caller's metadata
and ``n_face_arrays``. A bfloat16 array is written as the JAX package's
``np.savez`` writes an ml_dtypes bfloat16 array, 2-byte voids
(``'<V2'``) holding its bits, and read back bit for bit. Beside
bfloat16 fields ``time`` is float32, as the model keeps it, where the
JAX package writes its bfloat16 time: a restart resumes at the saved
time exactly (a bfloat16 ``time`` from a JAX checkpoint is read too).
The sharded form writes one ``.npz`` per shard and a master ``.json`` with
the global shapes, dtypes and each shard's index ranges; on a mesh that
spans processes each rank writes its own shards and reads back its own
blocks. Fields reach the host in one device-to-host copy (per
shard on a mesh); a restore is bitwise.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.models.boussinesq import State
from dycoreplanet_tpu_torch.parallel.mesh import (
    build, is_sharded, local_shape)


def _host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors on the host in one device-to-host copy: their raveled
    values cast to the widest float dtype among them, concatenated
    (bfloat16 tensors as their bits, ``'<V2'``)."""
    wide = tensors[0].dtype
    for t in tensors[1:]:
        wide = torch.promote_types(wide, t.dtype)
    flat = torch.cat([t.reshape(-1).to(wide) for t in tensors])
    flat = (dtypes.bf16_bits(flat) if wide == torch.bfloat16
            else flat.cpu().numpy())
    out, off = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[off:off + n].reshape(tuple(t.shape))
        if wide != torch.bfloat16:
            a = a.astype(np.dtype(str(t.dtype).replace("torch.", "")))
        out.append(a)
        off += n
    return out


def _scalars(state: State, like: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``time`` at the dtype of the field ``like`` (float32 beside
    bfloat16 fields, the model's time) and ``step_number`` as int32,
    0-d."""
    step = np.asarray(state.step_number, dtype=np.int32)
    if dtypes.is_bf16_array(like):
        return np.asarray(state.time, dtype=np.float32), step
    return np.asarray(state.time, dtype=like.dtype), step


def _arrays(state: State, host: Sequence[np.ndarray]) -> dict:
    """The checkpoint's arrays by key from the host copies of u, p, T and
    the faces (in that order)."""
    u, p, T, *faces = host
    time, step = _scalars(state, u)
    arrays = {"u": u, "p": p, "T": T, "time": time, "step_number": step}
    for d, uf in enumerate(faces):
        arrays[f"u_face_{d}"] = uf
    return arrays


def _fields(state: State):
    return [state.u, state.p, state.T, *state.u_faces]


def _state(arrays: dict, n_faces: int, device) -> State:
    t = lambda a: dtypes.tensor_from_numpy(a, device=device)  # noqa: E731
    return State(u=t(arrays["u"]),
                 u_faces=tuple(t(arrays[f"u_face_{d}"])
                               for d in range(n_faces)),
                 p=t(arrays["p"]), T=t(arrays["T"]),
                 time=float(t(arrays["time"]).double()),
                 step_number=int(arrays["step_number"]))


def save_checkpoint(path: str, state: State,
                    metadata: Optional[dict] = None) -> str:
    """Write ``state`` to ``path`` (.npz) with sidecar .json metadata."""
    if is_sharded(state):
        raise ValueError("a sharded state: use save_checkpoint_sharded")
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_arrays(state, _host(_fields(state))))
    meta = dict(metadata or {})
    meta["n_face_arrays"] = len(state.u_faces)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, device) -> Tuple[State, dict]:
    """Read a checkpoint written by either package's save_checkpoint: a
    State on ``device`` (``time`` a float, ``step_number`` an int) and
    the metadata."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path) as data:
        state = _state(data, meta["n_face_arrays"], device)
    return state, meta


_NAMES = ["u", "p", "T", "time", "step_number"]


def _dtype_name(a: np.ndarray) -> str:
    """An array's dtype as the JAX package's master .json names it."""
    return "bfloat16" if dtypes.is_bf16_array(a) else str(a.dtype)


def _np_dtype(name: str) -> np.dtype:
    """The host dtype of a master .json's dtype name (bfloat16: its
    bits, 2-byte voids)."""
    return np.dtype("<V2") if name == "bfloat16" else np.dtype(name)


def save_checkpoint_sharded(path: str, state: State,
                            metadata: Optional[dict] = None) -> str:
    """Distributed checkpoint of a sharded state (parallel/mesh.py): one
    ``{path}.shard{k:03d}.npz`` per shard holding that shard's blocks,
    copied to the host in one copy a shard, and a master ``{path}.json``
    with the global shapes, dtypes and index ranges — the JAX package's
    layout, shard k being (k // B, k % B) of the A x B mesh. The global
    array is never gathered. On a mesh that spans processes each rank
    writes its own shards under their global k, rank 0 the master, and
    every rank returns once all have written."""
    if not is_sharded(state):
        raise ValueError("save_checkpoint_sharded needs a sharded state")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n_faces = len(state.u_faces)
    names = _NAMES + [f"u_face_{d}" for d in range(n_faces)]
    A, B = state.p.grid
    blocks = None
    for (a, b), _ in state.p.items():
        blocks = _arrays(state, _host([x[a, b] for x in _fields(state)]))
        np.savez(f"{path}.shard{a * B + b:03d}.npz", **blocks)
    group = state.p.group
    if group is None or torch.distributed.get_rank(group) == 0:
        index_meta = {n: [] for n in names}
        shapes = {}
        for k in range(A * B):
            a, b = divmod(k, B)
            for name in names:
                shape = blocks[name].shape
                rng = [[0, n] for n in shape]
                if len(shape) >= 2:
                    nl, no = shape[-2:]
                    rng[-2] = [a * nl, (a + 1) * nl]
                    rng[-1] = [b * no, (b + 1) * no]
                    shapes[name] = list(shape[:-2]) + [A * nl, B * no]
                else:
                    shapes[name] = list(shape)
                index_meta[name].append(rng)
        meta = dict(metadata or {})
        meta["n_face_arrays"] = n_faces
        meta["n_shards"] = A * B
        meta["global_shapes"] = {n: shapes[n] for n in names}
        meta["dtypes"] = {n: _dtype_name(blocks[n]) for n in names}
        meta["shard_indices"] = index_meta
        with open(path + ".json", "w") as f:
            json.dump(meta, f)
    if group is not None:
        from dycoreplanet_tpu_torch.parallel.dist import gather_objects
        gather_objects(group, None)      # every rank's files are written
    return path


def _local_blocks(path: str, meta: dict, mesh, geo) -> Tuple[dict, tuple]:
    """{(a, b): {name: block}} of this process's shards of ``mesh``, read
    from the shard files that overlap them (the writer's layout may be
    any), and (time, step_number)."""
    nl, no = local_shape(geo, mesh)[-2:]
    out = {}
    for (a, b) in mesh.local_shards():
        out[a, b] = {n: np.zeros(shape[:-2] + [nl, no],
                                 dtype=_np_dtype(meta["dtypes"][n]))
                     for n, shape in meta["global_shapes"].items()
                     if len(shape) >= 2}
    scalars = None
    for k in range(meta["n_shards"]):
        data = None
        for (a, b), blk in out.items():
            want = ((a * nl, (a + 1) * nl), (b * no, (b + 1) * no))
            for name, dst in blk.items():
                rngs = meta["shard_indices"][name][k]
                cut = [(max(lo, r0), min(hi, r1))
                       for (lo, hi), (r0, r1) in zip(want, rngs[-2:])]
                if any(lo >= hi for lo, hi in cut):
                    continue
                if data is None:
                    data = np.load(f"{path}.shard{k:03d}.npz")
                (j0, j1), (k0, k1) = cut
                (r0, _), (c0, _) = rngs[-2:]
                dst[..., j0 - want[0][0]:j1 - want[0][0],
                    k0 - want[1][0]:k1 - want[1][0]] = \
                    data[name][..., j0 - r0:j1 - r0, k0 - c0:k1 - c0]
        if data is not None:
            if scalars is None:
                scalars = (data["time"], data["step_number"])
            data.close()
    if scalars is None:
        with np.load(f"{path}.shard000.npz") as data:
            scalars = (data["time"], data["step_number"])
    return out, scalars


def load_checkpoint_sharded(path: str, device=None, *, geo=None,
                            mesh=None) -> Tuple[State, dict]:
    """Restore a checkpoint written by either package's
    save_checkpoint_sharded: the global State on ``device``, or, given
    ``mesh`` (and the model's ``geo``), cut onto that mesh, each process
    reading the blocks of its own shards alone; and the metadata."""
    if (device is None) == (mesh is None):
        raise ValueError("load_checkpoint_sharded: pass device or mesh")
    with open(path + ".json") as f:
        meta = json.load(f)
    if mesh is not None:
        if geo is None:
            raise ValueError("load_checkpoint_sharded: a mesh needs the geo")
        blocks, (time, step) = _local_blocks(path, meta, mesh, geo)

        def field(name):
            return build(mesh, lambda a, b: dtypes.tensor_from_numpy(
                blocks[a, b][name], device=mesh.device(a, b)))

        n_faces = meta["n_face_arrays"]
        state = State(u=field("u"), u_faces=tuple(
            field(f"u_face_{d}") for d in range(n_faces)),
            p=field("p"), T=field("T"),
            time=float(dtypes.tensor_from_numpy(time).double()),
            step_number=int(step))
        return state, meta
    arrays = {name: np.zeros(shape, dtype=_np_dtype(meta["dtypes"][name]))
              for name, shape in meta["global_shapes"].items()}
    for k in range(meta["n_shards"]):
        with np.load(f"{path}.shard{k:03d}.npz") as data:
            for name in arrays:
                rngs = meta["shard_indices"][name][k]
                arrays[name][tuple(slice(a, b) for a, b in rngs)] = \
                    data[name]
    return _state(arrays, meta["n_face_arrays"], device), meta
