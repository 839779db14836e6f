"""Device mesh and sharded fields: the shell's horizontal domain
decomposition (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package is single-controller: one Python process drives every
device of its ``jax.sharding.Mesh``. The port keeps that design. A
:class:`Mesh` is an A x B array of shards, each with the device it lives
on; devices may repeat, so a mesh of 2 x 4 shards can run on one card
(or, in the tests, on the CPU) with every halo rule of the multi-card
case. A :class:`Sharded` field holds one tensor per shard, the shard's
block of a global array. The radial axis is never sharded: cell arrays
``(..., nr, nlat, nlon)`` are cut along lat (mesh axis "lat", A shards)
and lon (mesh axis "lon", B shards).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Axis, Geometry


class Mesh:
    """An array of shards, one device each (repeats allowed), with axis
    names; ``shape`` maps each name to its size, as ``jax.sharding.Mesh``
    does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))

    def device(self, *idx) -> torch.device:
        return self.devices[idx]

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in shard order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b = n."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def _default_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass the mesh's devices (e.g. "
            "['cpu'] * 8) to run the plain PyTorch versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(geo: Geometry, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh shaped for the geometry's horizontal axes (the JAX
    function's shapes and names); ``devices`` defaults to every CUDA
    card."""
    devices = list(devices if devices is not None else _default_devices())
    n = len(devices)
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    if geo.kind == "annulus":
        return Mesh(arr, ("phi",))
    if geo.kind == "cuboid" and geo.dim == 2:
        return Mesh(arr, ("x",))
    a, b = _factor2(n)
    names = ("y", "x") if geo.kind == "cuboid" else ("lat", "lon")
    return Mesh(arr.reshape(a, b), names)


def mesh_shape_for(geo: Geometry, n_devices: Optional[int] = None
                   ) -> Tuple[int, ...]:
    """Shard counts per cell-array axis for the canonical layout (the
    vertical axis unsharded)."""
    n = n_devices if n_devices is not None else len(_default_devices())
    if geo.kind == "annulus" or (geo.kind == "cuboid" and geo.dim == 2):
        return (1, n)
    a, b = _factor2(n)
    return (1, a, b)


class Sharded:
    """A field cut over a ("lat", "lon") mesh: ``shards[a][b]`` is the
    block of lat shard a and lon shard b, on that shard's device."""

    def __init__(self, shards: List[List[torch.Tensor]]):
        self.shards = shards

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.shards), len(self.shards[0])

    def __getitem__(self, ab) -> torch.Tensor:
        return self.shards[ab[0]][ab[1]]

    def items(self):
        """((a, b), tensor) in shard order: a major, b minor."""
        for a, row in enumerate(self.shards):
            for b, t in enumerate(row):
                yield (a, b), t

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """fn(shard, *other shards) on every shard."""
        A, B = self.grid
        return Sharded([[fn(self.shards[a][b],
                            *(o.shards[a][b] for o in others))
                         for b in range(B)] for a in range(A)])

    # the elementwise arithmetic of the Krylov loops (solvers/cg.py,
    # solvers/fixed.py): with another Sharded shard by shard; with a
    # number; with a 0-d tensor (a loop's scalar, on the model's device),
    # copied once to each other device a shard lies on
    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0][0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device."""
        return self.shards[0][0].device

    def to(self, dtype) -> "Sharded":
        return self.map(lambda t: t.to(dtype))

    def zeros_like(self) -> "Sharded":
        return self.map(torch.zeros_like)

    def _binary(self, other, fn: Callable) -> "Sharded":
        if isinstance(other, Sharded):
            return self.map(fn, other)
        if not torch.is_tensor(other):
            return self.map(lambda t: fn(t, other))
        on = {other.device: other}

        def one(t):
            o = on.get(t.device)
            if o is None:
                o = on[t.device] = other.to(t.device)
            return fn(t, o)

        return self.map(one)

    def __add__(self, other):
        return self._binary(other, torch.add)

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    def __truediv__(self, other):
        return self._binary(other, torch.div)

    def __radd__(self, other):
        return self._binary(other, lambda t, o: o + t)

    def __rsub__(self, other):
        return self._binary(other, lambda t, o: o - t)

    def __rmul__(self, other):
        return self._binary(other, lambda t, o: o * t)

    def __neg__(self):
        return self.map(torch.neg)


def build(mesh: Mesh, fn: Callable[[int, int], torch.Tensor]) -> Sharded:
    """A Sharded field of fn(a, b) for every shard."""
    A, B = mesh.shape["lat"], mesh.shape["lon"]
    return Sharded([[fn(a, b) for b in range(B)] for a in range(A)])


def local_shape(geo: Geometry, mesh: Mesh) -> Tuple[int, int, int]:
    """The cell shape of one shard; raises if the mesh does not divide the
    grid."""
    nr, nlat, nlon = geo.cell_shape
    A, B = mesh.shape["lat"], mesh.shape["lon"]
    if nlat % A or nlon % B:
        raise ValueError(f"grid {geo.cell_shape} not divisible by mesh "
                         f"({A}, {B})")
    return nr, nlat // A, nlon // B


def shard_field(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """Cut a global (..., nr, nlat, nlon) array into the mesh's blocks,
    each a contiguous copy on its shard's device."""
    A, B = mesh.shape["lat"], mesh.shape["lon"]
    nl, no = x.shape[-2] // A, x.shape[-1] // B
    return build(mesh, lambda a, b: x[..., a * nl:(a + 1) * nl,
                                      b * no:(b + 1) * no]
                 .to(mesh.device(a, b)).contiguous())


def unshard_field(x: Sharded, device=None) -> torch.Tensor:
    """The global array of a Sharded field, on ``device`` (default: shard
    (0, 0)'s)."""
    dev = x[0, 0].device if device is None else torch.device(device)
    return torch.cat([torch.cat([t.to(dev) for t in row], dim=-1)
                      for row in x.shards], dim=-2)


def shard_state(state, geo: Geometry, mesh: Mesh):
    """A State's fields cut onto the mesh (the JAX function's canonical
    layout: the cell-shaped left faces share the cells' partitioning;
    time and step number stay host numbers, replicated)."""
    local_shape(geo, mesh)
    return state._replace(
        u=shard_field(state.u, mesh),
        u_faces=tuple(shard_field(f, mesh) for f in state.u_faces),
        p=shard_field(state.p, mesh), T=shard_field(state.T, mesh))


def unshard_state(state, device=None):
    """The global State of a sharded one, on ``device`` (default: shard
    (0, 0)'s)."""
    return state._replace(
        u=unshard_field(state.u, device),
        u_faces=tuple(unshard_field(f, device) for f in state.u_faces),
        p=unshard_field(state.p, device), T=unshard_field(state.T, device))


def is_sharded(state) -> bool:
    return isinstance(state.u, Sharded)


# ----------------------------------------------------------------------
def _lat_index(n: int, rows: np.ndarray) -> np.ndarray:
    return np.clip(rows, 0, n - 1)


def shard_geometry(geo: Geometry, j0: int, nl: int, k0: int, no: int,
                   pad: int = 0) -> Geometry:
    """The geometry of one shard's cells, rows j0..j0+nl and columns
    k0..k0+no of the global shell, extended by ``pad`` cells on both
    sides of lat and lon. Every metric is the global one at the same
    cell or face; rows and faces beyond a pole repeat the pole's (whose
    face has zero area, so that nothing crosses it). The lat axis is a
    wall axis and lon periodic, so the port's plain stencils run on a
    padded block unchanged: their ghost rules and wraps touch only the
    pad, which the caller crops."""
    if geo.kind != "shell":
        raise ValueError("shard_geometry takes the lat-lon shell")
    nr, nlat, nlon = geo.cell_shape
    rows = np.arange(j0 - pad, j0 + nl + pad)
    return _cut_geometry(
        geo, _lat_index(nlat, rows),
        np.clip(np.arange(j0 - pad, j0 + nl + pad + 1), 0, nlat),
        np.arange(k0 - pad, k0 + no + pad) % nlon)


def window_geometry(geo: Geometry, rows: range, cols) -> Geometry:
    """The geometry of a window of the global shell: the lat rows
    ``rows`` (a range inside the grid, no row past a pole) and the lon
    columns ``cols`` (global indices, any order, taken modulo nlon), as
    :func:`window` gathers a field. A window that holds a pole and, after
    its own columns, the columns at lon + pi (each the same distance
    from the window's middle) closes the pole as the whole ring does:
    the stencils' half-turn roll of the window's columns reaches lon +
    pi."""
    if geo.kind != "shell":
        raise ValueError("window_geometry takes the lat-lon shell")
    nlon = geo.cell_shape[2]
    return _cut_geometry(geo, np.arange(rows.start, rows.stop),
                         np.arange(rows.start, rows.stop + 1),
                         np.asarray(cols) % nlon)


def _cut_geometry(geo: Geometry, cells: np.ndarray, faces: np.ndarray,
                  cols: np.ndarray) -> Geometry:
    """The shell's metric at the global lat cells ``cells`` (their faces
    ``faces``) and lon columns ``cols``."""
    nr, nlat, nlon = geo.cell_shape

    def cut(a):
        a = np.asarray(a)
        if a.ndim == 3 and a.shape[1] == nlat + 1:
            a = a[:, faces]
        elif a.ndim == 3 and a.shape[1] == nlat:
            a = a[:, cells]
        if a.ndim == 3 and a.shape[2] == nlon:
            a = a[:, :, cols]
        return np.ascontiguousarray(a)

    ar, alat, alon = geo.axes
    lat_faces = np.asarray(alat.faces)[faces]
    axes = (ar,
            Axis(alat.name, len(cells), False,
                 np.asarray(alat.centers)[cells], lat_faces),
            Axis(alon.name, len(cols), True,
                 np.asarray(alon.centers)[cols],
                 np.asarray(alon.faces)[cols]))
    extras = {k: cut(v) for k, v in geo.extras.items()
              if not k.startswith("_")}
    return Geometry(kind="shell", axes=axes, vol=cut(geo.vol),
                    face_area=tuple(cut(a) for a in geo.face_area),
                    face_dist=tuple(cut(a) for a in geo.face_dist),
                    extras=extras)


def block(a: np.ndarray, j0: int, nl: int, k0: int, no: int,
          pad: int = 0) -> np.ndarray:
    """Rows j0 - pad .. j0 + nl + pad (clipped at the poles) and columns
    k0 - pad .. k0 + no + pad (periodic) of a (..., nlat, nlon) array, as
    shard_geometry cuts the metric."""
    nlat, nlon = a.shape[-2:]
    rows = _lat_index(nlat, np.arange(j0 - pad, j0 + nl + pad))
    cols = np.arange(k0 - pad, k0 + no + pad) % nlon
    return np.ascontiguousarray(np.asarray(a)[..., rows, :][..., cols])


def crop(x: torch.Tensor, pad: int) -> torch.Tensor:
    """The owned block of a (..., lat, lon) array padded by ``pad``."""
    if pad == 0:
        return x
    return x[..., pad:-pad, pad:-pad]
