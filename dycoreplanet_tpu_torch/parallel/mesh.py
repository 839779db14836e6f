"""Device mesh and sharded fields: the horizontal domain decomposition of
every geometry (counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package is single-controller: one Python process drives every
device of its ``jax.sharding.Mesh``. The port keeps that design. A
:class:`Mesh` is an array of shards, each with the device it lives on;
devices may repeat, so a mesh of 2 x 4 shards can run on one card (or,
in the tests, on the CPU) with every halo rule of the multi-card case.
A :class:`Sharded` field holds one tensor per shard, the shard's block
of a global array. The vertical axis (r or z) is never sharded. The
layouts are the JAX package's (``mesh_axes``):

  shell   (r, lat, lon): mesh ("lat", "lon"), A x B shards
  cuboid  (z, y, x):     mesh ("y", "x"),     A x B shards
  annulus (r, phi):      mesh ("phi",),       B shards
  slab    (z, x):        mesh ("x",),         B shards

Every layout is indexed as an A x B grid (``Mesh.grid``), a one-axis
mesh as 1 x B: shard (a, b) holds rows a * nl .. (a + 1) * nl of the
cell arrays' axis -2 and columns b * no .. (b + 1) * no of axis -1, so
``Sharded[a, b]``, ``build`` and every halo and cut below serve all four.
On a one-axis mesh axis -2 is the vertical axis, which the one row of
shards holds whole and nothing pads. ``Mesh.rows`` is the rule of axis
-2: "pole" (the shell's lat, closed at the poles), "periodic" (the box's
y) or None (a one-axis mesh); axis -1 is periodic in every geometry.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Axis, Geometry

# the rule of axis -2 on a two-axis mesh, by the mesh's first axis name
_ROWS = {"lat": "pole", "y": "periodic"}


def mesh_axes(geo: Geometry) -> Tuple[str, ...]:
    """The mesh axis names of a geometry's layout (the JAX package's
    ``build_mesh``)."""
    if geo.kind == "annulus":
        return ("phi",)
    if geo.kind == "cuboid" and geo.dim == 2:
        return ("x",)
    return ("y", "x") if geo.kind == "cuboid" else ("lat", "lon")


def row_rule(geo: Geometry) -> Optional[str]:
    """The rule of the cell arrays' axis -2 in the geometry's layout."""
    names = mesh_axes(geo)
    return _ROWS[names[0]] if len(names) == 2 else None


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
        if arr.ndim not in (1, 2) or (arr.ndim == 2
                                      and axis_names[0] not in _ROWS):
            raise ValueError(f"a mesh has the axes of a layout (mesh_axes), "
                             f"not {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self._grid = arr if arr.ndim == 2 else arr.reshape(1, -1)
        # the A x B grid of shards (a one-axis mesh: 1 x B)
        self.grid = self._grid.shape
        self.rows = _ROWS[self.axis_names[0]] if arr.ndim == 2 else None

    def device(self, *idx) -> torch.device:
        """The device of shard (a, b) of the grid (or of the mesh's own
        index)."""
        if len(idx) == 2:
            return self._grid[idx]
        return self.devices[idx]

    def grid_axis(self, name: str) -> int:
        """The grid axis (0: rows, 1: columns) of a mesh axis."""
        return self.axis_names.index(name) + 2 - len(self.axis_names)

    def pads(self, width: int) -> Tuple[int, int]:
        """(row, column) pad widths of a halo of ``width``: no row pad on
        a one-axis mesh, whose axis -2 is the vertical axis."""
        return (width if self.rows else 0, width)

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
    names = mesh_axes(geo)
    if len(names) == 1:
        return Mesh(arr, names)
    return Mesh(arr.reshape(_factor2(n)), names)


def mesh_shape_for(geo: Geometry, n_devices: Optional[int] = None
                   ) -> Tuple[int, ...]:
    """Shard counts per cell-array axis for the canonical layout (the
    vertical axis unsharded)."""
    n = n_devices if n_devices is not None else len(_default_devices())
    if len(mesh_axes(geo)) == 1:
        return (1, n)
    a, b = _factor2(n)
    return (1, a, b)


class Sharded:
    """A field cut over a mesh: ``shards[a][b]`` is the block of row shard
    a and column shard b (``Mesh.grid``), on that shard's device."""

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
    A, B = mesh.grid
    return Sharded([[fn(a, b) for b in range(B)] for a in range(A)])


def local_shape(geo: Geometry, mesh: Mesh) -> Tuple[int, ...]:
    """The cell shape of one shard; raises if the mesh is not the
    geometry's layout or does not divide the grid."""
    if mesh.axis_names != mesh_axes(geo):
        raise ValueError(f"a {geo.kind} mesh has axes {mesh_axes(geo)}, "
                         f"not {mesh.axis_names}")
    shape = list(geo.cell_shape)
    A, B = mesh.grid
    if shape[-2] % A or shape[-1] % B:
        raise ValueError(f"grid {geo.cell_shape} not divisible by mesh "
                         f"({A}, {B})")
    shape[-2] //= A
    shape[-1] //= B
    return tuple(shape)


def offsets(geo: Geometry, mesh: Mesh) -> dict:
    """{(a, b): (j0, k0)}: where each shard's block starts along axes -2
    and -1 of the cell arrays."""
    nl, no = local_shape(geo, mesh)[-2:]
    A, B = mesh.grid
    return {(a, b): (a * nl, b * no) for a in range(A) for b in range(B)}


def shard_field(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """Cut a global (..., n1, n2) cell array into the mesh's blocks of
    axes -2 and -1, each a contiguous copy on its shard's device."""
    A, B = mesh.grid
    nl, no = x.shape[-2] // A, x.shape[-1] // B
    return build(mesh, lambda a, b: x[..., a * nl:(a + 1) * nl,
                                      b * no:(b + 1) * no]
                 .to(mesh.device(a, b)).contiguous())


def unshard_field(x: Sharded, device=None) -> torch.Tensor:
    """The global array of a Sharded field, on ``device`` (default: shard
    (0, 0)'s): its blocks joined along axes -1 and -2."""
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
def _index(n: int, start: int, count: int, pad: int, rule) -> np.ndarray:
    """The global indices start - pad .. start + count + pad of an axis of
    n cells: clipped at the poles ("pole"), wrapped ("periodic"); an
    axis that is not cut (None) is the whole axis, unpadded."""
    if rule is None:
        return np.arange(n)
    idx = np.arange(start - pad, start + count + pad)
    return np.clip(idx, 0, n - 1) if rule == "pole" else idx % n


def shard_geometry(geo: Geometry, j0: int, nl: int, k0: int, no: int,
                   pad: int = 0) -> Geometry:
    """The geometry of one shard's cells, rows j0..j0+nl of axis -2 and
    columns k0..k0+no of axis -1 (``offsets``), extended by ``pad`` cells
    on both sides of every sharded axis. Every metric is the global one
    at the same cell or face. On the shell, rows and faces beyond a pole
    repeat the pole's (whose face has zero area, so that nothing crosses
    it); a periodic axis wraps (the shell's lon, the box's y and x, the
    annulus's phi, the slab's x). The port's plain stencils then run on a
    padded block unchanged: their ghost rules and wraps touch only the
    pad, which the caller crops. On a one-axis layout (the annulus, the
    slab) axis -2 is the vertical axis, whole and unpadded."""
    rule = row_rule(geo)
    n1, n2 = geo.cell_shape[-2:]
    cells = faces = None
    if rule is not None:
        cells = _index(n1, j0, nl, pad, rule)
        faces = (np.clip(np.arange(j0 - pad, j0 + nl + pad + 1), 0, n1)
                 if rule == "pole" else cells)
    return _cut_geometry(geo, cells, faces, _index(n2, k0, no, pad,
                                                   "periodic"))


def window_geometry(geo: Geometry, rows, cols) -> Geometry:
    """The geometry of a window of the global grid: the rows ``rows`` of
    axis -2 (global indices; on the shell a range inside the grid, no row
    past a pole; taken modulo on the box; ignored on a one-axis layout,
    whose window holds the whole vertical axis) and the columns ``cols``
    of axis -1 (global indices, any order, taken modulo), as
    :func:`halo.window` gathers a field. A shell window that holds a pole
    and, after its own columns, the columns at lon + pi (each the same
    distance from the window's middle) closes the pole as the whole ring
    does: the stencils' half-turn roll of the window's columns reaches
    lon + pi."""
    rule = row_rule(geo)
    n1, n2 = geo.cell_shape[-2:]
    cells = faces = None
    if rule == "pole":
        cells = np.arange(rows.start, rows.stop)
        faces = np.arange(rows.start, rows.stop + 1)
    elif rule == "periodic":
        cells = faces = np.asarray(rows) % n1
    return _cut_geometry(geo, cells, faces, np.asarray(cols) % n2)


def _cut_geometry(geo: Geometry, cells, faces, cols: np.ndarray
                  ) -> Geometry:
    """The metric at the global cells ``cells`` of axis -2 (their faces
    ``faces``; None: the axis whole) and columns ``cols`` of axis -1. A
    broadcast-shaped array is cut along the axes it spans."""
    n1, n2 = geo.cell_shape[-2:]

    def cut(a):
        a = np.asarray(a)
        if a.ndim != geo.dim:
            return a
        if cells is not None and a.shape[-2] == n1 + 1 and \
                not geo.axes[-2].periodic:
            a = a[..., faces, :]
        elif cells is not None and a.shape[-2] == n1:
            a = a[..., cells, :]
        if a.shape[-1] == n2:
            a = a[..., cols]
        return np.ascontiguousarray(a)

    def axis(ax, idx, face_idx):
        return Axis(ax.name, len(idx), ax.periodic,
                    np.asarray(ax.centers)[idx],
                    np.asarray(ax.faces)[face_idx])

    axes = list(geo.axes)
    axes[-1] = axis(axes[-1], cols, cols)
    if cells is not None:
        axes[-2] = axis(axes[-2], cells, faces)
    extras = {k: cut(v) for k, v in geo.extras.items()
              if not k.startswith("_")}
    return Geometry(kind=geo.kind, axes=tuple(axes), vol=cut(geo.vol),
                    face_area=tuple(cut(a) for a in geo.face_area),
                    face_dist=tuple(cut(a) for a in geo.face_dist),
                    extras=extras)


def block(a: np.ndarray, j0: int, nl: int, k0: int, no: int,
          pad: int = 0, rows: Optional[str] = "pole") -> np.ndarray:
    """Rows j0 - pad .. j0 + nl + pad and columns k0 - pad .. k0 + no +
    pad (periodic) of a (..., n1, n2) array, as shard_geometry cuts the
    metric; ``rows`` is the rule of axis -2 (``Mesh.rows``: clipped at
    the poles, periodic, or None: the whole axis, unpadded). An axis of
    one entry (a broadcast) is kept; a 1-D array (a 2D grid's wall
    values) is cut along its columns."""
    a = np.asarray(a)
    n1, n2 = a.shape[-2] if a.ndim > 1 else 1, a.shape[-1]
    if n1 > 1:
        a = a[..., _index(n1, j0, nl, pad, rows), :]
    if n2 > 1:
        a = a[..., _index(n2, k0, no, pad, "periodic")]
    return np.ascontiguousarray(a)


def crop(x: torch.Tensor, pad: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """The owned block of a (..., n1, n2) array padded by ``pad`` (an int,
    or the (row, column) pads of ``Mesh.pads``)."""
    pr, pc = (pad, pad) if isinstance(pad, int) else pad
    if pr == pc == 0:
        return x
    return x[..., pr:x.shape[-2] - pr, pc:x.shape[-1] - pc]
