"""Device mesh and sharded fields: the horizontal domain decomposition of
every geometry (counterpart of the JAX package's ``parallel/mesh.py``).

A :class:`Mesh` is an A x B array of shards, each with the device it
lives on, in one of two forms:

  * one process (``group=None``, the JAX package's single controller):
    the process holds every shard; devices may repeat, so a mesh of 2 x
    4 shards can run on one card (or, in the tests, on the CPU) with
    every halo rule of the multi-card case;
  * W processes (``group``: a ``torch.distributed`` group,
    parallel/dist.py; one process a card by default): the shards are
    dealt over the ranks in shard order (a major, b minor), a block of
    A * B / W to each, and each rank holds only its own. ``owner(a,
    b)`` names the rank of a shard, ``is_local`` whether this process
    holds it; the devices of other ranks' shards are not known here.

A :class:`Sharded` field holds one tensor per shard that this process
holds (every shard on one process), the shard's block of a global array;
``items`` and ``map`` walk those, and indexing a shard of another rank
raises. Every shard has the same shape (``local_shape``). The vertical
axis (r or z) is never sharded. The layouts are the JAX package's
(``mesh_axes``):

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
A field crosses between the forms whole: ``shard_field`` cuts this
process's blocks of a global array, ``unshard_field`` gathers every
block in shard order (a collective on a process mesh).
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
    does. With a ``group`` the shards are dealt over its ranks in shard
    order, a block of A * B / W each (module docstring); ``devices``
    then gives the devices of this rank's shards at their places (the
    other entries are not read)."""

    def __init__(self, devices, axis_names: Sequence[str], group=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes "
                             f"{tuple(axis_names)}")
        if arr.ndim not in (1, 2) or (arr.ndim == 2
                                      and axis_names[0] not in _ROWS):
            raise ValueError(f"a mesh has the axes of a layout (mesh_axes), "
                             f"not {tuple(axis_names)}")
        self.group = group
        if group is None:
            self.world, self.rank = 1, 0
        else:
            import torch.distributed as dist
            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        if arr.size % self.world:
            raise ValueError(f"{arr.size} shards cannot be dealt over "
                             f"{self.world} ranks")
        self._per = arr.size // self.world
        for k, idx in enumerate(np.ndindex(arr.shape)):
            if k // self._per == self.rank:
                arr[idx] = torch.device(src[idx])
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self._grid = arr if arr.ndim == 2 else arr.reshape(1, -1)
        # the A x B grid of shards (a one-axis mesh: 1 x B)
        self.grid = self._grid.shape
        self.rows = _ROWS[self.axis_names[0]] if arr.ndim == 2 else None

    def owner(self, a: int, b: int) -> int:
        """The rank that holds shard (a, b) of the grid."""
        return (a * self.grid[1] + b) // self._per

    def is_local(self, a: int, b: int) -> bool:
        """Whether this process holds shard (a, b) of the grid."""
        return self.owner(a, b) == self.rank

    def local_shards(self) -> List[Tuple[int, int]]:
        """The (a, b) of this process's shards, in shard order."""
        A, B = self.grid
        return [(a, b) for a in range(A) for b in range(B)
                if self.is_local(a, b)]

    def device(self, *idx) -> torch.device:
        """The device of shard (a, b) of the grid (or of the mesh's own
        index); raises for a shard of another rank."""
        d = self._grid[idx] if len(idx) == 2 else self.devices[idx]
        if d is None:
            raise LookupError(f"shard {idx} lies on rank "
                              f"{self.owner(*idx) if len(idx) == 2 else '?'}"
                              f", not on rank {self.rank}")
        return d

    @property
    def own_device(self) -> torch.device:
        """The device of this process's first shard: where the replicated
        results of the mesh's sums are read (the mesh's first device on
        one process)."""
        return self.device(*self.local_shards()[0])

    def grid_axis(self, name: str) -> int:
        """The grid axis (0: rows, 1: columns) of a mesh axis."""
        return self.axis_names.index(name) + 2 - len(self.axis_names)

    def pads(self, width: int) -> Tuple[int, int]:
        """(row, column) pad widths of a halo of ``width``: no row pad on
        a one-axis mesh, whose axis -2 is the vertical axis."""
        return (width if self.rows else 0, width)

    def distinct_devices(self) -> List[torch.device]:
        """This process's devices, each once, in shard order."""
        out = []
        for ab in self.local_shards():
            d = self._grid[ab]
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


def build_mesh(geo: Geometry, devices: Optional[Sequence] = None,
               group=None) -> Mesh:
    """A mesh shaped for the geometry's horizontal axes (the JAX
    function's shapes and names). One process: ``devices`` are the
    shards' (default: every CUDA card). With a ``group`` (parallel/
    dist.py): ``devices`` are this rank's shards' (default: its current
    card, one shard), every rank gives as many, and the mesh holds
    W times that many shards, this rank's block in rank order."""
    if group is None:
        devices = list(devices if devices is not None
                       else _default_devices())
        n, mine = len(devices), 0
    else:
        import torch.distributed as dist

        from dycoreplanet_tpu_torch.parallel.dist import gather_objects
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("build_mesh: CUDA is not available on "
                                   "this rank; pass its devices")
            devices = [torch.device("cuda", torch.cuda.current_device())]
        devices = list(devices)
        counts = gather_objects(group, len(devices))
        if len(set(counts)) != 1:
            raise ValueError(f"build_mesh: the ranks give {counts} shards")
        mine = dist.get_rank(group) * len(devices)
        n = len(devices) * len(counts)
    arr = np.empty(n, dtype=object)
    arr[:] = "cpu"
    arr[mine:mine + len(devices)] = devices
    names = mesh_axes(geo)
    if len(names) == 1:
        return Mesh(arr, names, group)
    return Mesh(arr.reshape(_factor2(n)), names, group)


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
    a and column shard b (``Mesh.grid``), on that shard's device, or None
    for a shard another rank holds (``group``: the mesh's process group,
    None on one process)."""

    def __init__(self, shards: List[List[Optional[torch.Tensor]]],
                 group=None):
        self.shards = shards
        self.group = group

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.shards), len(self.shards[0])

    def __getitem__(self, ab) -> torch.Tensor:
        t = self.shards[ab[0]][ab[1]]
        if t is None:
            raise LookupError(f"shard {tuple(ab)} is held by another "
                              "process")
        return t

    def items(self):
        """((a, b), tensor) of this process's shards in shard order: a
        major, b minor."""
        for a, row in enumerate(self.shards):
            for b, t in enumerate(row):
                if t is not None:
                    yield (a, b), t

    def local(self) -> torch.Tensor:
        """This process's first shard (every shard has its shape)."""
        return next(self.items())[1]

    def parts(self) -> List[torch.Tensor]:
        """This process's shards in shard order."""
        return [t for _, t in self.items()]

    def with_parts(self, parts: Sequence[torch.Tensor]) -> "Sharded":
        """A field of this one's layout holding ``parts`` (as ``parts()``
        lists them)."""
        it = iter(parts)
        return Sharded([[None if t is None else next(it) for t in row]
                        for row in self.shards], self.group)

    def numel(self) -> int:
        """The element count of the global field."""
        A, B = self.grid
        return self.local().numel() * A * B

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """fn(shard, *other shards) on every shard of this process."""
        return Sharded([[None if t is None else
                         fn(t, *(o.shards[a][b] for o in others))
                         for b, t in enumerate(row)]
                        for a, row in enumerate(self.shards)], self.group)

    # the elementwise arithmetic of the Krylov loops (solvers/cg.py,
    # solvers/fixed.py): with another Sharded shard by shard; with a
    # number; with a 0-d tensor (a loop's scalar, on the model's device),
    # copied once to each other device a shard lies on
    @property
    def dtype(self) -> torch.dtype:
        return self.local().dtype

    @property
    def device(self) -> torch.device:
        """This process's first shard's device."""
        return self.local().device
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
    """A Sharded field of fn(a, b) for every shard of this process."""
    A, B = mesh.grid
    return Sharded([[fn(a, b) if mesh.is_local(a, b) else None
                     for b in range(B)] for a in range(A)], mesh.group)


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


def local_offsets(geo: Geometry, mesh: Mesh) -> dict:
    """``offsets`` of this process's shards alone: where the per-shard
    tables are built."""
    return {ab: at for ab, at in offsets(geo, mesh).items()
            if mesh.is_local(*ab)}


def shard_field(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """Cut a global (..., n1, n2) cell array into this process's blocks
    of axes -2 and -1, each a contiguous copy on its shard's device."""
    A, B = mesh.grid
    nl, no = x.shape[-2] // A, x.shape[-1] // B
    return build(mesh, lambda a, b: x[..., a * nl:(a + 1) * nl,
                                      b * no:(b + 1) * no]
                 .to(mesh.device(a, b)).contiguous())


def unshard_field(x: Sharded, device=None) -> torch.Tensor:
    """The global array of a Sharded field, on ``device`` (default: this
    process's first shard's): its blocks joined along axes -1 and -2. On
    a process mesh every rank calls it: the blocks are all-gathered in
    shard order, and every rank gets the whole array."""
    dev = x.device if device is None else torch.device(device)
    rows = x.shards
    if x.group is not None:
        from dycoreplanet_tpu_torch.parallel.dist import all_gather
        A, B = x.grid
        # gathered where the shards lie (NCCL takes no host tensor)
        got = all_gather(x.group, torch.stack(x.parts()))
        flat = got.reshape((A * B,) + got.shape[2:])
        rows = [[flat[a * B + b] for b in range(B)] for a in range(A)]
    return torch.cat([torch.cat([t.to(dev) for t in row], dim=-1)
                      for row in rows], dim=-2)


def shard_state(state, geo: Geometry, mesh: Mesh):
    """A State's fields cut onto the mesh (the JAX function's canonical
    layout: the cell-shaped left faces share the cells' partitioning;
    time and step number stay host numbers, replicated); on a process
    mesh this process's blocks alone."""
    local_shape(geo, mesh)
    return state._replace(
        u=shard_field(state.u, mesh),
        u_faces=tuple(shard_field(f, mesh) for f in state.u_faces),
        p=shard_field(state.p, mesh), T=shard_field(state.T, mesh))


def unshard_state(state, device=None):
    """The global State of a sharded one, on ``device`` (default: this
    process's first shard's); a collective on a process mesh."""
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
    :func:`halo.windows` gathers a field. A shell window that holds a pole
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
