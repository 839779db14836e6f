"""VTK XML output for structured curvilinear grids (counterpart of the
JAX package's ``io/vtk.py``, whose files these are byte for byte).

The reference writes per-rank .vtu files and a .pvtu master through
deal.II's DataOut (boussinesq_model.tpp:1568-1694). The grids here are
logically structured, so a field is one VTK StructuredGrid (.vts) with
explicit cell-centre points, and a .pvd collection records the time
series. Arrays come from host numpy and are written as Float32 blocks,
base64 encoded with a UInt32 byte-count header (VTK's inline binary
format). The encoder is native: csrc/vtkenc.cpp (the JAX package's
native/src/vtkenc.cpp, its C ABI), built by the host compiler at the
first write (ops/kernel_lib.py ``host_library``); a failed build raises.
``_b64_block_plain`` (``struct`` + ``base64``) is its plain version,
which the tests hold it against byte for byte.
"""

from __future__ import annotations

import base64
import ctypes
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np

from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.grid.geometry import Geometry


def _cell_center_points(geo: Geometry, sl=None) -> np.ndarray:
    """(n_cells, 3) Cartesian coordinates of cell centers; ``sl`` is an
    optional per-axis slice tuple selecting a sub-box (a shard)."""
    cs = [a.centers for a in geo.axes]
    if sl is not None:
        cs = [c[s] for c, s in zip(cs, sl)]
    if geo.kind == "cuboid" and geo.dim == 2:
        z, x = np.meshgrid(*cs, indexing="ij")
        pts = np.stack([x, z, np.zeros_like(x)], axis=-1)
    elif geo.kind == "cuboid":
        z, y, x = np.meshgrid(*cs, indexing="ij")
        pts = np.stack([x, y, z], axis=-1)
    elif geo.kind == "annulus":
        r, phi = np.meshgrid(*cs, indexing="ij")
        pts = np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros_like(r)],
                       axis=-1)
    else:
        r, lat, lon = np.meshgrid(*cs, indexing="ij")
        pts = np.stack(
            [r * np.cos(lat) * np.cos(lon),
             r * np.cos(lat) * np.sin(lon),
             r * np.sin(lat)], axis=-1)
    return pts.reshape(-1, 3)


def _local_to_cartesian_vectors(geo: Geometry, u: np.ndarray,
                                sl=None) -> np.ndarray:
    """Local-frame components (dim, *cells) as Cartesian (n, 3), as the
    reference writes its Cartesian velocity. ``sl``: optional per-axis
    slices when ``u`` is a shard's block."""
    if geo.kind == "cuboid" and geo.dim == 2:
        # components (z, x) -> (x, z, 0)
        v = np.stack([u[1], u[0], np.zeros_like(u[0])], axis=-1)
        return v.reshape(-1, 3)
    if geo.kind == "cuboid":
        # components (z, y, x) -> (x, y, z)
        v = np.stack([u[2], u[1], u[0]], axis=-1)
        return v.reshape(-1, 3)
    if geo.kind == "annulus":
        phi_c = geo.axes[1].centers
        if sl is not None:
            phi_c = phi_c[sl[1]]
        phi = phi_c.reshape(1, -1)
        ur, up = u[0], u[1]
        vx = ur * np.cos(phi) - up * np.sin(phi)
        vy = ur * np.sin(phi) + up * np.cos(phi)
        v = np.stack([vx, vy, np.zeros_like(vx)], axis=-1)
        return v.reshape(-1, 3)
    # shell
    lat = geo.extras["lat_centers"]
    lon = geo.extras["lon_centers"]
    if sl is not None:
        lat = lat[:, sl[1], :]
        lon = lon[:, :, sl[2]]
    ur, ul, up = u[0], u[1], u[2]
    cl, slat = np.cos(lat), np.sin(lat)
    co, so = np.cos(lon), np.sin(lon)
    vx = ur * cl * co - ul * slat * co - up * so
    vy = ur * cl * so - ul * slat * so + up * co
    vz = ur * slat + ul * cl
    shape = u.shape[1:]
    v = np.stack(
        [np.broadcast_to(vx, shape),
         np.broadcast_to(vy, shape),
         np.broadcast_to(vz, shape)], axis=-1)
    return v.reshape(-1, 3)


def _b64_block_plain(data: np.ndarray) -> str:
    """Plain version of ``_b64_block``: ``struct`` and ``base64``."""
    raw = np.ascontiguousarray(data, dtype=np.float32).tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


_ENCODER = []


def _encoder():
    """The native encoder's two entry points, built and bound once."""
    if not _ENCODER:
        from dycoreplanet_tpu_torch.ops import kernel_lib as kl

        lib = kl.host_library("vtkenc.cpp")
        bound, encode = lib.vtk_b64_bound, lib.vtk_encode_block
        bound.restype, bound.argtypes = ctypes.c_size_t, [ctypes.c_size_t]
        encode.restype = ctypes.c_size_t
        encode.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        _ENCODER.extend((bound, encode))
    return _ENCODER


def _b64_block(data: np.ndarray) -> str:
    """One binary DataArray: the float32 bytes behind a UInt32 length,
    base64 encoded by the native encoder."""
    raw = np.ascontiguousarray(data, dtype=np.float32)
    bound, encode = _encoder()
    out = np.empty(bound(raw.nbytes), np.uint8)
    n = encode(raw.ctypes.data, raw.nbytes, out.ctypes.data)
    return out[:n].tobytes().decode("ascii")


def _extent_str(geo: Geometry, sl=None) -> str:
    """VTK extent string (axis i of the array = VTK extent axis i; the
    fastest-varying VTK axis maps to our axis 0 via the transposes
    below). ``sl``: per-axis slices for a piece, else the whole grid."""
    shape = geo.cell_shape
    parts = []
    for d in range(geo.dim):
        if sl is None:
            a, b = 0, shape[d] - 1
        else:
            a = sl[d].start or 0
            b = (sl[d].stop if sl[d].stop is not None else shape[d]) - 1
        parts.append(f"{a} {b}")
    while len(parts) < 3:
        parts.append("0 0")
    return " ".join(parts)


def write_vts(
    path: str,
    geo: Geometry,
    scalars: Optional[Dict[str, np.ndarray]] = None,
    vectors: Optional[Dict[str, np.ndarray]] = None,
    sl=None,
) -> str:
    """Write one .vts file. ``scalars[name]``: (*cells,); ``vectors[name]``:
    (dim, *cells) local-frame components (converted to Cartesian).
    ``sl``: optional per-axis slice tuple — writes a PIECE of the global
    grid (shard-local arrays, global extents) for .pvts assembly."""
    scalars = scalars or {}
    vectors = vectors or {}
    whole = _extent_str(geo, None)
    extent = _extent_str(geo, sl)
    shape = (geo.cell_shape if sl is None else
             tuple(len(range(*s.indices(n)))
                   for s, n in zip(sl, geo.cell_shape)))
    # VTK structured grids index fastest over the FIRST extent axis; our
    # arrays are C-ordered (last axis fastest), hence the transposes
    axes = tuple(reversed(range(geo.dim))) + (geo.dim,)
    pts = _cell_center_points(geo, sl).reshape(shape + (3,))
    pts_vtk = np.ascontiguousarray(np.transpose(pts, axes))

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="StructuredGrid" version="1.0" byte_order="LittleEndian" header_type="UInt32">',
        f'  <StructuredGrid WholeExtent="{whole}">',
        f'    <Piece Extent="{extent}">',
        "      <Points>",
        '        <DataArray type="Float32" NumberOfComponents="3" format="binary">',
        "          " + _b64_block(pts_vtk.reshape(-1, 3)),
        "        </DataArray>",
        "      </Points>",
        "      <PointData>",
    ]
    for name, arr in scalars.items():
        a = np.ascontiguousarray(np.transpose(np.asarray(arr)))
        lines += [
            f'        <DataArray type="Float32" Name="{name}" format="binary">',
            "          " + _b64_block(a.reshape(-1)),
            "        </DataArray>",
        ]
    for name, arr in vectors.items():
        v = _local_to_cartesian_vectors(
            geo, np.asarray(arr), sl).reshape(shape + (3,))
        v_vtk = np.ascontiguousarray(np.transpose(v, axes))
        lines += [
            f'        <DataArray type="Float32" Name="{name}" NumberOfComponents="3" format="binary">',
            "          " + _b64_block(v_vtk.reshape(-1, 3)),
            "        </DataArray>",
        ]
    lines += [
        "      </PointData>",
        "    </Piece>",
        "  </StructuredGrid>",
        "</VTKFile>",
    ]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def _shard_slices(geo: Geometry, grid, a: int, b: int):
    """The global cell slices of shard (a, b) of the geometry's mesh as an
    A x B grid (``grid``; parallel/mesh.py): rows of axis -2, columns of
    axis -1; the vertical axis is never cut (on a one-axis mesh, A = 1,
    it is axis -2)."""
    A, B = grid
    nl, no = geo.cell_shape[-2] // A, geo.cell_shape[-1] // B
    cols = slice(b * no, (b + 1) * no)
    if geo.dim == 2:
        return (slice(None), cols)
    return (slice(None), slice(a * nl, (a + 1) * nl), cols)


def write_vts_sharded(
    basepath: str,
    geo: Geometry,
    scalars: Optional[Dict] = None,
    vectors: Optional[Dict] = None,
) -> str:
    """Distributed output: one .vts PIECE per shard of the ``Sharded``
    fields (parallel/mesh.py), each written from that shard's own
    tensors, plus a .pvts master referencing them — the reference's
    per-rank .vtu + rank-0 .pvtu (boussinesq_model.tpp:1661-1691); the
    global field is never gathered. Piece k is shard (k // B, k % B) of
    the A x B grid of the mesh (1 x B on the annulus and the slab), the
    shard that the JAX package's ``addressable_shards[k]`` holds on a mesh
    of that shape. On a mesh that spans processes each rank writes its
    own pieces under their global k and rank 0 the .pvts, once every rank
    has written (the JAX package's per-process output). Returns the .pvts
    path."""
    scalars = scalars or {}
    vectors = vectors or {}
    ref = next(iter(scalars.values()), None)
    if ref is None:
        ref = next(iter(vectors.values()))
    host = dtypes.to_numpy
    base, _ = os.path.splitext(basepath)
    A, B = ref.grid
    for (a, b), _ in ref.items():
        write_vts(f"{base}.p{a * B + b:03d}.vts", geo,
                  scalars={n: host(x[a, b]) for n, x in scalars.items()},
                  vectors={n: host(x[a, b]) for n, x in vectors.items()},
                  sl=_shard_slices(geo, ref.grid, a, b))
    pieces = [(os.path.basename(f"{base}.p{k:03d}.vts"),
               _extent_str(geo, _shard_slices(geo, ref.grid, *divmod(k, B))))
              for k in range(A * B)]
    pvts_path = base + ".pvts"
    if ref.group is not None:
        import torch.distributed as tdist

        from dycoreplanet_tpu_torch.parallel.dist import gather_objects
        gather_objects(ref.group, None)     # every rank's pieces written
        if tdist.get_rank(ref.group) != 0:
            return pvts_path

    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="PStructuredGrid" version="1.0" byte_order="LittleEndian">',
        f'  <PStructuredGrid WholeExtent="{_extent_str(geo)}" GhostLevel="0">',
        "    <PPoints>",
        '      <PDataArray type="Float32" NumberOfComponents="3"/>',
        "    </PPoints>",
        "    <PPointData>",
    ]
    for name in scalars:
        lines.append(f'      <PDataArray type="Float32" Name="{name}"/>')
    for name in vectors:
        lines.append(
            f'      <PDataArray type="Float32" Name="{name}" NumberOfComponents="3"/>')
    lines.append("    </PPointData>")
    for fname, ext in pieces:
        lines.append(f'    <Piece Extent="{ext}" Source="{fname}"/>')
    lines += ["  </PStructuredGrid>", "</VTKFile>"]
    os.makedirs(os.path.dirname(pvts_path) or ".", exist_ok=True)
    with open(pvts_path, "w") as f:
        f.write("\n".join(lines))
    return pvts_path


def write_pvd(path: str, entries: Sequence[Dict]) -> str:
    """Time-series collection (stands in for the reference's .pvtu +
    .visit masters). ``entries``: [{"time": t, "file": relpath}, ...]."""
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="Collection" version="1.0" byte_order="LittleEndian">',
        "  <Collection>",
    ]
    for e in entries:
        lines.append(
            f'    <DataSet timestep="{e["time"]}" group="" part="0" file="{e["file"]}"/>'
        )
    lines += ["  </Collection>", "</VTKFile>"]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path


def write_mesh_vts(path: str, geo: Geometry,
                   shard_map_shape: Optional[Sequence[int]] = None) -> str:
    """Mesh dump — the reference's PlanetGeometry::write_mesh_vtu
    (planet_geometry.tpp:124-167), written before any solve. Cell data:
    volumes, diameters, and the shard ("rank") each cell belongs to for
    a given domain-decomposition shape."""
    vol = np.broadcast_to(np.asarray(geo.vol), geo.cell_shape)
    diam = np.broadcast_to(np.asarray(geo.cell_diameter()), geo.cell_shape)
    scalars = {"volume": vol, "diameter": diam}
    if shard_map_shape is not None:
        rank = np.zeros(geo.cell_shape)
        for d, parts in enumerate(shard_map_shape):
            idx = (np.arange(geo.cell_shape[d]) * parts) // geo.cell_shape[d]
            shape1 = [1] * geo.dim
            shape1[d] = -1
            rank = rank * parts + idx.reshape(shape1)
        scalars["shard"] = rank
    return write_vts(path, geo, scalars=scalars)
