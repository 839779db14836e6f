"""Halo exchange and reductions over a mesh of shards (counterpart of the
JAX package's ``parallel/halo.py``).

The JAX functions run inside ``shard_map`` and move data with
``lax.ppermute`` and ``lax.psum``. Here one process holds every shard,
so a ppermute is a copy of the edge slab to the neighbour's device
(``Tensor.to``: a peer copy between cards, no copy on one device), and
a psum is a sum of the shards' partials in a fixed order (a major, b
minor), on the first device, copied to each device once: two runs give
the same bits, and no float atomics are used.

On a non-periodic mesh axis the missing neighbour contributes zeros,
as ``ppermute`` does; the pole closure of the shell's lat axis (the
boundary ring at lon + pi) is :func:`half_turn`. Every other sharded
axis (the shell's lon, the box's y and x, the annulus's phi, the slab's
x) is a periodic ring (``row_halo``, ``col_halo``). The rows are the
cell arrays' axis -2 and the columns axis -1 (parallel/mesh.py: a
one-axis mesh has one row of shards and pads no rows). Inside
``comm_analysis.counting`` each move between shards reports itself as
the collective the JAX package compiles it to.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from dycoreplanet_tpu_torch.parallel import comm_analysis as comm
from dycoreplanet_tpu_torch.parallel.mesh import Mesh, Sharded, build


def ring_perms(n: int, periodic: bool) -> Tuple[list, list]:
    """Source->dest pairs for the forward (i -> i+1) and backward
    (i -> i-1) ring shifts along a mesh axis of size n."""
    if periodic:
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [((i + 1) % n, i) for i in range(n)]
    else:
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
    return fwd, bwd


def _permute(src: Sharded, mesh: Mesh, axis_name: str, perm) -> Sharded:
    """ppermute along one mesh axis: shard dst gets src's block on its own
    device, zeros where no pair names it."""
    ax = mesh.grid_axis(axis_name)
    frm = {d: s for s, d in perm}

    def get(a, b):
        idx = (a, b)
        s = frm.get(idx[ax])
        if s is None:
            return torch.zeros_like(src[a, b])
        at = (s, b) if ax == 0 else (a, s)
        return src[at].to(mesh.device(a, b))

    if comm.active is not None and any(s != d for s, d in perm):
        comm.active.record("collective-permute", comm.nbytes(src[0, 0]))
    return build(mesh, get)


def exchange_ghosts(x: Sharded, mesh: Mesh, axis_name: str, array_axis: int,
                    *, width: int = 1, periodic: bool = True
                    ) -> Tuple[Sharded, Sharded]:
    """(lo_ghost, hi_ghost) layers of ``width`` cells from the ring
    neighbours along ``axis_name``: lo_ghost holds the left neighbour's
    top edge, hi_ghost the right neighbour's bottom edge; zeros at the
    ends of a non-periodic axis."""
    fwd, bwd = ring_perms(mesh.shape[axis_name], periodic)
    hi_edge = x.map(lambda t: t.narrow(array_axis, t.shape[array_axis]
                                       - width, width))
    lo_edge = x.map(lambda t: t.narrow(array_axis, 0, width))
    # my hi edge travels forward to become my right neighbour's lo ghost
    return (_permute(hi_edge, mesh, axis_name, fwd),
            _permute(lo_edge, mesh, axis_name, bwd))


def halo_pad(x: Sharded, mesh: Mesh, axis_name: str, array_axis: int, *,
             width: int = 1, periodic: bool = True) -> Sharded:
    """Each shard extended by ``width`` ghost layers at both ends of
    ``array_axis`` (the shard plus its halo: the reference's "locally
    relevant" index set)."""
    lo, hi = exchange_ghosts(x, mesh, axis_name, array_axis, width=width,
                             periodic=periodic)
    return x.map(lambda t, l, h: torch.cat([l, t, h], dim=array_axis),
                 lo, hi)


def psum(x: Sharded, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """The sum over every shard of equal-shaped partials, in shard order
    on the first device, then one copy a distinct device: {device:
    total}. The sum runs in float32 at the least (bfloat16 partials are
    widened first)."""
    devs = mesh.distinct_devices()
    if comm.active is not None:
        t = x[0, 0]
        comm.active.record("all-reduce", comm.nbytes(
            t, torch.promote_types(t.dtype, torch.float32)))
    tot = None
    for _, t in x.items():
        t = t.to(devs[0], torch.promote_types(t.dtype, torch.float32))
        tot = t if tot is None else tot + t
    return {d: tot if d == devs[0] else tot.to(d) for d in devs}


def pmax(x: Sharded, mesh: Mesh) -> torch.Tensor:
    """The largest of equal-shaped partials, elementwise, on the first
    device."""
    dev = mesh.distinct_devices()[0]
    if comm.active is not None:
        comm.active.record("all-reduce", comm.nbytes(x[0, 0]))
    out = None
    for _, t in x.items():
        t = t.to(dev)
        out = t if out is None else torch.maximum(out, t)
    return out


def _half_turn_at(rows: Sharded, mesh: Mesh, a: int, b: int
                  ) -> torch.Tensor:
    """Shard (a, b)'s part of :func:`half_turn`."""
    B = mesh.grid[1]
    no = rows[0, 0].shape[-1]
    nlon = B * no
    dev = mesh.device(a, b)
    start = (b * no + nlon // 2) % nlon
    parts: List[torch.Tensor] = []
    c = 0
    while c < no:
        s, col = divmod((start + c) % nlon, no)
        take = min(no - col, no - c)
        parts.append(rows[a, s][..., col:col + take].to(dev))
        c += take
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def half_turn(rows: Sharded, mesh: Mesh) -> Sharded:
    """The global half-turn longitude roll of a lat ring cut over the lon
    shards: shard (a, b) gets the ring's values at lon + pi over its own
    columns. For an even number B of lon shards that is the block of shard
    b + B/2 (a shard permute); for odd B the half turn falls inside a
    shard, and each shard's values come from two neighbouring shards
    (B = 1: the local roll by nlon/2)."""
    if comm.active is not None and mesh.grid[1] > 1:
        comm.active.record("collective-permute", comm.nbytes(rows[0, 0]))
    return build(mesh, lambda a, b: _half_turn_at(rows, mesh, a, b))


def lat_halo(x: Sharded, mesh: Mesh, width: int, sign=None) -> Sharded:
    """[g_-width..g_-1, g_+1..g_+width] lat rows (axis -2) of every shard:
    the neighbours' rows, and on the edge lat shards the pole closure,
    the boundary ring at lon + pi (times ``sign``: a number, or a Sharded
    of factors broadcast over the leading axes, for POLE_FLIP components)
    repeated ``width`` times. ``sign=None``: zeros beyond the poles, as a
    non-periodic exchange gives."""
    A = mesh.grid[0]
    ax = x[0, 0].dim() - 2
    lo, hi = exchange_ghosts(x, mesh, "lat", ax, width=width, periodic=False)
    if sign is None:
        return lo.map(lambda l, h: torch.cat([l, h], dim=ax), hi)
    first = half_turn(x.map(lambda t: t.narrow(ax, 0, 1)), mesh)
    last = half_turn(x.map(lambda t: t.narrow(ax, t.shape[ax] - 1, 1)), mesh)

    def rows(a, b):
        lo_ab, hi_ab = lo[a, b], hi[a, b]
        s = sign[a, b] if isinstance(sign, Sharded) else sign
        if a == 0:
            lo_ab = torch.cat([first[a, b] * s] * width, dim=ax)
        if a == A - 1:
            hi_ab = torch.cat([last[a, b] * s] * width, dim=ax)
        return torch.cat([lo_ab, hi_ab], dim=ax)

    return build(mesh, rows)


def _ring(x: Sharded, mesh: Mesh, name: str, ax: int, width: int
          ) -> Sharded:
    """[g_-width..g_-1, g_+1..g_+width] along array axis ``ax`` from the
    periodic ring of mesh axis ``name``."""
    lo, hi = exchange_ghosts(x, mesh, name, ax, width=width, periodic=True)
    return lo.map(lambda l, h: torch.cat([l, h], dim=ax), hi)


def col_halo(x: Sharded, mesh: Mesh, width: int) -> Sharded:
    """[g_-width..g_-1, g_+1..g_+width] columns (axis -1, periodic)."""
    return _ring(x, mesh, mesh.axis_names[-1], x[0, 0].dim() - 1, width)



def row_halo(x: Sharded, mesh: Mesh, width: int, sign=None) -> Sharded:
    """[g_-width..g_-1, g_+1..g_+width] rows (axis -2): the shell's lat
    rows as :func:`lat_halo` (``sign``: its pole closure), the box's y
    rows from their periodic ring (``sign`` unused)."""
    if mesh.rows == "pole":
        return lat_halo(x, mesh, width, sign)
    return _ring(x, mesh, mesh.axis_names[0], x[0, 0].dim() - 2, width)


def pad_block(x: Sharded, mesh: Mesh, width: int, sign=None) -> Sharded:
    """Every shard padded by ``width`` cells on both sides of its sharded
    axes from its neighbours (rows as :func:`row_halo`, columns periodic;
    a one-axis mesh pads its columns alone); the corners, which no
    axis-wise stencil reads, are zero."""
    pr, pc = mesh.pads(width)
    LO = col_halo(x, mesh, width)
    LH = row_halo(x, mesh, width, sign) if pr else LO

    def pad(t, lh, lo):
        w = width
        out = t.new_zeros(t.shape[:-2] + (t.shape[-2] + 2 * pr,
                                          t.shape[-1] + 2 * w))
        out[..., pr:out.shape[-2] - pr, w:-w] = t
        out[..., pr:out.shape[-2] - pr, :w] = lo[..., :w]
        out[..., pr:out.shape[-2] - pr, -w:] = lo[..., w:]
        if pr:
            out[..., :w, w:-w] = lh[..., :w, :]
            out[..., -w:, w:-w] = lh[..., w:, :]
        return out

    return x.map(pad, LH, LO)


def pad_mirror(x: Sharded, mesh: Mesh, width: int, r_pad=None) -> Sharded:
    """Every shard padded by ``width`` cells along each axis as ops/bc.py
    ``pad_axis_width`` pads the whole field, axis after axis (the
    semi-Lagrangian transport's pad, whose 2^dim-corner gather reads the
    diagonal cells too):

      1. the vertical axis, locally: ``r_pad(a, b, t)`` pads shard (a,
         b)'s block ``t`` with its wall ghosts (None: no vertical pad);
      2. the rows of the padded shard: on the shell the neighbours' lat
         rows, and past a pole ghost k is interior row k - 1 at lon + pi
         (the POLE rule), in the order [g_w .. g_1 | f | g_1 .. g_w] (not
         :func:`lat_halo`'s repeated boundary ring); on the box the
         periodic ring of y; none on a one-axis mesh;
      3. the columns (periodic) of the shard padded so far, so that the
         corners carry the row ghosts, as the single-device wrap does.
    """
    if r_pad is not None:
        x = build(mesh, lambda a, b: r_pad(a, b, x[a, b]))
    A = mesh.grid[0]
    ax = x[0, 0].dim() - 2
    n = x[0, 0].shape[ax]
    if mesh.rows == "periodic":
        x = halo_pad(x, mesh, mesh.axis_names[0], ax, width=width)
    elif mesh.rows == "pole":
        if n < width:
            raise ValueError(f"a shard of {n} lat rows cannot give {width} "
                             "ghost rows")
        lo, hi = exchange_ghosts(x, mesh, "lat", ax, width=width,
                                 periodic=False)
        first = x.map(lambda t: t.narrow(ax, 0, width))
        last = x.map(lambda t: t.narrow(ax, n - width, width))

        def pole(rows, a, b):
            # ghost k (k = 1 nearest) mirrors interior row k - 1
            return _half_turn_at(rows, mesh, a, b).flip(ax)

        if comm.active is not None and mesh.grid[1] > 1:
            for rows in (first, last):   # the two pole closures' half turns
                comm.active.record("collective-permute",
                                   comm.nbytes(rows[0, 0]))

        def lat(a, b):
            lo_ab = pole(first, a, b) if a == 0 else lo[a, b]
            hi_ab = pole(last, a, b) if a == A - 1 else hi[a, b]
            return torch.cat([lo_ab, x[a, b], hi_ab], dim=ax)

        x = build(mesh, lat)
    return halo_pad(x, mesh, mesh.axis_names[-1], ax + 1, width=width,
                    periodic=True)


def _runs(idx, n: int) -> List[List[int]]:
    """[shard, first, stop] runs of consecutive global indices ``idx``
    that lie in one shard of ``n`` rows or columns each."""
    out: List[List[int]] = []
    for i in idx:
        s, k = divmod(int(i), n)
        if out and out[-1][0] == s and out[-1][2] == k:
            out[-1][2] += 1
        else:
            out.append([s, k, k + 1])
    return out


def window(x: Sharded, rows, cols, device, dest=None) -> torch.Tensor:
    """The global rows ``rows`` and columns ``cols`` (global indices of
    axes -2 and -1, any order) of a Sharded field, gathered onto
    ``device`` from the shards that own them (a copy a piece between
    cards, none on one device): each shard's window of
    mesh.window_geometry. ``dest`` names the shard that takes it (the
    all-gather's destination in ``comm_analysis``)."""
    nl, no = x[0, 0].shape[-2:]
    cruns = _runs(cols, no)
    parts = []
    for a, j0, j1 in _runs(rows, nl):
        row = [x[a, b][..., j0:j1, k0:k1].to(device) for b, k0, k1 in cruns]
        parts.append(row[0] if len(row) == 1 else torch.cat(row, dim=-1))
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)
    if comm.active is not None:
        comm.active.record("all-gather", comm.nbytes(out),
                           dest=(str(device), dest))
    return out
