"""Halo exchange and reductions over a mesh of shards (counterpart of the
JAX package's ``parallel/halo.py``).

The JAX functions run inside ``shard_map`` and move data with
``lax.ppermute`` and ``lax.psum``. Here every read of another shard's
data is one move primitive (``_move``): a transport call lists its
pieces, (source shard, index of its block, destination shard), alike on
every process, and each piece is copied with ``Tensor.to`` where this
process holds both shards (a peer copy between cards, no copy on one
device), or sent and received between the two ranks in the call's one
``batch_isend_irecv`` (parallel/dist.py) on a mesh that spans
processes (parallel/mesh.py). Every function below is built on it, so
both forms of the mesh run the same halo rules.

A psum is a sum of the shards' partials in a fixed order (a major, b
minor), on this process's first device, copied to each of its devices
once; on a process mesh the local partials are all-gathered first, and
every rank sums all of them in that order: every rank, and two runs,
get the same bits, and no float atomics are used. ``pmax`` likewise.

On a non-periodic mesh axis the missing neighbour contributes zeros,
as ``ppermute`` does; the pole closure of the shell's lat axis (the
boundary ring at lon + pi) is :func:`half_turn`. Every other sharded
axis (the shell's lon, the box's y and x, the annulus's phi, the slab's
x) is a periodic ring (``row_halo``, ``col_halo``). The rows are the
cell arrays' axis -2 and the columns axis -1 (parallel/mesh.py: a
one-axis mesh has one row of shards and pads no rows). Inside
``comm_analysis.counting`` each transport call reports itself as the
collective the JAX package compiles it to, on every process alike.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.parallel import comm_analysis as comm
from dycoreplanet_tpu_torch.parallel import dist as pdist
from dycoreplanet_tpu_torch.parallel.mesh import Mesh, Sharded, build


def _move(x: Sharded, mesh: Mesh, pieces) -> Dict[int, torch.Tensor]:
    """The cross-shard reads of one transport call: ``pieces`` [(src,
    key, dst)], the source shard's (a, b), an index of its block and the
    destination shard's (a, b), listed alike by every process. Returns
    {i: piece i on its destination's device} for the pieces whose
    destination this process holds: from a local source by ``Tensor.to``,
    from another rank's in one ``batch_isend_irecv``, received into
    buffers shaped from this process's own block (every shard's shape)."""
    out, sends, recvs = {}, [], []
    meta = None
    for i, (src, key, dst) in enumerate(pieces):
        here, there = mesh.is_local(*src), mesh.is_local(*dst)
        if here and there:
            out[i] = x[src][key].to(mesh.device(*dst))
        elif here:
            sends.append((i, x[src][key], mesh.owner(*dst)))
        elif there:
            if meta is None:
                like = x.local()
                meta = torch.empty(like.shape, dtype=like.dtype,
                                   device="meta")
            recvs.append((i, tuple(meta[key].shape), meta.dtype,
                          mesh.device(*dst), mesh.owner(*src)))
    if sends or recvs:
        out.update(pdist.exchange(mesh.group, sends, recvs))
    return out


def _join(grid: List[List[torch.Tensor]]) -> torch.Tensor:
    """Pieces laid out as rows of columns, joined along axes -1 and
    -2."""
    rows = [r[0] if len(r) == 1 else torch.cat(r, dim=-1) for r in grid]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=-2)


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
    A, B = mesh.grid
    pieces, at = [], {}
    for a in range(A):
        for b in range(B):
            s = frm.get((a, b)[ax])
            if s is not None:
                at[a, b] = len(pieces)
                pieces.append(((s, b) if ax == 0 else (a, s), ..., (a, b)))
    if comm.active is not None and any(s != d for s, d in perm):
        comm.active.record("collective-permute", comm.nbytes(src.local()))
    moved = _move(src, mesh, pieces)
    return build(mesh, lambda a, b: moved[at[a, b]] if (a, b) in at
                 else torch.zeros_like(src[a, b]))


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


def _all_partials(x: Sharded, mesh: Mesh, dtype=None) -> List[torch.Tensor]:
    """Every shard's partial (equal shapes) in shard order on this
    process's first device, in ``dtype``: on a process mesh the local
    ones all-gathered (parallel/dist.py)."""
    dev = mesh.own_device
    parts = [t.to(dev, dtype) if dtype is not None else t.to(dev)
             for t in x.parts()]
    if mesh.group is None:
        return parts
    got = pdist.all_gather(mesh.group, torch.stack(parts))
    # each in the memory layout of a local partial (an einsum's may be
    # permuted), so that the sum, and what reads it, runs as on one
    # process
    return [torch.empty_like(parts[0]).copy_(g)
            for g in got.reshape((-1,) + got.shape[2:])]


def psum(x: Sharded, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """The sum over every shard of equal-shaped partials, in shard order
    on this process's first device, then one copy a distinct device of
    the process: {device: total}, the same bits on every rank. The sum
    runs in float32 at the least (bfloat16 partials are widened
    first)."""
    t = x.local()
    acc = torch.promote_types(t.dtype, torch.float32)
    if comm.active is not None:
        comm.active.record("all-reduce", comm.nbytes(t, acc))
    tot = None
    for p in _all_partials(x, mesh, acc):
        tot = p if tot is None else tot + p
    first, *rest = mesh.distinct_devices()
    return {first: tot, **{d: tot.to(d) for d in rest}}


def pmax(x: Sharded, mesh: Mesh) -> torch.Tensor:
    """The largest of equal-shaped partials, elementwise, on this
    process's first device (the same on every rank)."""
    if comm.active is not None:
        comm.active.record("all-reduce", comm.nbytes(x.local()))
    out = None
    for p in _all_partials(x, mesh):
        out = p if out is None else torch.maximum(out, p)
    return out


def _half_turn_runs(B: int, no: int, b: int) -> List[Tuple[int, int, int]]:
    """[(lon shard, first column, count)]: where lon shard b's columns at
    lon + pi lie, in order (one run for even B; for odd B the half turn
    falls inside a shard, and two neighbouring shards give a run each)."""
    nlon = B * no
    start = (b * no + nlon // 2) % nlon
    out, c = [], 0
    while c < no:
        s, col = divmod((start + c) % nlon, no)
        take = min(no - col, no - c)
        out.append((s, col, take))
        c += take
    return out


def half_turn(rows: Sharded, mesh: Mesh, at_row: Optional[int] = None
              ) -> Sharded:
    """The global half-turn longitude roll of a lat ring cut over the lon
    shards: shard (a, b) gets the ring's values at lon + pi over its own
    columns. For an even number B of lon shards that is the block of shard
    b + B/2 (a shard permute); for odd B each shard's values come from two
    neighbouring shards, which may lie on two other ranks (B = 1: the
    local roll by nlon/2). ``at_row``: only the shards of that grid row
    (a pole row) get theirs; the others hold None."""
    A, B = mesh.grid
    no = rows.local().shape[-1]
    if comm.active is not None and B > 1:
        comm.active.record("collective-permute", comm.nbytes(rows.local()))
    pieces, of = [], {}
    for a in range(A) if at_row is None else (at_row,):
        for b in range(B):
            of[a, b] = []
            for s, col, take in _half_turn_runs(B, no, b):
                of[a, b].append(len(pieces))
                pieces.append(((a, s), (..., slice(col, col + take)),
                               (a, b)))
    moved = _move(rows, mesh, pieces)
    return build(mesh, lambda a, b: _join([[moved[i] for i in of[a, b]]])
                 if (a, b) in of else None)


def lat_halo(x: Sharded, mesh: Mesh, width: int, sign=None) -> Sharded:
    """[g_-width..g_-1, g_+1..g_+width] lat rows (axis -2) of every shard:
    the neighbours' rows, and on the edge lat shards the pole closure,
    the boundary ring at lon + pi (times ``sign``: a number, or a Sharded
    of factors broadcast over the leading axes, for POLE_FLIP components)
    repeated ``width`` times. ``sign=None``: zeros beyond the poles, as a
    non-periodic exchange gives."""
    A = mesh.grid[0]
    ax = x.local().dim() - 2
    lo, hi = exchange_ghosts(x, mesh, "lat", ax, width=width, periodic=False)
    if sign is None:
        return lo.map(lambda l, h: torch.cat([l, h], dim=ax), hi)
    first = half_turn(x.map(lambda t: t.narrow(ax, 0, 1)), mesh, 0)
    last = half_turn(x.map(lambda t: t.narrow(ax, t.shape[ax] - 1, 1)), mesh,
                     A - 1)

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
    return _ring(x, mesh, mesh.axis_names[-1], x.local().dim() - 1, width)


def row_halo(x: Sharded, mesh: Mesh, width: int, sign=None) -> Sharded:
    """[g_-width..g_-1, g_+1..g_+width] rows (axis -2): the shell's lat
    rows as :func:`lat_halo` (``sign``: its pole closure), the box's y
    rows from their periodic ring (``sign`` unused)."""
    if mesh.rows == "pole":
        return lat_halo(x, mesh, width, sign)
    return _ring(x, mesh, mesh.axis_names[0], x.local().dim() - 2, width)


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
    ax = x.local().dim() - 2
    n = x.local().shape[ax]
    if mesh.rows == "periodic":
        x = halo_pad(x, mesh, mesh.axis_names[0], ax, width=width)
    elif mesh.rows == "pole":
        if n < width:
            raise ValueError(f"a shard of {n} lat rows cannot give {width} "
                             "ghost rows")
        lo, hi = exchange_ghosts(x, mesh, "lat", ax, width=width,
                                 periodic=False)
        # ghost k (k = 1 nearest) mirrors interior row k - 1 at lon + pi
        first = half_turn(x.map(lambda t: t.narrow(ax, 0, width)), mesh, 0)
        last = half_turn(x.map(lambda t: t.narrow(ax, n - width, width)),
                         mesh, A - 1)

        def lat(a, b):
            lo_ab = first[a, b].flip(ax) if a == 0 else lo[a, b]
            hi_ab = last[a, b].flip(ax) if a == A - 1 else hi[a, b]
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


def windows(x: Sharded, mesh: Mesh, specs: dict) -> Sharded:
    """Windows of the global grid in one transport call: ``specs`` {(a,
    b): (rows, cols)}, listed alike by every process, the global rows of
    axis -2 and columns of axis -1 (global indices, any order) that shard
    (a, b) takes, gathered onto its device from the shards that own them:
    each shard's window of mesh.window_geometry. In ``comm_analysis`` an
    all-gather made one destination at a time."""
    t = x.local()
    nl, no = t.shape[-2:]
    lead = int(np.prod(t.shape[:-2], dtype=np.int64)) * t.element_size()
    pieces: list = []
    plan = {}      # each destination's pieces, as rows of columns
    for dst in sorted(specs):
        rows, cols = specs[dst]
        cruns = _runs(cols, no)
        plan[dst] = []
        for a, j0, j1 in _runs(rows, nl):
            plan[dst].append([])
            for b, k0, k1 in cruns:
                plan[dst][-1].append(len(pieces))
                pieces.append(((a, b), (..., slice(j0, j1), slice(k0, k1)),
                               dst))
        if comm.active is not None:
            comm.active.record("all-gather", lead * len(rows) * len(cols),
                               dest=dst)
    moved = _move(x, mesh, pieces)
    return build(mesh, lambda a, b: _join([[moved[i] for i in r]
                                          for r in plan[a, b]]))
