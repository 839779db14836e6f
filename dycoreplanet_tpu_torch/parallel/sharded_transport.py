"""The semi-Lagrangian temperature transport on a mesh: what the JAX
package leaves to GSPMD around its sharded kernels
(``_advected_temperature`` in the NSE step of a semi-Lagrangian model,
beside K2mo, and in every temperature substep), in plain PyTorch on the
shards, as on one device. The Eulerian transport on a mesh is
parallel/sharded_pallas.py ``ShardedPlainForcing``.

  * ``ShardedSemiLagrangian``: the shard padded by K = 2 cells as the
    single-device transport pads the whole field (``halo.pad_mirror``:
    the vertical wall locally, its Dirichlet value cut to the shard; on
    the shell the lat rows in the mirror order, pole ghost k at interior
    row k - 1 at lon + pi, on the box the periodic y rows; then the
    periodic columns, so that the corners carry the row ghosts), and the
    single-device interpolation (ops/semi_lagrangian.py
    ``interpolate``) on the padded block, with the global cell widths cut
    to the shard. Each cell gathers the same padded values and does the
    same arithmetic as on one device, so the two agree bitwise. It runs
    on every geometry's mesh (parallel/mesh.py).

A callable (u, u_faces, T, dt_T) -> T_adv on Sharded fields; ``calls``
counts the calls.
"""

from __future__ import annotations

import torch

from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec, pad_axis_width
from dycoreplanet_tpu_torch.ops.semi_lagrangian import (
    SemiLagrangian, interpolate, make_tables)
from dycoreplanet_tpu_torch.parallel.halo import pad_mirror
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, Sharded, block, build, local_offsets, local_shape)


def _cut(value, j0: int, nl: int, k0: int, no: int, device):
    """A wall value (a number, or a global tensor of the cells' shape
    without the vertical axis: (n1, n2), or (n2,) on a 2D grid) cut to a
    shard's block on ``device``."""
    if not torch.is_tensor(value):
        return value
    if value.dim() > 1:
        value = value[..., j0:j0 + nl, :]
    return value[..., k0:k0 + no].to(device)


class ShardedSemiLagrangian:
    """SemiLagrangian on the geometry's mesh (the shell's ("lat", "lon"),
    the box's ("y", "x"), the annulus's ("phi",), the slab's ("x",))."""

    def __init__(self, base: SemiLagrangian, mesh: Mesh):
        r_spec, *rest = base.specs
        pole = [BCSpec(BC.POLE, BC.POLE), None]
        want = pole if mesh.rows == "pole" else [None] * len(rest)
        if [None if s is None else (s.lo, s.hi) for s in rest] != [
                None if s is None else (s.lo, s.hi) for s in want]:
            raise ValueError("ShardedSemiLagrangian takes a scalar's pole "
                             "rule (POLE) on the shell's lat and periodic "
                             "sharded axes elsewhere")
        self.mesh = mesh
        self.K = base.K
        self.r_periodic = base.geo.axes[0].periodic
        nl, no = local_shape(base.geo, mesh)[-2:]
        if (mesh.rows and nl < self.K) or no < self.K:
            raise ValueError(f"shard too thin for width-{self.K} halos: "
                             f"local {(nl, no)}")
        self.offsets = local_offsets(base.geo, mesh)
        # each of this process's shards' radial rule, its wall values cut
        # to the shard, and its block of the global cell widths
        self.r_specs = {
            ab: None if r_spec is None else BCSpec(
                r_spec.lo, r_spec.hi,
                _cut(r_spec.lo_value, j0, nl, k0, no, mesh.device(*ab)),
                _cut(r_spec.hi_value, j0, nl, k0, no, mesh.device(*ab)))
            for ab, (j0, k0) in self.offsets.items()}
        self._h64 = {ab: block(base._h64, j0, nl, k0, no, rows=mesh.rows)
                     for ab, (j0, k0) in self.offsets.items()}
        self._dev = {}
        self.calls = 0

    def tables(self, ab, device, dtype):
        key = (ab, str(device), dtype)
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = make_tables(self._h64[ab], self.K, device,
                                             dtype)
        return t

    def __call__(self, u: Sharded, u_faces, T: Sharded, dt_T) -> Sharded:
        """T at the backward departure points of the cell velocities
        ``u`` (``u_faces`` unused: the Eulerian transport's)."""
        self.calls += 1
        K = self.K
        padded = pad_mirror(
            T, self.mesh, K,
            r_pad=lambda a, b, t: pad_axis_width(
                t, 0, self.r_specs[a, b], self.r_periodic, K))
        return build(self.mesh, lambda a, b: interpolate(
            u[a, b], padded[a, b], dt_T,
            self.tables((a, b), T[a, b].device, T[a, b].dtype), K))
