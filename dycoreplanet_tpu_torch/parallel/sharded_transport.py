"""The semi-Lagrangian temperature transport on a mesh: what the JAX
package leaves to GSPMD around its sharded kernels
(``_advected_temperature`` in the NSE step of a semi-Lagrangian model,
beside K2mo, and in every temperature substep), in plain PyTorch on the
shards, as on one device. The Eulerian transport on a mesh is
parallel/sharded_pallas.py ``ShardedPlainForcing``.

  * ``ShardedSemiLagrangian``: the shard padded by K = 2 cells as the
    single-device transport pads the whole field (``halo.pad_mirror``:
    the radial wall locally, its Dirichlet value cut to the shard; the
    lat rows in the mirror order, pole ghost k at interior row k - 1 at
    lon + pi; then lon, so that the corners carry the lat ghosts), and
    the single-device interpolation (ops/semi_lagrangian.py
    ``interpolate``) on the padded block, with the global cell widths cut
    to the shard. Each cell gathers the same padded values and does the
    same arithmetic as on one device, so the two agree bitwise.

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
    Mesh, Sharded, block, build, local_shape)


def _cut(value, j0: int, nl: int, k0: int, no: int, device):
    """A wall value (a number, or a global (nlat, nlon) tensor) cut to a
    shard's block on ``device``."""
    if torch.is_tensor(value):
        return value[..., j0:j0 + nl, k0:k0 + no].to(device)
    return value


class ShardedSemiLagrangian:
    """SemiLagrangian on a ("lat", "lon") mesh of the shell."""

    def __init__(self, base: SemiLagrangian, mesh: Mesh):
        r_spec, lat_spec, lon_spec = base.specs
        if lon_spec is not None or (lat_spec.lo, lat_spec.hi) != (BC.POLE,
                                                                   BC.POLE):
            raise ValueError("ShardedSemiLagrangian takes a scalar's pole "
                             "rule (POLE) and the periodic lon")
        self.mesh = mesh
        self.K = base.K
        _, nl, no = local_shape(base.geo, mesh)
        if nl < self.K or no < self.K:
            raise ValueError(f"shard too thin for width-{self.K} halos: "
                             f"local {(nl, no)}")
        self.offsets = {(a, b): (a * nl, b * no)
                        for a in range(mesh.shape["lat"])
                        for b in range(mesh.shape["lon"])}
        # each shard's radial rule, its wall values cut to the shard, and
        # its block of the global cell widths
        self.r_specs = {
            ab: BCSpec(r_spec.lo, r_spec.hi,
                       _cut(r_spec.lo_value, j0, nl, k0, no,
                            mesh.device(*ab)),
                       _cut(r_spec.hi_value, j0, nl, k0, no,
                            mesh.device(*ab)))
            for ab, (j0, k0) in self.offsets.items()}
        self._h64 = {ab: block(base._h64, j0, nl, k0, no)
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
                t, 0, self.r_specs[a, b], False, K))
        return build(self.mesh, lambda a, b: interpolate(
            u[a, b], padded[a, b], dt_T,
            self.tables((a, b), T[a, b].device, T[a, b].dtype), K))
