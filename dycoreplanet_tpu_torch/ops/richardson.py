"""K1: the fast path's implicit stage — fixed-iteration Jacobi-Richardson
solves of the momentum and temperature Helmholtz systems with exactly
tracked residuals, plus the pre-Poisson projection head — as a
hand-written CUDA kernel beside the plain PyTorch version.

Replaces the Pallas kernel ``HelmholtzRichardsonPallas._build_call``
(dycoreplanet_tpu/ops/pallas_richardson.py:348). Solves

    (V - dt/Re L) u* = V rhs_u     x0 = rhs_u, ``iters_u`` sweeps
    (V - dt_T/Pe L) T = rhs_T      x0 = T0,    ``iters_T`` sweeps

and emits the left-face velocities of u* and the compatibility-corrected
Poisson right-hand side, with the norms the model's honesty gate reads.
Kernel source: csrc/richardson.cu, one launch per call: a block stages
its tile on a halo of depth ``max(iters) + 1`` in shared memory and runs
every sweep there (:func:`plan` sizes it), with the wall rules folded
into lon-invariant tables (:func:`static_tables`). Bound: device-memory
traffic — 13 fields moved at the least (rhs_u, rhs_T, T0 read; u*,
T_new, three faces, rhs written), ~55 MB at 32x128x256 f32.

``track_residual=False`` is K1's residual-free variant (the JAX
kernel's ``track_residual=False``, pallas_richardson.py:133-142, 332-337,
523-528), which the model runs on the steps between two honesty checks
when ``residual check interval`` > 1: the same iterates, faces and
right-hand side without each system's last residual update, a halo of
``max(iters_u + 1, iters_T)`` on the last pass, and the residual norms
returned as the -1 sentinel ("not checked"); the b-norms are still
computed. Same kernel source, a compile-time ``TRACK = false`` instance.

``halo_mode="operands"`` is K1o, K1 on one shard of a mesh (the JAX
kernel's operands mode, pallas_richardson.py:104-116, 238-313; driven by
parallel/sharded_richardson.py): :meth:`ShellRichardson.call_operands`
takes the shard's inputs extended by ``GH`` = max(iters) + 1 cells on
both sides of lat and lon (the halo exchange's, zeros past a pole) and
returns the owned cells and the shard's five raw sums, which the caller
adds across the mesh. Its tables are the shard's lat-extended slab
(:meth:`ShellRichardson.build_shard_metrics`). Same kernel source, the
``OPS = true`` instance; its plain version runs the plain solves and
head on the extended block (mesh.shard_geometry) and crops. A shard is
a fraction of the grid, so the operands mode takes its tile from the
shard and the card (:func:`plan_operands`) and stages its rows as
16-byte copies (``shared_bytes(..., operands=True)``: rows padded to 16
bytes).

The kernel takes float32, float64 or bfloat16 fields. The bfloat16 form
(the same source, ``__nv_bfloat16`` storage) widens each value as it is
staged, keeps its boxes, tables and sweeps in float32 and rounds each
output once; its residual partials and sums stay float32 (the Pallas
kernel writes them in the state dtype), and so do the iterates between
passes. Its plain version is the float32 plain version on the widened
inputs, the fields rounded once, the norms float32.

The plain version is deliberately the straightforward composition the
JAX package runs on the CPU: ``solvers.fixed.richardson_solve`` over the
ghost-based ``weak_laplacian`` and the plain projection head, so an
error in the kernel's tables or tiling shows in the comparison.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dycoreplanet_tpu_torch.grid.geometry import Geometry
from dycoreplanet_tpu_torch.ops import kernel_lib as kl
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.projection import faces_div_plain
from dycoreplanet_tpu_torch.parallel.mesh import block, crop, shard_geometry
from dycoreplanet_tpu_torch.solvers.cg import _dot
from dycoreplanet_tpu_torch.solvers.fixed import richardson_solve

FIELDS_MOVED = 13
# floating-point operations per cell: ~30 per weak-Laplacian apply to
# one channel, (iters + 1) applies for each of the 4 channels (iters for
# the residual-free variant), plus the projection head and the norms
OPS_PER_CHANNEL_APPLY = 30
OPS_PER_CELL_HEAD = 40

THREADS = 256             # csrc/richardson.cu THREADS
SHARED_TABLES = 17        # csrc/richardson.cu S_K: 13 metric channels + 4 1/D
# the H100's shared memory an SM, what CUDA reserves of it a block, and
# the kernel's static shared flag
SMEM_PER_SM, SMEM_RESERVED, SMEM_STATIC = 233472, 1024, 16
# tiles (radial, lat, lon) in order of preference; the first whose halo
# fits shared memory is taken, each clipped to the grid (`plan`; K1o's
# `plan_operands` weighs them all)
TILES = ((8, 8, 32), (8, 8, 16), (4, 8, 16), (4, 4, 16), (4, 4, 8),
         (2, 4, 8), (2, 2, 8), (2, 2, 4), (1, 2, 4), (1, 1, 4), (1, 1, 2),
         (1, 1, 1))


@dataclass(frozen=True)
class PassPlan:
    """One launch of the kernel: ``n_u`` / ``n_T`` sweeps on a tile with a
    halo of depth ``halo`` (= max(n_u, n_T) + 1; on the last pass of the
    residual-free variant max(n_u + 1, n_T))."""
    n_u: int
    n_T: int
    halo: int
    tile: Tuple[int, int, int]
    grid: Tuple[int, int, int]     # tiles along (radial, lat, lon)
    smem_bytes: int

    @property
    def n_blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def shared_bytes(tile, halo: int, itemsize: int,
                 operands: bool = False) -> int:
    """Dynamic shared memory of one block (csrc/richardson.cu's layout):
    two x boxes on the tile + halo (this channel's and the next one's),
    r and dx on the tile + halo - 1, the divergence of the tile, the
    (i, j) tables and the warps' five partial sums. The operands mode's
    rows are padded for 16-byte copies (x rows to a multiple of 16 bytes,
    level-1 rows with one more value in front, the divergence to 16
    bytes)."""
    RB, TL, TO = tile
    XA, XB, XC = RB + 2 * halo, TL + 2 * halo, TO + 2 * halo
    n_tile = RB * TL * TO
    XP, RP = XC, XC - 2
    if operands:
        v = 16 // itemsize
        r = lambda n: -(-n // v) * v  # noqa: E731
        XP, RP, n_tile = r(XC), r(XC - 1), r(n_tile)
    n_x = XA * XB * XP
    n_r = (XA - 2) * (XB - 2) * RP
    return itemsize * (2 * n_x + 2 * n_r + n_tile
                       + SHARED_TABLES * XA * XB + 5 * (THREADS // 32))


def _tile_for(shape, halo, itemsize, limit):
    for t in TILES:
        t = tuple(min(a, n) for a, n in zip(t, shape))
        if shared_bytes(t, halo, itemsize) <= limit:
            return t
    return None


def plan(shape, itemsize: int, iters_u: int, iters_T: int,
         smem_limit: int = kl.SMEM_PER_BLOCK - 16,
         track: bool = True) -> Tuple[PassPlan, ...]:
    """The launches of one call. One pass with halo max(iters) + 1 when a
    tile fits ``smem_limit`` (16 bytes are left for the kernel's static
    shared flag); otherwise the sweeps run in groups, one pass each,
    through device memory. ``track=False`` (the residual-free variant):
    the last pass needs no residual, so its halo is max(n_u + 1, n_T)."""
    group = max(iters_u, iters_T)
    while group > 1 and _tile_for(shape, group + 1, itemsize,
                                  smem_limit) is None:
        group -= 1
    passes = []
    ru, rT = iters_u, iters_T
    while True:
        nu, nT = min(ru, group), min(rT, group)
        ru, rT = ru - nu, rT - nT
        last = ru == 0 and rT == 0
        halo = max(nu, nT) + 1 if track or not last else max(nu + 1, nT)
        tile = _tile_for(shape, halo, itemsize, smem_limit)
        if tile is None:
            raise ValueError(f"no Richardson tile fits {smem_limit} bytes "
                             f"of shared memory")
        grid = tuple(-(-n // t) for n, t in zip(shape, tile))
        passes.append(PassPlan(nu, nT, halo, tile, grid,
                               shared_bytes(tile, halo, itemsize)))
        if last:
            return tuple(passes)


def resident_per_sm(smem_bytes: int, per_sm: int) -> int:
    """Blocks of ``smem_bytes`` of dynamic shared memory an SM holds at
    once, at most ``per_sm`` (what the instance's registers allow)."""
    return min(per_sm, SMEM_PER_SM // (smem_bytes + SMEM_STATIC
                                       + SMEM_RESERVED))


def plan_operands(shape, sms: int, per_sm: int, itemsize: int, iters_u: int,
                  iters_T: int) -> PassPlan:
    """K1o's launch on a shard of ``shape`` on a card of ``sms`` SMs, each
    holding at most ``per_sm`` blocks of the instance at once (its
    registers; shared memory may allow fewer): one pass of halo
    max(iters) + 1 on the tile of TILES (clipped to the shard) with the
    fewest rounds of resident slots, ceil(blocks / slots), weighted by
    the cells of a block's x box (the four channels each stage and sweep
    one); then the larger tile, which recomputes less halo
    (scripts/probe_k1_k2.py: PERF.md §6). At the whole 32 x 128 x 256
    grid this is K1's (8, 8, 32)."""
    halo = max(iters_u, iters_T) + 1
    best = None
    for t in TILES:
        tile = tuple(min(a, n) for a, n in zip(t, shape))
        smem = shared_bytes(tile, halo, itemsize, operands=True)
        resident = resident_per_sm(smem, per_sm)
        if smem > kl.SMEM_PER_BLOCK - SMEM_STATIC or resident < 1:
            continue
        grid = tuple(-(-n // a) for n, a in zip(shape, tile))
        rounds = -(-grid[0] * grid[1] * grid[2] // (sms * resident))
        key = (rounds * int(np.prod([a + 2 * halo for a in tile])),
               -int(np.prod(tile)))
        if best is None or key < best[0]:
            best = (key, PassPlan(iters_u, iters_T, halo, tile, grid, smem))
    if best is None:
        raise ValueError(f"no Richardson tile of halo {halo} fits shared "
                         f"memory")
    return best[1]


def static_tables(geo: Geometry, helm_diags, T_diag) -> np.ndarray:
    """(17, nr, nlat) float64 lon-invariant tables of the kernel. The
    first 15 channels are the JAX kernel's ``_chans64``
    (pallas_richardson.py:185-219): vol; the radial conductances
    area/dist with the wall faces zeroed; the lat conductances (zero at
    the poles, whose faces have no area); the lon conductance; the four
    -weak_lap diagonals; the left-face areas ar_lo, alat_lo and alon; the
    ANTISYM wall ghosts folded into diagonal adjustments for u_r and for
    the other channels. Then ar_hi and alat_hi for the projection head."""
    ch = kl.shell_channels(geo)
    nr = geo.cell_shape[0]
    cr_lo = ch["ar_lo"] / ch["dr_lo"]
    cr_hi = ch["ar_hi"] / ch["dr_hi"]
    cr_lo_z, cr_hi_z = cr_lo.copy(), cr_hi.copy()
    cr_lo_z[0] = 0.0
    cr_hi_z[nr - 1] = 0.0
    dl_oth = np.zeros_like(cr_lo)
    dl_oth[0] = -2.0 * cr_lo[0]
    dl_ur = dl_oth.copy()
    dl_ur[nr - 1] = -2.0 * cr_hi[nr - 1]
    Ld = kl.lon_invariant(helm_diags, "helm_diags")       # (3, nr, nlat)
    Ld_T = kl.lon_invariant(T_diag, "T_diag")
    return np.stack([
        ch["vol"], cr_lo_z, cr_hi_z,
        ch["alat_lo"] / ch["dlat_lo"], ch["alat_hi"] / ch["dlat_hi"],
        ch["alon"] / ch["dlon"], Ld[0], Ld[1], Ld[2], Ld_T,
        ch["ar_lo"], ch["alat_lo"], ch["alon"], dl_ur, dl_oth,
        ch["ar_hi"], ch["alat_hi"]])


class DeviceTables(NamedTuple):
    """The kernel's tensors on one (device, dtype)."""
    M: torch.Tensor          # the static tables (static_tables)
    counter: torch.Tensor    # the last-block counter (resets itself)
    invD: torch.Tensor       # the 1/D tables of ``dt``, refilled in place
    dt: Optional[float]      # the dt invD holds (None: not yet filled)
    neg1: torch.Tensor       # the -1 sentinel of the residual-free norms


class ShellRichardson:
    """Callable (rhs_u, rhs_T, T0, dt) -> (u_star, T_new,
    (uf0, uf1, uf2, rhs_phi), (rnorm_u, bnorm_u, rnorm_T, bnorm_T)).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``track_residual=False``: the residual-free variant, rnorm_u and
    rnorm_T -1."""

    def __init__(self, geo: Geometry, *, one_over_Re: float,
                 one_over_Pe: float, nse_interval: int,
                 helm_diags: np.ndarray, T_diag: np.ndarray,
                 iters_u: int, iters_T: int, u_specs, T_specs_hom,
                 track_residual: bool = True, halo_mode: str = "rolls",
                 local_shape: Optional[Tuple[int, int, int]] = None):
        if iters_u < 1 or iters_T < 1:
            raise ValueError("the Richardson kernel needs >= 1 iteration")
        if halo_mode not in ("rolls", "operands"):
            raise ValueError(f"unknown halo mode {halo_mode!r}")
        if halo_mode == "operands" and not track_residual:
            raise ValueError("the operands mode tracks every residual")
        self.geo = geo
        self.one_over_Re = float(one_over_Re)
        self.one_over_Pe = float(one_over_Pe)
        self.dt_T_factor = 1.0 / float(nse_interval)
        self.iters_u, self.iters_T = int(iters_u), int(iters_T)
        self.track_residual = bool(track_residual)
        self.u_specs, self.T_specs_hom = u_specs, T_specs_hom
        self.helm_diags = np.asarray(helm_diags)
        self.T_diag = np.asarray(T_diag)
        self.tables64 = static_tables(geo, self.helm_diags, self.T_diag)
        # "rolls": the whole grid; "operands": one shard of local_shape,
        # inputs extended by GH cells in lat and lon
        self.halo_mode = halo_mode
        self.local_shape = (tuple(local_shape) if halo_mode == "operands"
                            else geo.cell_shape)
        self.GH = (max(self.iters_u, self.iters_T) + 1
                   if halo_mode == "operands" else 0)
        self._dev = {}           # (device, dtype[, shard row]) -> DeviceTables
        self._geos = {}          # shard offset -> extended shard geometry
        self._fn = {}
        self._card = {}          # (device, dtype) -> (plan, resident slots)
        self.launches = 0

    def plan(self, dtype: torch.dtype) -> Tuple[PassPlan, ...]:
        return plan(self.local_shape, _itemsize(dtype), self.iters_u,
                    self.iters_T, track=self.track_residual)

    def coefs(self, dt, dtype):
        """coef_u = dt/Re and coef_T = dt_T/Pe, rounded as the kernel and
        the plain version take them."""
        npd = kl.NP_DTYPE[dtype]
        return (float(npd(dt) * npd(self.one_over_Re)),
                float(npd(npd(dt) * npd(self.dt_T_factor))
                      * npd(self.one_over_Pe)))

    # ------------------------------------------------------------------
    def plain(self, rhs_u, rhs_T, T0, dt):
        if rhs_u.dtype == torch.bfloat16:
            *fields, norms = self.plain(*kl.widen((rhs_u, rhs_T, T0)), dt)
            return (*kl.narrow(fields), norms)
        geo = self.geo
        dtype = rhs_u.dtype
        vol = st.metric(geo, "vol", 0, rhs_u)
        coef, kT = self.coefs(dt, dtype)
        hd = torch.as_tensor(self.helm_diags, dtype=dtype,
                             device=rhs_u.device)
        td = torch.as_tensor(self.T_diag, dtype=dtype, device=rhs_u.device)

        def helm_op(x):
            return vol[None] * x - coef * torch.stack([
                st.weak_laplacian(geo, x[c], self.u_specs[c])
                for c in range(3)])

        def temp_op(x):
            return vol * x - kT * st.weak_laplacian(geo, x, self.T_specs_hom)

        track = self.track_residual
        res_u = richardson_solve(helm_op, vol[None] * rhs_u, rhs_u,
                                 diag=vol[None] + coef * hd,
                                 iters=self.iters_u, track_residual=track)
        res_T = richardson_solve(temp_op, rhs_T, T0, diag=vol + kT * td,
                                 iters=self.iters_T, track_residual=track)
        uf0, uf1, uf2, rhs_raw, total = faces_div_plain(
            geo, self.u_specs, res_u.x, dt)
        rhs_phi = rhs_raw - total / float(geo.n_cells)
        b_u = vol[None] * rhs_u
        return (res_u.x, res_T.x, (uf0, uf1, uf2, rhs_phi),
                (res_u.residual_norm, torch.sqrt(_dot(b_u, b_u)),
                 res_T.residual_norm, torch.sqrt(_dot(rhs_T, rhs_T))))

    # ------------------------------------------------------------------
    def tables(self, dt, dev, dtype, j0: Optional[int] = None
               ) -> DeviceTables:
        """The kernel's tensors on (dev, dtype), with the 1/D tables of
        ``dt``; with ``j0``, those of the operands mode's lat shard whose
        first row is j0 (the slab of :meth:`build_shard_metrics`). The 1/D
        tables are one buffer per key, refilled in place by kernels (no
        host copy) when dt changes, so that a CUDA graph that reads them
        stays valid if this is called with the graph's dt before each
        replay (``BoussinesqModel._prepare_dt``)."""
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (str(dev), dtype, j0)
        c = self._dev.get(key)
        if c is None:
            host = (self.tables64 if j0 is None
                    else self._slab(j0, self.local_shape[1]))
            cdt = kl.compute_dtype(dtype)
            M = torch.as_tensor(host, dtype=cdt, device=dev).contiguous()
            c = DeviceTables(M, torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.empty_like(M[6:10]), None,
                             torch.full((), -1.0, dtype=cdt, device=dev))
        if c.dt != float(dt):
            cu, cT = self.coefs(dt, dtype)
            torch.reciprocal(c.M[0][None] + cu * c.M[6:9], out=c.invD[:3])
            torch.reciprocal(c.M[0] + cT * c.M[9], out=c.invD[3])
            c = c._replace(dt=float(dt))
        self._dev[key] = c
        return c

    def _launch(self, rhs_u, rhs_T, T0, dt):
        dev, dtype = rhs_u.device, rhs_u.dtype
        M, counter, invD, _, neg1 = self.tables(dt, dev, dtype)
        sfx = kl.suffix(dtype)
        fn = self._fn.get(sfx)
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("richardson.cu", f"dp_richardson_{sfx}",
                         [I] * 8 + [P] * 8 + [D] * 4 + [I] * 3 + [P] * 11
                         + [I, P])
            self._fn[sfx] = fn
        shp = self.geo.cell_shape
        nr, nlat, nlon = shp
        new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
        # the compute type's: partials, sums and the scratch
        cnew = lambda *s: torch.empty(s, dtype=kl.compute_dtype(dtype),
                                      device=dev)
        u_star, T_new = new(3, *shp), new(*shp)
        f0, f1, f2, rhs_raw = (new(*shp) for _ in range(4))
        passes = self.plan(dtype)
        parts = cnew(passes[-1].n_blocks, 5)
        sums = cnew(5)
        # iterates and residuals between passes ping-pong through two
        # scratch sets (x_u, x_T, r_u, r_T)
        scratch = [(cnew(3, *shp), cnew(*shp), cnew(3, *shp), cnew(*shp))
                   for _ in range(min(2, len(passes) - 1))]
        p = kl.ptr
        null = ctypes.c_void_p(None)
        ins = (p(rhs_u), p(T0), null, null)
        for n, ps in enumerate(passes):
            last = n == len(passes) - 1
            outs = ((p(u_star), p(T_new), null, null) if last
                    else tuple(p(t) for t in scratch[n % 2]))
            kl.check(fn(nr, nlat, nlon, *ps.tile, ps.halo, ps.smem_bytes,
                        p(M), p(invD), ins[0], ins[1], p(rhs_u), p(rhs_T),
                        ins[2], ins[3], float(dt), self.one_over_Re,
                        self.one_over_Pe, self.dt_T_factor, ps.n_u, ps.n_T,
                        int(last), *outs, p(f0), p(f1), p(f2), p(rhs_raw),
                        p(parts), p(counter), p(sums),
                        int(self.track_residual), kl.stream_of(rhs_u)),
                     "richardson kernel")
            ins = outs
        rhs_phi = rhs_raw - sums[4] / float(self.geo.n_cells)
        norms = torch.sqrt(sums[:4])
        rn_u, rn_T = ((norms[0], norms[2]) if self.track_residual
                      else (neg1, neg1))
        return (u_star, T_new, (f0, f1, f2, rhs_phi),
                (rn_u, norms[1], rn_T, norms[3]))

    # ------------------------------------------------------------------
    # operands mode (K1o): one shard of a mesh
    def _slab(self, j0: int, nl: int) -> np.ndarray:
        """(17, nr, nl + 2 GH) float64 tables of the lat shard whose first
        row is j0: rows j0 - GH .. j0 + nl + GH, clipped at the poles like
        the radial walls (the rows past a pole cross no face of nonzero
        area), except the lat face areas (channels 11 and 16), which are
        indexed by face and clipped at face nlat, so that the flux area
        past a pole is exactly 0."""
        nlat = self.geo.cell_shape[1]
        GH = self.GH
        rows = np.arange(j0 - GH, j0 + nl + GH)
        out = self.tables64[:, :, np.clip(rows, 0, nlat - 1)].copy()
        ch = kl.shell_channels(self.geo)
        area_l = np.concatenate([ch["alat_lo"], ch["alat_hi"][:, -1:]], 1)
        out[11] = area_l[:, np.clip(rows, 0, nlat)]
        out[16] = area_l[:, np.clip(rows + 1, 0, nlat)]
        return out

    def build_shard_metrics(self, n_lat_shards: int) -> np.ndarray:
        """(A, 17, nr, nlat / A + 2 GH) float64: the tables of every lat
        shard (lon sharding needs none: every channel is lon-invariant).
        The JAX kernel's 15 channels are the first 15, with the same lat
        extension and clipping (pallas_richardson.py:238-276)."""
        if self.halo_mode != "operands":
            raise ValueError("build_shard_metrics is the operands mode's")
        nlat = self.geo.cell_shape[1]
        if nlat % n_lat_shards:
            raise ValueError(f"nlat {nlat} not divisible by {n_lat_shards}")
        nl = nlat // n_lat_shards
        return np.stack([self._slab(a * nl, nl)
                         for a in range(n_lat_shards)])

    def _shard_geometry(self, offset):
        g = self._geos.get(offset)
        if g is None:
            nr, nl, no = self.local_shape
            g = shard_geometry(self.geo, offset[0], nl, offset[1], no,
                               pad=self.GH)
            self._geos[offset] = g
        return g

    def plain_operands(self, ru_e, rT_e, T0_e, dt, offset):
        """Plain version of K1o: the solves of :meth:`plain` and the
        projection head on the extended block (its geometry the global
        metric there), cropped to the owned cells; the five sums over
        them (|r_u|^2, |b_u|^2, |r_T|^2, |b_T|^2, sum rhs_raw). The block
        is GH cells deep, so the garbage that the block's own edge rules
        make spreads no further than GH - 1 cells in by the last residual
        update. bfloat16 inputs: the float32 plain version on them
        widened, the fields rounded once, the sums float32."""
        if ru_e.dtype == torch.bfloat16:
            *fields, parts = self.plain_operands(
                *kl.widen((ru_e, rT_e, T0_e)), dt, offset)
            return (*kl.narrow(fields), parts)
        geo = self._shard_geometry(offset)
        GH = self.GH
        nr, nl, no = self.local_shape
        j0, k0 = offset
        dtype, dev = ru_e.dtype, ru_e.device
        vol = st.metric(geo, "vol", 0, ru_e)
        coef, kT = self.coefs(dt, dtype)
        t = lambda a: torch.as_tensor(block(a, j0, nl, k0, no, GH),
                                      dtype=dtype, device=dev)
        hd, td = t(self.helm_diags), t(self.T_diag)

        def helm_op(x):
            return vol[None] * x - coef * torch.stack([
                st.weak_laplacian(geo, x[c], self.u_specs[c])
                for c in range(3)])

        def temp_op(x):
            return vol * x - kT * st.weak_laplacian(geo, x, self.T_specs_hom)

        def solve(op, b, x, diag, iters):
            # solvers.fixed.richardson_solve's loop, keeping r
            r = b - op(x)
            for _ in range(iters):
                dx = r / diag
                x = x + dx
                r = r - op(dx)
            return x, r

        b_u = vol[None] * ru_e
        xu, r_u = solve(helm_op, b_u, ru_e, vol[None] + coef * hd,
                        self.iters_u)
        xT, r_T = solve(temp_op, rT_e, T0_e, vol + kT * td, self.iters_T)
        f0, f1, f2, rhs_raw, _ = faces_div_plain(geo, self.u_specs, xu, dt)
        c = lambda x: crop(x, GH).contiguous()
        f1 = c(f1)
        if j0 == 0:     # the pole face (global face 0) carries nothing
            f1[:, 0] = 0.0
        rhs_raw = c(rhs_raw)
        sq = lambda x: torch.sum(c(x) * c(x))
        parts = torch.stack([sq(r_u), sq(b_u), sq(r_T), sq(rT_e),
                             torch.sum(rhs_raw)])
        return c(xu), c(xT), c(f0), f1, c(f2), rhs_raw, parts

    def call_operands(self, ru_e, rT_e, T0_e, dt, offset):
        """K1o on one shard whose first cell is global (row, column)
        ``offset``: (u_star, T_new, uf0, uf1, uf2, rhs_raw, parts), the
        owned cells and the five raw sums. CPU tensors take the plain
        version; CUDA tensors launch the kernel."""
        if self.halo_mode != "operands":
            raise ValueError("call_operands is the operands mode's")
        if ru_e.device.type == "cpu":
            return self.plain_operands(ru_e, rT_e, T0_e, dt, offset)
        nr, nl, no = self.local_shape
        ext = (nr, nl + 2 * self.GH, no + 2 * self.GH)
        kl.require_cuda("richardson (operands)", {
            "rhs_u": (ru_e, (3,) + ext), "rhs_T": (rT_e, ext),
            "T0": (T0_e, ext)})
        out = self._launch_operands(ru_e, rT_e, T0_e, dt, offset)
        self.launches += 1
        return out

    def occupancy(self, dtype: torch.dtype, smem_bytes: int = 0) -> int:
        """Resident blocks an SM of K1o's instance with ``smem_bytes`` of
        dynamic shared memory (CUDA's occupancy calculator at its launch's
        block size); with none, what its registers allow."""
        blocks = ctypes.c_int(0)
        fn = kl.bind("richardson.cu",
                     f"dp_richardson_{kl.suffix(dtype)}_occupancy",
                     [ctypes.c_int, ctypes.c_void_p])
        kl.check(fn(int(smem_bytes), ctypes.byref(blocks)),
                 "richardson occupancy")
        return blocks.value

    def operands_plan(self, device, dtype: torch.dtype):
        """(plan, resident slots) of the operands mode's launch on
        ``device``: ``plan_operands`` of the shard with the card's SM count
        and the blocks an SM that the instance's registers allow, made
        once a device and dtype; the slots are the card's resident blocks
        of the instance at the plan's shared memory (CUDA's count)."""
        key = (str(device), dtype)
        card = self._card.get(key)
        if card is None:
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            ps = plan_operands(self.local_shape, sms, self.occupancy(dtype),
                               _itemsize(dtype), self.iters_u, self.iters_T)
            card = (ps, sms * self.occupancy(dtype, ps.smem_bytes))
            self._card[key] = card
        return card

    def _launch_operands(self, ru_e, rT_e, T0_e, dt, offset):
        dev, dtype = ru_e.device, ru_e.dtype
        j0 = offset[0]
        M, counter, invD, _, _ = self.tables(dt, dev, dtype, j0)
        ps = self.operands_plan(dev, dtype)[0]
        if ps.halo != self.GH:
            raise ValueError(f"the operands mode runs one pass of halo "
                             f"{self.GH}; the plan is {ps}")
        sfx = kl.suffix(dtype)
        fn = self._fn.get(("operands", sfx))
        if fn is None:
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            fn = kl.bind("richardson.cu", f"dp_richardson_{sfx}_operands",
                         [I] * 8 + [P] * 8 + [D] * 4 + [I] * 3 + [P] * 11
                         + [I, I, I, P])
            self._fn[("operands", sfx)] = fn
        nr, nl, no = self.local_shape
        new = lambda *s: torch.empty(s, dtype=dtype, device=dev)
        u_star, T_new = new(3, nr, nl, no), new(nr, nl, no)
        f0, f1, f2, rhs_raw = (new(nr, nl, no) for _ in range(4))
        cdt = kl.compute_dtype(dtype)
        parts = torch.empty(ps.n_blocks, 5, dtype=cdt, device=dev)
        sums = torch.empty(5, dtype=cdt, device=dev)
        p = kl.ptr
        null = ctypes.c_void_p(None)
        kl.check(fn(nr, nl, no, *ps.tile, ps.halo, ps.smem_bytes, p(M),
                    p(invD), p(ru_e), p(T0_e), p(ru_e), p(rT_e), null, null,
                    float(dt), self.one_over_Re, self.one_over_Pe,
                    self.dt_T_factor, ps.n_u, ps.n_T, 1, p(u_star),
                    p(T_new), null, null, p(f0), p(f1), p(f2), p(rhs_raw),
                    p(parts), p(counter), p(sums), self.GH, j0,
                    self.geo.cell_shape[1], kl.stream_of(ru_e)),
                 "richardson kernel (operands)")
        return u_star, T_new, f0, f1, f2, rhs_raw, sums

    def __call__(self, rhs_u, rhs_T, T0, dt):
        if self.halo_mode != "rolls":
            raise ValueError("the operands mode is called by call_operands")
        if rhs_u.device.type == "cpu":
            return self.plain(rhs_u, rhs_T, T0, dt)
        shp = self.geo.cell_shape
        kl.require_cuda("richardson", {
            "rhs_u": (rhs_u, (3,) + shp), "rhs_T": (rhs_T, shp),
            "T0": (T0, shp)})
        out = self._launch(rhs_u, rhs_T, T0, dt)
        self.launches += 1
        return out


def _itemsize(dtype: torch.dtype) -> int:
    """Bytes of a value of the kernel's shared memory (its compute type)."""
    return torch.finfo(kl.compute_dtype(dtype)).bits // 8


def ops_per_cell(iters_u: int, iters_T: int, track: bool = True) -> int:
    """Operations per cell of one K1 call (for the roofline bound): each
    channel's operator applies are r = b - A x0 and one residual update a
    sweep, less the last one without residual tracking."""
    extra = 1 if track else 0
    applies = 3 * (iters_u + extra) + (iters_T + extra)
    return applies * OPS_PER_CHANNEL_APPLY + OPS_PER_CELL_HEAD
