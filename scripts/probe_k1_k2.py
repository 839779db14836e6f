#!/usr/bin/env python3
"""Where the tiled kernels K1 (csrc/richardson.cu) and K2 (csrc/forcing.cu)
spend their time on the card, at the bench shape (32x128x256 f32, seeded
developed flow), and K2o / K2mo / K1o (K2, K2m and K1 in their operands
mode) on the bench's shards.

    python3 scripts/probe_k1_k2.py [--operands-only] [--root DIR]

``--operands-only`` runs the K2o / K2mo / K1o part alone; ``--root DIR``
imports the package from the checkout at DIR (another commit unpacked
there), so that two commits' kernels are probed in one run.

Prints
  * each kernel's time (diagnostics.device_time.time_ms: mean device time
    of one call over 50 back-to-back calls) under other launch plans than
    the default: K2 radial chunks; K1 tiles, with the bench's tile on its
    compile-time instance, then every tile on the run-time-tiled instance
    (built with -DK1_RUNTIME_TILE);
  * cycles per block per call in each phase, from the kernels built with
    their clock64() probes compiled in (kernel_lib.use_macros, -DK_PROBE:
    thread 0 of each block adds the cycles since the previous probe to a
    counter). A phase's cycles include the waits at its closing barrier
    and the instruction slots the other blocks of the SM take meanwhile;
  * K2o and K2mo on shard (0, 0) of the meshes 2x2 and 2x4 (32x64x128
    and 32x64x64 f32): the time under radial chunks RS of 1, 2, 3, 4, 8
    and 16 planes a block beside the launch plan's own (its blocks and
    the card's resident slots), and K2o's cycles per block in each phase
    at the 2x4 shard under the plan;
  * K1o on shard (0, 0) of the meshes 2x2 and 2x4, f32 and f64: the time
    of every tile of ops/richardson.py TILES whose halo fits shared
    memory, with the blocks, the shared memory, the card's resident
    blocks of that launch and the plan's pick marked; and K1o's cycles
    per block in each phase at the 2x4 shard under the plan (f32). A
    parent commit without the plan: its launch's time (a (8, 8, 32)
    tile) and cycles.
Needs one CUDA card; exits non-zero without one.
"""

import argparse
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# radial chunks of the operands sweep
OPS_CHUNKS = (1, 2, 3, 4, 8, 16)

# the probe ids of csrc/richardson.cu and csrc/forcing.cu, by phase
PHASES = {
    "richardson.cu": {0: "staging (each channel)", 1: "r = b - A x0",
                      2: "sweeps", 3: "tile: outputs, faces",
                      4: "Poisson rhs", 5: "block sums"},
    "forcing.cu": {14: "prologue: copies issued", 15: "prologue: windows",
                   10: "barrier before a plane", 11: "staging, column loads",
                   12: "lat / lon face fluxes", 13: "cell arithmetic"},
}


def k1_tiles(rk, a1, shape):
    """K1's time on other tiles (halo 2) than its plan's."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import richardson as k1

    default = rk.plan
    for tile in ((8, 8, 32), (8, 8, 16), (4, 8, 32), (4, 16, 32), (8, 4, 32),
                 (4, 8, 16)):
        grid = tuple(-(-n // t) for n, t in zip(shape, tile))
        ps = (k1.PassPlan(rk.iters_u, rk.iters_T, 2, tile, grid,
                          k1.shared_bytes(tile, 2, 4)),)
        rk.plan = lambda dtype, ps=ps: ps
        print(f"  {tile}: {ps[0].n_blocks} blocks, {ps[0].smem_bytes} bytes "
              f"of shared memory, {time_ms(lambda: rk(*a1)):.4f} ms",
              flush=True)
    rk.plan = default


def probe_cycles(src, fn, blocks, calls=20):
    """Cycles per block per call in each probe phase of ``src`` over
    ``calls`` calls of fn (a -DK_PROBE build), printed."""
    import torch
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl

    lib = kl.library(src)
    fn()
    torch.cuda.synchronize()
    lib.probe_zero()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    h = (ctypes.c_ulonglong * 32)()
    lib.probe_read(h)
    names = PHASES[src]
    per = {k: h[k] / calls / blocks for k in names}
    total = sum(per.values())
    print(f"{src}: {blocks} blocks, cycles per block per call {total:.0f}:")
    for k, name in names.items():
        print(f"  {name:30s} {per[k]:9.0f}  {per[k] / total:6.1%}")


def shard_call(mesh_shape, sl):
    """K2o (K2mo with ``sl``) on shard (0, 0) of the bench model on a mesh
    of the card: (wrapper, a call of it)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh, shard_state
    from dycoreplanet_tpu_torch.parallel.sharded_pallas import forcing_halos

    p = bench_params(BENCH_SHAPE)
    if sl:
        p.numerics.temperature_advection = "semi-lagrangian"
    dev = torch.device("cuda")
    A, B = mesh_shape
    m = BoussinesqModel(p, device=dev).prepare_sharded(
        Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon")))
    sh = shard_state(seed_developed_flow(m), m.geo, m._mesh.mesh)
    kf = m._mesh.forcing.kern
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, m._mesh.mesh,
                          advect_T=kf.advect_T)
    args = (sh.u[0, 0], tuple(f[0, 0] for f in sh.u_faces), sh.T[0, 0],
            sh.p[0, 0], m._scalar(BENCH_DT), halos[0, 0], (0, 0))
    kf.call_operands(*args)       # built and bound before any timing
    torch.cuda.synchronize()
    return kf, lambda: kf.call_operands(*args)


def chunk_plan(kf, rs):
    """Patch the operands launch plan to ``rs`` planes a block (None: back
    to the plan itself; a parent commit's wrapper reads ``plan(shape)``):
    (planes a block, blocks) of the launch."""
    import torch
    from dycoreplanet_tpu_torch.ops import forcing as k2

    name = "plan_operands" if hasattr(k2, "plan_operands") else "plan"
    if not hasattr(k2, "_probe_default"):
        k2._probe_default = getattr(k2, name)
    setattr(k2, name, k2._probe_default if rs is None
            else (lambda shape, *card, rs=rs: (rs, None)))
    nr, nl, no = kf.local_shape
    if rs is None:
        rs = (kf.operands_plan(torch.device("cuda"), torch.float32)[0]
              if name == "plan_operands" else k2.plan(kf.local_shape)[0])
    tiles = -(-nl // k2.TILE[0]) * -(-no // k2.TILE[1])
    return rs, -(-nr // rs) * tiles


def k1o_call(mesh_shape, dtype):
    """K1o on shard (0, 0) of the bench model on a mesh of the card, its
    extended operands from K2o's outputs on every shard and the halo
    exchange, as the step forms them: (wrapper, a call of it)."""
    import numpy as np
    import torch
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.parallel.halo import halo_pad
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh, build, shard_state
    from dycoreplanet_tpu_torch.parallel.sharded_pallas import forcing_halos

    dev = torch.device("cuda")
    A, B = mesh_shape
    m = BoussinesqModel(bench_params(BENCH_SHAPE, str(dtype)[6:]),
                        device=dev).prepare_sharded(
        Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon")))
    mesh = m._mesh.mesh
    sh = shard_state(seed_developed_flow(m), m.geo, mesh)
    kf, kr = m._mesh.forcing.kern, m._mesh.richardson.kern
    dt = m._scalar(BENCH_DT)
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh)
    _, nl, no = kr.local_shape
    out2 = {(a, b): kf.call_operands(
        u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b], sh.p[a, b], dt,
        halos[a, b], (a * nl, b * no)) for (a, b), u in sh.u.items()}
    st5 = build(mesh, lambda a, b: torch.cat(
        [out2[a, b][0], out2[a, b][1][None], sh.T[a, b][None]]))
    st5 = halo_pad(st5, mesh, "lon", 3, width=kr.GH, periodic=True)
    st5 = halo_pad(st5, mesh, "lat", 2, width=kr.GH, periodic=False)
    e = st5[0, 0]
    args = (e[:3], e[3], e[4], dt, (0, 0))
    kr.call_operands(*args)       # built and bound before any timing
    torch.cuda.synchronize()
    return kr, lambda: kr.call_operands(*args)


def k1o_force(kr, plan):
    """Launch K1o under ``plan`` (a PassPlan; None: its own plan)."""
    from dycoreplanet_tpu_torch.ops import richardson as k1

    if not hasattr(k1, "_probe_default"):
        k1._probe_default = k1.plan_operands
    k1.plan_operands = (k1._probe_default if plan is None
                        else (lambda *card, plan=plan: plan))
    kr._card.clear()


def k1o_blocks(kr, dtype):
    """(plan text, blocks) of K1o's own launch (a parent commit: the
    whole-grid plan on the shard)."""
    import torch
    from dycoreplanet_tpu_torch.ops import richardson as k1

    if not hasattr(k1, "plan_operands"):
        ps = kr.plan(dtype)[0]
        return f"tile {ps.tile}", ps.n_blocks
    ps, slots = kr.operands_plan(torch.device("cuda"), dtype)
    return f"tile {ps.tile}, {slots} resident blocks", ps.n_blocks


def k1o_sweep():
    """K1o by tile at the bench's shards, f32 and f64."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl
    from dycoreplanet_tpu_torch.ops import richardson as k1

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        itemsize = torch.finfo(dtype).bits // 8
        for mesh_shape in ((2, 2), (2, 4)):
            kr, run = k1o_call(mesh_shape, dtype)
            what, blocks = k1o_blocks(kr, dtype)
            print(f"K1o {mesh_shape[0]}x{mesh_shape[1]} shard "
                  f"{kr.local_shape} {dtype}: the plan {what}, {blocks} "
                  f"blocks, {time_ms(run):.4f} ms", flush=True)
            if not hasattr(k1, "plan_operands"):
                continue
            ps = kr.operands_plan(torch.device("cuda"), dtype)[0]
            seen = set()
            for t in k1.TILES:
                tile = tuple(min(a, n) for a, n in zip(t, kr.local_shape))
                if tile in seen:
                    continue
                seen.add(tile)
                grid = tuple(-(-n // a) for n, a in zip(kr.local_shape, tile))
                smem = k1.shared_bytes(tile, kr.GH, itemsize, operands=True)
                if smem > kl.SMEM_PER_BLOCK - k1.SMEM_STATIC:
                    continue
                plan = k1.PassPlan(kr.iters_u, kr.iters_T, kr.GH, tile, grid,
                                   smem)
                k1o_force(kr, plan)
                res = sms * kr.occupancy(dtype, smem)
                mark = "  <- the plan" if tile == ps.tile else ""
                print(f"  {str(tile):12s} {plan.n_blocks:6d} blocks, "
                      f"{smem:6d} bytes, {res:3d} resident: "
                      f"{time_ms(run):.4f} ms{mark}", flush=True)
            k1o_force(kr, None)


def operands():
    """K2o / K2mo by radial chunk at the bench's shards, and K2o's probe
    cycles at the 2x4 shard under the launch plan; K1o by tile, and its
    probe cycles at the 2x4 shard under its plan."""
    import torch
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for sl, name in ((False, "K2o"), (True, "K2mo")):
        for mesh_shape in ((2, 2), (2, 4)):
            kf, run = shard_call(mesh_shape, sl)
            occ = (kf.occupancy(torch.float32)
                   if hasattr(kf, "operands_plan") else None)
            rs0, blocks0 = chunk_plan(kf, None)
            print(f"{name} {mesh_shape[0]}x{mesh_shape[1]} shard "
                  f"{kf.local_shape} f32, {sms} SMs x {occ} resident "
                  f"blocks: the plan's RS {rs0} ({blocks0} blocks) "
                  f"{time_ms(run):.4f} ms", flush=True)
            for rs in OPS_CHUNKS:
                _, blocks = chunk_plan(kf, rs)
                print(f"  RS {rs:2d}: {blocks:4d} blocks, "
                      f"{time_ms(run):.4f} ms", flush=True)
            chunk_plan(kf, None)
    k1o_sweep()
    kl.use_macros("K_PROBE")
    kf, run = shard_call((2, 4), False)
    rs, blocks = chunk_plan(kf, None)
    print(f"K2o 2x4 shard under the plan (RS {rs}):")
    probe_cycles("forcing.cu", run, blocks)
    kr, run = k1o_call((2, 4), torch.float32)
    what, blocks = k1o_blocks(kr, torch.float32)
    print(f"K1o 2x4 shard under the plan ({what}):")
    probe_cycles("richardson.cu", run, blocks)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--operands-only", action="store_true")
    ap.add_argument("--root", default=ROOT)
    opts = ap.parse_args()
    sys.path.insert(0, os.path.abspath(opts.root))
    import torch

    if not torch.cuda.is_available():
        print("probe_k1_k2: needs a CUDA card", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    if opts.operands_only:
        operands()
        return 0
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import forcing as k2
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl

    m = BoussinesqModel(bench_params(BENCH_SHAPE), device="cuda")
    s = seed_developed_flow(m)
    fk, rk = m._forcing, m._richardson
    a2 = (s.u, s.u_faces, s.T, s.p, BENCH_DT)
    g2 = fk(*a2)
    kT = m._scalar(m.dtype.type(BENCH_DT) * m.dtype.type(m.one_over_Pe))
    a1 = (g2[0], m._vol_t * g2[1] + kT * m._T_lap_offset_t, s.T, BENCH_DT)
    run2 = lambda: fk(*a2)  # noqa: E731

    print("K2 by radial chunk (planes a block marches over):")
    default_plan = k2.plan
    for rs in (4, 8, 16, 32):
        k2.plan = lambda shape, rs=rs: (rs, None)
        print(f"  {rs:3d} planes: {time_ms(run2):.4f} ms", flush=True)
    k2.plan = default_plan
    print("K1 by tile (radial, lat, lon), halo 2; (8, 8, 32) on the "
          "compile-time instance:")
    k1_tiles(rk, a1, BENCH_SHAPE)
    # a new model's wrappers bind the libraries of the new macros
    kl.use_macros("K1_RUNTIME_TILE")
    rk = BoussinesqModel(bench_params(BENCH_SHAPE), device="cuda")._richardson
    print("K1 by tile, every tile on the run-time-tiled instance:")
    k1_tiles(rk, a1, BENCH_SHAPE)

    kl.use_macros("K_PROBE")
    m = BoussinesqModel(bench_params(BENCH_SHAPE), device="cuda")
    fk, rk = m._forcing, m._richardson
    run1, run2 = (lambda: rk(*a1)), (lambda: fk(*a2))
    blocks = {"richardson.cu": rk.plan(torch.float32)[0].n_blocks}
    _, grid = k2.plan(BENCH_SHAPE)
    blocks["forcing.cu"] = grid[0] * grid[1] * grid[2]
    for src, fn in (("richardson.cu", run1), ("forcing.cu", run2)):
        probe_cycles(src, fn, blocks[src])
    kl.use_macros()
    operands()
    return 0


if __name__ == "__main__":
    sys.exit(main())
