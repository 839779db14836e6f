#!/usr/bin/env python3
"""Where the tiled kernels K1 (csrc/richardson.cu) and K2 (csrc/forcing.cu)
spend their time on the card, at the bench shape (32x128x256 f32, seeded
developed flow).

    python3 scripts/probe_k1_k2.py

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
    and the instruction slots the other blocks of the SM take meanwhile.
Needs one CUDA card; exits non-zero without one.
"""

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the probe ids of csrc/richardson.cu and csrc/forcing.cu, by phase
PHASES = {
    "richardson.cu": {0: "staging (each channel)", 1: "r = b - A x0",
                      2: "sweeps", 3: "tile: outputs, faces",
                      4: "Poisson rhs", 5: "block sums"},
    "forcing.cu": {10: "barrier before a plane", 11: "staging, column loads",
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_k1_k2: needs a CUDA card", file=sys.stderr)
        return 1
    from dycoreplanet_tpu_torch.diagnostics.device_time import time_ms
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_DT, BENCH_SHAPE, bench_params, seed_developed_flow)
    from dycoreplanet_tpu_torch.ops import forcing as k2
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl

    print(torch.cuda.get_device_name(0), flush=True)
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
        lib = kl.library(src)
        fn()
        torch.cuda.synchronize()
        lib.probe_zero()
        calls = 20
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        h = (ctypes.c_ulonglong * 32)()
        lib.probe_read(h)
        names = PHASES[src]
        per = {k: h[k] / calls / blocks[src] for k in names}
        total = sum(per.values())
        print(f"{src}: {blocks[src]} blocks, cycles per block per call "
              f"{total:.0f}:")
        for k, name in names.items():
            print(f"  {name:30s} {per[k]:9.0f}  {per[k] / total:6.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
