#!/usr/bin/env python3
"""Weak and strong scaling tables of the port's mesh step: the
counterpart of scripts/comm_bytes.py for dycoreplanet_tpu_torch.

For 1, 2, 4 and 8 shards it runs ONE step of the canonical mesh
configuration (``entry._make_model(dtype, shape).prepare_sharded(mesh)``:
K2o and K1o on the shards, the sharded fast-diagonalization Poisson
solve with one field-sized sum) and reads its communication ledger
(``parallel/comm_analysis.py`` ``step_comm_summary``), for
  * weak scaling: the shard's grid fixed (``--per-shard``), the global
    grid growing with the mesh (``parallel/mesh.py`` ``mesh_shape_for``);
  * strong scaling: the global grid fixed (``--base``).
Every shard lies on the one card (``--device cpu``: on the CPU, the
kernels' plain versions); the tables do not depend on where the shards
lie. They show bytes only: no link time and no efficiency is modelled.

    python scripts/torch_comm_bytes.py [--device cpu] [--per-shard 16x32x64]
        [--base 16x32x64]

The tables are of the float32 step.

Imports neither JAX nor the JAX package.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PER_SHARD = (16, 32, 64)
BASE = (16, 32, 64)
SHARDS = (1, 2, 4, 8)
GATHERED = "process-mesh all-gather received"

HEADER = """\
Each cell is `count / MB` a step for one op of the JAX module's
COLLECTIVE_OPS, from the port's communication ledger: bytes are the
JAX definition, a device's receive payload once an op (a permute one
shard's block, an all-reduce one partial in the sum's dtype); counts
are of executed ops, so the fixed Richardson sweeps' exchanges count
every sweep, where the JAX module counts a loop body once. At one shard
nothing crosses a shard boundary; the sums are recorded as the JAX
module records them. The ledger is not what a process mesh moves: the
last column is the bytes a rank receives in all-gathers on a process
mesh of one shard a rank (parallel/dist.py), (n - 1) x the partial
bytes of every psum and pmax."""


def gathered_bytes(summary, shards, world=None) -> int:
    """The bytes a rank receives in all-gathers during the ledger's step
    on a process mesh of ``shards`` shards over ``world`` ranks (default
    one shard a rank): every psum and pmax all-gathers the partials of
    every other rank's shards (parallel/halo.py ``_all_partials``), the
    ledger's all-reduce bytes (one partial's) times shards - shards /
    world."""
    world = shards if world is None else world
    return (shards - shards // world) * summary["all-reduce"]["bytes"]


def _grid(shape):
    return "x".join(str(n) for n in shape)


def step_summary(shape, shards, device, dtype="float32"):
    """One mesh step of the canonical configuration at the global
    ``shape`` on ``shards`` shards, all on ``device``: (the model, the
    mesh, the ledger's summary)."""
    from dycoreplanet_tpu_torch.entry import _make_model
    from dycoreplanet_tpu_torch.parallel.comm_analysis import (
        step_comm_summary)
    from dycoreplanet_tpu_torch.parallel.mesh import (build_mesh,
                                                      mesh_shape_for,
                                                      shard_state)

    model = _make_model(dtype, shape, device=device)
    mesh = build_mesh(model.geo, [model.device] * shards)
    want = mesh_shape_for(model.geo, shards)[1:]
    if tuple(mesh.grid) != tuple(want):
        raise RuntimeError(f"{shards} shards: the model's mesh is "
                           f"{mesh.grid}, mesh_shape_for gives {want}")
    model.prepare_sharded(mesh)
    state = shard_state(model.initial_state(), model.geo, mesh)
    dt = model._scalar(model.params.time_step)
    return model, mesh, step_comm_summary(model, state, dt)


def scaling_rows(kind, size, device, dtype="float32", shards=SHARDS):
    """The rows of one table: ``kind`` "weak" (``size`` the shard's
    grid) or "strong" (``size`` the global grid). Each row: a dict of
    "shards", "grid" (global), "mesh", "summary" (the ledger) and
    "gathered" (gathered_bytes)."""
    from dycoreplanet_tpu_torch.entry import _params
    from dycoreplanet_tpu_torch.grid.factory import make_geometry
    from dycoreplanet_tpu_torch.parallel.mesh import mesh_shape_for

    rows = []
    for n in shards:
        shape = tuple(size)
        if kind == "weak":
            geo = make_geometry(_params(dtype, size))
            _, a, b = mesh_shape_for(geo, n)
            shape = (size[0], size[1] * a, size[2] * b)
        _, mesh, summary = step_summary(shape, n, device, dtype)
        rows.append({"shards": n, "grid": shape, "mesh": tuple(mesh.grid),
                     "summary": summary,
                     "gathered": gathered_bytes(summary, n)})
    return rows


def markdown(rows):
    """The JAX script's table: devices, global grid, then `count / MB`
    for each op, and the process-mesh column."""
    from dycoreplanet_tpu_torch.parallel.comm_analysis import COLLECTIVE_OPS

    head = ["devices", "global grid"] + list(COLLECTIVE_OPS) + [
        f"{GATHERED} (MB)"]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "|".join("---" for _ in head) + "|"]
    for r in rows:
        s = r["summary"]
        cells = [str(r["shards"]), _grid(r["grid"])] + [
            f"{s[op]['count']} / {s[op]['bytes'] / 1e6:.3f} MB"
            for op in COLLECTIVE_OPS] + [f"{r['gathered'] / 1e6:.3f}"]
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _shape(text):
    return tuple(int(n) for n in text.lower().split("x"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the shards lie (default: the CUDA card)")
    ap.add_argument("--per-shard", type=_shape, default=PER_SHARD,
                    help="the shard's grid of the weak table")
    ap.add_argument("--base", type=_shape, default=BASE,
                    help="the global grid of the strong table")
    args = ap.parse_args(argv)
    from dycoreplanet_tpu_torch.models.boussinesq import resolve_device
    device = resolve_device(args.device)
    weak = scaling_rows("weak", args.per_shard, device)
    strong = scaling_rows("strong", args.base, device)
    print(f"## Weak scaling (per-shard grid fixed at "
          f"{_grid(args.per_shard)}, float32)\n")
    print(HEADER + "\n")
    print(markdown(weak))
    print(f"\n## Strong scaling (global grid fixed at {_grid(args.base)}, "
          f"float32)\n")
    print(markdown(strong))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
