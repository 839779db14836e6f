#!/usr/bin/env python3
"""The port's mesh over several processes: the counterpart of
scripts/multihost_smoke.py for dycoreplanet_tpu_torch.

Run one process a card (NCCL), or N processes on the CPU (gloo):

    torchrun --nproc-per-node N scripts/torch_multihost_smoke.py
    torchrun --nproc-per-node 2 scripts/torch_multihost_smoke.py \\
        --device cpu --backend gloo

or start N processes with RANK, WORLD_SIZE and LOCAL_RANK set and an
``--init-method`` (``file://...`` or ``tcp://localhost:PORT``). Ranks
that share one card pass ``--device cuda:0 --backend gloo`` (NCCL
refuses two ranks of one communicator on one GPU).

Without ``--check`` it builds the mesh over every rank (one shard
each), runs one sharded step of the flagship shell
(``entry._make_model("float32", (8, 32, 64))``, as the JAX script does)
and prints, on every rank, ``[rank r/W] ...`` with max|u| and the
divergence, both asserted finite.

``--check NAME[,NAME...] --out DIR`` runs the named mesh paths of
``PATHS`` instead: rank 0 writes the gathered states and packed
diagnostic rows to ``DIR/results.npz``, and every rank its own record
(its comm ledger of one step, its escalations, its kernel launches,
host and device ms) to ``DIR/rank{r}.json``. With ``--single`` (no
process group, no rendezvous) one process runs the same paths on the
single-controller mesh of the same shards and writes them as rank 0:
the reference that tests/test_torch_dist.py holds the ranks to, from a
process started as theirs are (chip_smoke.py runs ``run_path`` in its
own process). With ``--checkpoint`` each path's final state is also
written as a sharded checkpoint and as sharded .vts pieces with a .pvts
(each rank its own shards, rank 0 the masters) under ``DIR/ckpt``, and
restored onto the same mesh.

Imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DT = 0.01
SMALL = (8, 8, 16)          # the shell of tests/test_torch_sharded.py
ODD = (8, 8, 24)            # a shell whose lon divides into 3 shards
KRYLOV_CAP = 4              # mg and FEEC 3x3: CG / outer iterations
ANNULUS_PRM = "aqua_planet_test_2d.prm"


def _set(p, **over):
    """Set parameters by dotted name ("numerics.x") or on p itself."""
    for k, v in over.items():
        obj = p
        *path, last = k.split(".")
        for name in path:
            obj = getattr(obj, name)
        setattr(obj, last, v)
    return p


def shell_params(p, dtype="float64", shape=SMALL, **over):
    """The shell of the port's mesh tests on ``p`` (``Parameters.
    from_text("")`` of either package: only attributes are set): R0 = 1,
    R1 = 3, unit reference quantities, Omega 0.7, MUSCL, 2 fixed
    Richardson sweeps of temperature, dt 0.01; ``over`` on top."""
    p.space_dimension = 3
    p.cuboid_geometry = False
    p.numerics.dtype = dtype
    p.numerics.advection_scheme = "muscl"
    p.numerics.fixed_solver_iters = 2
    p.numerics.momentum_fixed_iters = 0
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.omega = 0.7
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    p.time_step = DT
    return _set(p, **over)


def annulus_params(p, **over):
    """The annulus of the port's mesh tests (8 x 48, f64)."""
    p.space_dimension = 2
    p.numerics.dtype = "float64"
    p.numerics.n_radial, p.numerics.n_lon = 8, 48
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.physical_constants.__post_init__()
    p.reference_quantities.__post_init__()
    p.time_step = DT
    return _set(p, **over)


def box_params(p, **over):
    """The standard personality's 8^3 walled box (f64)."""
    p.space_dimension = 3
    p.cuboid_geometry = True
    p.use_FEEC_solver = False
    p.numerics.dtype = "float64"
    p.numerics.nx = p.numerics.ny = p.numerics.nz = 8
    p.physical_constants.expansion_coefficient = 0.2
    p.reference_quantities.temperature_ref = 3.0
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.physical_constants.__post_init__()
    p.reference_quantities.__post_init__()
    p.time_step = DT
    return _set(p, **over)


def flagship_params(p=None, dtype="float32"):
    """The bench configuration at 32 x 128 x 256 (models/presets.py)."""
    from dycoreplanet_tpu_torch.models.presets import (
        BENCH_SHAPE, bench_params)
    return bench_params(BENCH_SHAPE, dtype)


def annulus_work_params(p=None, **numerics):
    """data/aqua_planet_test_2d.prm at refinement 8 (256 x 3072), f32."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    p = Parameters.from_file(os.path.join(ROOT, "data", ANNULUS_PRM))
    p.initial_global_refinement = 8
    p.numerics.dtype = "float32"
    for k, v in numerics.items():
        setattr(p.numerics, k, v)
    return p


# name -> (parameters on a fresh Parameters, shards of the mesh, steps,
# drive): drive "step" runs model.step, "chunk" one multi_step chunk,
# "run" model.run, "escalate" a forced miss in run and in a chunk
PATHS = {
    "default": (lambda p: shell_params(p), 4, 2, "step"),
    "default32": (lambda p: shell_params(p, "float32"), 4, 2, "step"),
    "sl2": (lambda p: shell_params(
        p, **{"numerics.temperature_advection": "semi-lagrangian",
              "NSE_solver_interval": 2}), 4, 2, "chunk"),
    "direct": (lambda p: shell_params(
        p, **{"numerics.helmholtz_solver": "direct"}), 4, 2, "step"),
    "escalate": (lambda p: shell_params(
        p, time_step=0.1, **{"numerics.helmholtz_tol": 1e-300}), 4, 3,
        "escalate"),
    "mimetic": (lambda p: shell_params(
        p, use_FEEC_solver=True,
        **{"numerics.feec_formulation": "staggered"}), 4, 2, "step"),
    "mg": (lambda p: shell_params(
        p, **{"numerics.poisson_solver": "mg",
              "numerics.max_cg_iters": KRYLOV_CAP}), 4, 1, "step"),
    "feec": (lambda p: shell_params(
        p, use_FEEC_solver=True,
        **{"numerics.max_cg_iters": KRYLOV_CAP}), 4, 1, "step"),
    "box": (lambda p: box_params(p), 4, 2, "step"),
    "annulus": (lambda p: annulus_params(p), 4, 2, "step"),
    "odd": (lambda p: shell_params(p, shape=ODD), 6, 2, "step"),
    "odd_sl": (lambda p: shell_params(
        p, shape=ODD,
        **{"numerics.temperature_advection": "semi-lagrangian"}), 6, 2,
        "step"),
    # at work size, on the card (chip_smoke.py phase 17)
    "flagship": (flagship_params, 4, 5, "run"),
    "annulus_direct": (lambda p: annulus_work_params(
        helmholtz_solver="direct"), 4, 3, "run"),
}


def make_model(name, device):
    """The port's model of path ``name`` on ``device``."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import make_model as mk
    return mk(PATHS[name][0](Parameters.from_text("")), device=device)


def seeded(model):
    """The path's first state, global, on the model's device: the seeded
    flow of the port's mesh tests on the small shells (u 0.1 N(0, 1), p
    0.01 N(0, 1), T the model's initial T, the faces interpolated), the
    bench's developed flow on the flagship, the initial state elsewhere;
    the same on every process."""
    import numpy as np

    from dycoreplanet_tpu_torch.models.convert import state_from_numpy
    from dycoreplanet_tpu_torch.models.presets import seed_developed_flow
    geo = model.geo
    if geo.kind != "shell":
        return model.initial_state()
    if geo.cell_shape[0] >= 32:
        return seed_developed_flow(model)
    rng = np.random.default_rng(5)
    shape = geo.cell_shape
    u = 0.1 * rng.standard_normal((3,) + shape)
    pres = 0.01 * rng.standard_normal(shape)
    s0 = state_from_numpy(model, u, [np.zeros(shape)] * 3, pres,
                          model.T_init)
    return s0._replace(u_faces=model.interp_to_faces(s0.u))


def _host(t):
    import torch
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t
            ).detach().cpu().numpy()


def _gathered(prefix, state):
    """The global arrays of a sharded state, by name (a collective on a
    process mesh)."""
    from dycoreplanet_tpu_torch.parallel.mesh import unshard_state
    g = unshard_state(state)
    out = {f"{prefix}/u": _host(g.u), f"{prefix}/p": _host(g.p),
           f"{prefix}/T": _host(g.T)}
    for d, f in enumerate(g.u_faces):
        out[f"{prefix}/u_face_{d}"] = _host(f)
    return out


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_path(name, device, mesh_of, ckpt=None, profile=False):
    """Path ``name`` on the mesh ``mesh_of(geo)`` (one process or a
    process mesh) from ``seeded``: (arrays, record). ``arrays``: the
    gathered final state(s) and the packed diagnostic rows, by
    "name/field" (the same on every rank); ``record``: this rank's comm
    ledger of one step (the small paths) and its transport in that step
    (``parallel/dist.py`` ``stats``), its escalations, the wrappers'
    launches in the driven steps, host ms a step, the seconds of the
    model's build and of the whole path and, with ``profile``, the
    device ms of one more step; ``ckpt``: a path to write the final
    state to as a sharded checkpoint and sharded .vts pieces, restored
    onto the mesh ("restored_bitwise" in ``record``)."""
    import numpy as np

    from dycoreplanet_tpu_torch.parallel import comm_analysis as comm
    from dycoreplanet_tpu_torch.parallel import dist as pdist
    from dycoreplanet_tpu_torch.parallel.mesh import shard_state

    _, _, steps, drive = PATHS[name]
    t_path = time.perf_counter()
    model = make_model(name, device)
    mesh = mesh_of(model.geo)
    model.prepare_sharded(mesh)
    # the forced miss from the initial state at dt 0.1, as
    # tests/test_torch_sharded_cg.py forces it
    s0 = shard_state(model.initial_state() if drive == "escalate"
                     else seeded(model), model.geo, mesh)
    dt = float(model.params.time_step)
    record = {"mesh": list(mesh.grid), "shards": mesh.local_shards(),
              "build_s": time.perf_counter() - t_path}
    if drive != "escalate":
        # the ledger of one step, and this rank's transport in that step
        pdist.reset_stats()
        record["ledger"] = comm.step_comm_summary(model, s0, dt)
        record["ledger_transport"] = dict(pdist.stats)
    for k in model.kernels().values():
        k.launches = 0
    pdist.reset_stats()
    rows, marks = [], []
    _sync(device)
    t0 = time.perf_counter()
    if drive == "step":
        state = s0
        for _ in range(steps):
            state, diag = model.step(state, dt)
            rows.append(_host(diag.packed))
    elif drive == "chunk":
        state, packed, _ = model.multi_step(s0, dt, steps)
        rows = list(_host(packed))
    else:
        esc = []

        def seen(state, rec):
            _sync(device)
            marks.append(time.perf_counter())
            esc.append(model.escalations)

        state, hist = model.run(max_steps=steps, state=s0, callback=seen)
        rows = [[h[k] for k in ("cfl", "max_velocity", "T_min", "T_max",
                                "div_norm", "poisson_iters",
                                "temperature_iters")] for h in hist]
        record["escalations_by_step"] = esc
        record["strong_steps_left"] = model._strong_steps_left
    _sync(device)
    wall = time.perf_counter() - t0
    record["launches"] = {k: w.launches for k, w in model.kernels().items()}
    record["transport"] = dict(pdist.stats)
    record["host_ms_per_step"] = wall * 1e3 / steps
    if len(marks) > 1:     # from the end of the first step on
        record["host_ms_per_step_after_first"] = (
            (marks[-1] - marks[0]) * 1e3 / (len(marks) - 1))
    arrays = _gathered(name, state)
    arrays[f"{name}/rows"] = np.asarray(rows, dtype=np.float64)
    if drive == "escalate":
        # a forced miss in a multi_step chunk, from the first state
        chunk = make_model(name, device)
        chunk.prepare_sharded(mesh)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            c_state, c_rows, _ = chunk.multi_step(s0, dt, 2)
        record["chunk_escalations"] = chunk.escalations
        record["chunk_strong_steps_left"] = chunk._strong_steps_left
        record["chunk_retry_warned"] = any(
            "retrying chunk" in str(w.message) for w in caught)
        arrays.update(_gathered(f"{name}/chunk", c_state))
        arrays[f"{name}/chunk/rows"] = _host(c_rows)
    if profile:
        from dycoreplanet_tpu_torch.diagnostics.device_time import (
            device_rows, profiled)
        import torch
        _, prof = profiled(lambda: model.step(state, dt))
        got = device_rows(prof)
        record["device_ms_one_step"] = sum(ms for _, ms, _ in got)
        record["device_kernels_one_step"] = sum(c for _, _, c in got)
        # host synchronizations (device reads, the gloo staging's
        # copies) of one more step
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                model.step(state, dt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        record["host_syncs_one_step"] = sum(
            "synchroniz" in str(w.message) for w in seen)
    if ckpt is not None:
        import torch

        from dycoreplanet_tpu_torch.io.checkpoint import (
            load_checkpoint_sharded, save_checkpoint_sharded)
        from dycoreplanet_tpu_torch.io.vtk import write_vts_sharded
        save_checkpoint_sharded(ckpt, state, {"path": name})
        write_vts_sharded(ckpt + ".vts", model.geo,
                          scalars={"temperature": state.T,
                                   "pressure": state.p},
                          vectors={"velocity": state.u})
        back, _ = load_checkpoint_sharded(ckpt, geo=model.geo, mesh=mesh)
        record["restored_bitwise"] = (
            (back.time, back.step_number)
            == (float(state.time), int(state.step_number))
            and all(torch.equal(x, y)
                    for f, g in zip((back.u, back.p, back.T) + back.u_faces,
                                    (state.u, state.p, state.T)
                                    + state.u_faces)
                    for x, y in zip(f.parts(), g.parts())))
    record["path_s"] = time.perf_counter() - t_path
    return arrays, record


def _smoke(ranks):
    """One sharded step of the flagship shell over every rank, one shard
    each (the JAX script's)."""
    import numpy as np

    from dycoreplanet_tpu_torch.entry import _make_model
    from dycoreplanet_tpu_torch.parallel.mesh import build_mesh, shard_state

    model = _make_model("float32", (8, 32, 64), device=ranks.device)
    mesh = build_mesh(model.geo, [ranks.device], group=ranks.group)
    model.prepare_sharded(mesh)
    state = shard_state(model.initial_state(), model.geo, mesh)
    _, diag = model.step(state, float(model.params.time_step))
    print(f"[rank {ranks.rank}/{ranks.world}] {ranks.backend} on "
          f"{ranks.device}, mesh {dict(mesh.shape)} "
          f"(shards {mesh.local_shards()}), max|u|="
          f"{diag.max_velocity:.3e} div={diag.div_norm:.3e}", flush=True)
    assert np.isfinite(diag.max_velocity) and np.isfinite(diag.div_norm)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="this rank's device (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default nccl on a CUDA device; gloo for CPU "
                         "ranks and ranks that share a card")
    ap.add_argument("--init-method", default=None,
                    help="default env:// (MASTER_ADDR, MASTER_PORT)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a collective or receive may wait")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's CPU threads (torch.set_num_threads)")
    ap.add_argument("--check", default=None,
                    help="comma-separated names of PATHS")
    ap.add_argument("--out", default=None, help="where --check writes")
    ap.add_argument("--profile", action="store_true",
                    help="with --check: the device ms of one more step")
    ap.add_argument("--smoke", action="store_true",
                    help="with --check: the smoke step first")
    ap.add_argument("--checkpoint", action="store_true",
                    help="with --check: each path's final state as a "
                         "sharded checkpoint and .vts pieces under --out, "
                         "restored onto the mesh")
    ap.add_argument("--single", action="store_true",
                    help="with --check: the paths on one process's mesh "
                         "(no process group), the ranks' reference, as "
                         "rank 0 of a world of 1 writes it")
    args = ap.parse_args(argv)
    t_main = time.perf_counter()

    import numpy as np
    import torch

    from dycoreplanet_tpu_torch.parallel import dist as pdist
    from dycoreplanet_tpu_torch.parallel.mesh import build_mesh

    if args.threads is not None:
        torch.set_num_threads(args.threads)
    if args.single:
        if not args.check:
            raise SystemExit("--single runs --check paths")
        ranks = pdist.Ranks(None, 0, 1, torch.device(args.device or "cuda"),
                            "none")
    else:
        ranks = pdist.init_ranks(args.backend, args.device,
                                 init_method=args.init_method,
                                 timeout=args.timeout)
    try:
        if args.check and args.out is None:
            raise SystemExit("--check needs --out")
        if not args.check or args.smoke:
            _smoke(ranks)
        if not args.check:
            return
        os.makedirs(args.out, exist_ok=True)
        arrays, records = {}, {}
        for name in args.check.split(","):
            shards = PATHS[name][1]
            per = shards // ranks.world
            if per * ranks.world != shards:
                raise SystemExit(f"path {name} runs on {shards} shards, "
                                 f"not {ranks.world} x {per}")
            mesh_of = (lambda geo, per=per: build_mesh(
                geo, [ranks.device] * per, group=ranks.group))
            ckpt = (os.path.join(args.out, "ckpt", name)
                    if args.checkpoint else None)
            got, rec = run_path(name, ranks.device, mesh_of, ckpt,
                                args.profile)
            arrays.update(got)
            records[name] = rec
            ok = all(np.isfinite(a).all() for k, a in got.items()
                     if not k.endswith("rows"))
            print(f"[rank {ranks.rank}/{ranks.world}] {name}: mesh "
                  f"{rec['mesh']}, shards {rec['shards']}, finite {ok}, "
                  f"host {rec['host_ms_per_step']:.1f} ms/step", flush=True)
            if not ok:
                raise SystemExit(f"{name}: the state is not finite")
        with open(os.path.join(args.out, f"rank{ranks.rank}.json"),
                  "w") as f:
            json.dump({"rank": ranks.rank, "world": ranks.world,
                       "main_s": time.perf_counter() - t_main,
                       "backend": ranks.backend,
                       "imported_jax": any(
                           m.split(".")[0] in ("jax", "dycoreplanet_tpu")
                           for m in sys.modules),
                       "device": str(ranks.device), "paths": records}, f)
        if ranks.rank == 0:
            np.savez(os.path.join(args.out, "results.npz"), **arrays)
    finally:
        if ranks.group is not None:
            pdist.shutdown(ranks)


if __name__ == "__main__":
    main()
