"""Command-line entry point of the PyTorch port:

    python -m dycoreplanet_tpu_torch -p parameters.prm

Counterpart of the JAX package's ``cli/main.py`` (reference executable:
source/main.cxx:20-159): ``-p`` parameter file (a template is written
and the run aborts if it is missing), the dimensionless-number table,
per-step diagnostics and timer summaries, catch-all error reporting,
and the VTK time series (a ``.vts`` file at step 0 and after every step
or chunk, and the ``.pvd`` collection) in the prm's ``dirname output``.
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions.
``--chunk N`` advances N steps per ``multi_step`` call (a CUDA graph on
the card when dt is fixed) and pulls the chunk's diagnostics to the host
in one copy. ``--write-mesh`` writes ``mesh.vts``, ``--checkpoint-every
N`` a checkpoint every N steps, ``--restart FILE`` resumes from one
(counting steps, time and dt from 0 and the prm's ``time step`` again,
as the JAX CLI does), ``--profile DIR`` writes a torch.profiler trace
into DIR, and ``solver diagnostics level`` >= 3 prints each solve's
residual trail (``BoussinesqModel.step_verbose``). The checkpoints and
the trails work per step: with ``--chunk`` they are refused.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


def print_parameter_info(params, model) -> None:
    """Dimensionless-number table (reference: print_paramter_info,
    boussinesq_model.tpp:1701-1776)."""
    from dycoreplanet_tpu_torch.base import nondim

    ref = params.reference_quantities
    pc = params.physical_constants
    rows = [
        ("Reference velocity", f"{ref.velocity} m/s"),
        ("Reference length", f"{ref.length} m"),
        ("Reference time", f"{ref.time} s"),
        ("Reference temperature", f"{ref.temperature_ref} K"),
        ("Temperature change", f"{ref.temperature_change} K"),
        ("Reynolds number", f"{nondim.reynolds_number(ref.velocity, ref.length, pc.kinematic_viscosity):.6g}"),
        ("Peclet number", f"{nondim.peclet_number(ref.velocity, ref.length, pc.thermal_diffusivity):.6g}"),
        ("Rossby number", f"{nondim.rossby_number(ref.length, pc.omega, ref.velocity):.6g}"),
        ("Reference acceleration", f"{nondim.reference_acceleration(ref.length, ref.velocity):.6g}"),
        ("Grashoff number", f"{nondim.grashoff_number(params.space_dimension, pc.gravity_constant, pc.expansion_coefficient, ref.temperature_change, ref.length, pc.kinematic_viscosity):.6g}"),
        ("Prandtl number", f"{nondim.prandtl_number(pc.kinematic_viscosity, pc.thermal_diffusivity):.6g}"),
        ("Rayleigh number", f"{nondim.rayleigh_number(params.space_dimension, pc.gravity_constant, pc.expansion_coefficient, ref.temperature_change, ref.length, pc.kinematic_viscosity, pc.thermal_diffusivity):.6g}"),
        ("Geometry", model.geo.kind),
        ("Grid cells", " x ".join(str(n) for n in model.geo.cell_shape)),
        ("Formulation",
         ("FEEC mimetic (staggered C-grid)"
          if params.numerics.feec_formulation == "staggered"
          else "FEEC (rotational, coupled 3x3)")
         if params.use_FEEC_solver else "standard (advective)"),
        ("Device", str(model.device)),
        ("Time step", f"{params.time_step}"),
        ("Final time", f"{params.final_time}"),
    ]
    width = max(len(k) for k, _ in rows)
    print("+" + "-" * (width + 30) + "+")
    for k, v in rows:
        print(f"| {k.ljust(width)} : {v.ljust(25)} |")
    print("+" + "-" * (width + 30) + "+")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dycoreplanet_tpu_torch",
        description="Rotating Boussinesq dynamical core on PyTorch/CUDA")
    parser.add_argument("-p", "--parameter-file", required=True,
                        help="deal.II-style .prm parameter file")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="cap the number of time steps (debug)")
    parser.add_argument("--no-output", action="store_true",
                        help="skip VTK output")
    parser.add_argument("--chunk", type=int, default=1,
                        help="steps per multi_step chunk (one CUDA graph "
                             "replay on the card when dt is fixed)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run "
                             "(CPU, and CUDA on the card) into DIR when "
                             "it ends; meant for short runs, as every "
                             "event is held until then")
    parser.add_argument("--write-mesh", action="store_true",
                        help="dump the mesh (volumes/diameters/shards) "
                             "to <output>/mesh.vts before running "
                             "(reference: write_mesh_vtu)")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="write a checkpoint every N steps (0 = off; "
                             "per step, without --chunk)")
    parser.add_argument("--restart", default=None,
                        help="checkpoint file to resume from")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs "
                             "the kernels' plain versions)")
    args = parser.parse_args(argv)

    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.base.prm import ParameterFileError

    try:
        params = Parameters.from_file(args.parameter_file)
    except ParameterFileError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if args.chunk > 1 and args.checkpoint_every:
        # the JAX CLI saves nothing here, silently
        print("ERROR: --checkpoint-every works per step, without --chunk "
              "(ROADMAP.md: VTK output and checkpoints)", file=sys.stderr)
        return 1
    if args.chunk > 1 and params.solver_diagnostics_print_level >= 3:
        # the JAX CLI prints no trails here
        print("ERROR: the solver residual trails (solver diagnostics "
              "level >= 3) work per step, without --chunk (ROADMAP.md: VTK "
              "output and checkpoints)", file=sys.stderr)
        return 1

    try:
        if params.use_FEEC_solver and params.space_dimension == 2:
            raise ValueError(
                "FEEC solver untested in 2D. Aborting. "
                "(reference parity: source/main.cxx:100-104)")
        if params.use_direct_solver:
            raise ValueError(
                "no direct solver implemented. Aborting. "
                "(reference parity: boussinesq_model.tpp:1886-1894 throws)")
        return _run(params, args)
    except Exception as exc:  # reference main.cxx:128-156 catch-all
        print("----------------------------------------------------",
              file=sys.stderr)
        print(f"Exception on processing: {exc}\nAborting!", file=sys.stderr)
        return 1


def _device_count(device) -> int:
    """The devices a run on ``device`` could be cut over (the shards of
    ``--write-mesh``'s map): every card on CUDA, one CPU."""
    import torch

    return torch.cuda.device_count() if device.type == "cuda" else 1


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """A torch.profiler trace of the block (CPU, and CUDA on the card),
    exported into ``trace_dir`` when the block ends or raises."""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")


def _run(params, args) -> int:
    import socket

    import torch

    from dycoreplanet_tpu_torch.base import dtypes
    from dycoreplanet_tpu_torch.diagnostics.timers import TimerRegistry
    from dycoreplanet_tpu_torch.io.checkpoint import load_checkpoint
    from dycoreplanet_tpu_torch.io.vtk import (
        write_mesh_vts, write_pvd, write_vts)
    from dycoreplanet_tpu_torch.models import make_model
    from dycoreplanet_tpu_torch.parallel.mesh import mesh_shape_for

    timers = TimerRegistry()
    with timers.scope("setup: geometry + model"):
        model = make_model(params, device=args.device)
    if params.hello_from_cluster:
        name = (torch.cuda.get_device_name(model.device)
                if model.device.type == "cuda" else "cpu")
        print(f"Hello from {socket.gethostname()} device 0: {name} "
              f"({model.device.type})")
    print_parameter_info(params, model)
    with timers.scope("setup: initial state"):
        if args.restart:
            state, _ = load_checkpoint(args.restart, model.device)
            print(f"Restarted from {args.restart} at step "
                  f"{state.step_number}")
        else:
            state = model.initial_state()

    # each writer creates the output directory; a run with --no-output
    # and nothing else to write leaves none behind
    outdir = params.dirname_output
    if args.write_mesh:
        print("Writing mesh to", os.path.join(outdir, "mesh.vts"))
        write_mesh_vts(os.path.join(outdir, "mesh.vts"), model.geo,
                       shard_map_shape=mesh_shape_for(
                           model.geo, _device_count(model.device)))
    pvd_entries = []

    def output(state, time_index: float, step: int) -> None:
        if args.no_output:
            return
        with timers.scope("output: vtk"):
            # one device-to-host copy of u, p and T (bfloat16 widened to
            # float32, as the file stores them)
            dim = model.geo.dim
            cells = model.geo.cell_shape
            ncell = int(np.prod(cells))
            flat = dtypes.to_numpy(torch.cat([
                state.u.reshape(-1), state.p.reshape(-1),
                state.T.reshape(-1)]))
            u = flat[:dim * ncell].reshape((dim,) + cells)
            p = flat[dim * ncell:(dim + 1) * ncell].reshape(cells)
            T = flat[(dim + 1) * ncell:].reshape(cells)
            # under the hydrostatic split the dynamic pressure excludes
            # the background; write the reference-comparable total too
            scalars = {"pressure": p, "temperature": T}
            if params.numerics.buoyancy == "perturbation":
                scalars["pressure_total"] = p + model.p_hydro
            fname = f"{params.filename_output}_{step:06d}.vts"
            write_vts(os.path.join(outdir, fname), model.geo,
                      scalars=scalars, vectors={"velocity": u})
            pvd_entries.append({"time": time_index, "file": fname})
            write_pvd(os.path.join(outdir, f"{params.filename_output}.pvd"),
                      pvd_entries)

    output(state, 0.0, 0)
    with _profiled(args.profile, model.device):
        run = _run_chunked if args.chunk > 1 else _run_steps
        rc = run(params, args, model, state, timers, output)
    print("----------------------------------------")
    print(timers.summary())
    return rc


def _run_steps(params, args, model, state, timers, output) -> int:
    """The reference-style loop: one step, its diagnostics, output and
    checkpoint at a time."""
    import torch

    from dycoreplanet_tpu_torch.io.checkpoint import save_checkpoint

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    dt = params.time_step
    time_index = 0.0
    n = 0
    while time_index <= params.final_time:
        if args.max_steps is not None and n >= args.max_steps:
            break
        print("----------------------------------------")
        print(f"Time step {n}:  t={time_index:.6g} -> t={time_index + dt:.6g}"
              f"  (dt={dt:.6g} | final time={params.final_time})")
        with timers.scope("step: NSE + temperature solve"):
            hists = None
            if params.solver_diagnostics_print_level >= 3:
                # per-iteration solver residual trails (the reference's
                # deallog histories, main.cxx:89-90)
                state, diag, hists = model.step_verbose(state, dt)
            else:
                state, diag = model.step(state, dt)
            sync()
        if hists:
            for name in sorted(hists):
                trail = hists[name]
                trail = trail[~np.isnan(trail)]
                txt = "  ".join(f"{r:.3e}" for r in trail)
                print(f"   [{name}] ||r|| trail ({trail.size} its): {txt}")
        print(f"   Max of local CFL numbers: {float(diag.cfl):.6g}")
        print(f"   Max velocity (dimensionless): {float(diag.max_velocity):.6g}")
        print(f"   Max velocity (with dimensions): "
              f"{float(diag.max_velocity) * params.reference_quantities.velocity:.6g} m/s")
        print(f"   Temperature range: [{float(diag.T_min):.6g}, {float(diag.T_max):.6g}]")
        print(f"   Solver iterations: helmholtz={diag.helmholtz_iters.tolist()} "
              f"poisson={int(diag.poisson_iters)} temperature={int(diag.temperature_iters)}")
        if params.solver_diagnostics_print_level >= 2:
            def _res(v):
                v = float(v)
                return "unchecked" if v < 0 else f"{v:.3e}"

            print(f"   Solver residuals: "
                  f"helmholtz={_res(diag.helmholtz_residual)} "
                  f"poisson={_res(diag.poisson_residual)} "
                  f"temperature={_res(diag.temperature_residual)}")
        print(f"   Post-projection max |div u|: {float(diag.div_norm):.3g}")

        time_index += dt / params.NSE_solver_interval
        n += 1
        output(state, time_index, n)
        if args.checkpoint_every and n % args.checkpoint_every == 0:
            with timers.scope("output: checkpoint"):
                save_checkpoint(
                    os.path.join(params.dirname_output,
                                 f"{params.filename_output}_ckpt_{n:06d}"),
                    state, {"time_index": time_index, "dt": dt})
        if params.adapt_time_step and n % params.NSE_solver_interval == 0:
            dt = model.compute_time_step(float(diag.cfl))
            print(f"   New time step (dimensionless): {dt:.6g}")
            print(f"   New time step (with dimensions): "
                  f"{dt * params.reference_quantities.time:.6g} s")
        if n % max(params.NSE_solver_interval, 10) == 0:
            print(timers.summary())
    return 0


def _run_chunked(params, args, model, state, timers, output) -> int:
    """``--chunk N`` steps per ``multi_step`` call, with adaptive dt and
    NSE-interval sub-cycling inside the chunk: one device->host copy of
    the chunk's diagnostics replaces the per-step reads of the
    reference-style loop (the JAX package's ``_run_chunked``). Output is
    written after every chunk, from the state multi_step returns (on a
    graph replay, copies of the graph's outputs)."""
    from dycoreplanet_tpu_torch.models.boussinesq import StepDiagnostics

    dt = params.time_step
    time_index = 0.0
    n = 0
    while time_index <= params.final_time:
        chunk = args.chunk
        if args.max_steps is not None:
            chunk = min(chunk, args.max_steps - n)
            if chunk <= 0:
                break
        with timers.scope("step: NSE + temperature solve (chunked)"):
            # multi_step redoes the chunk with full CG if any
            # fixed-iteration solve missed its tolerance (reference
            # NoConvergence retry, tpp:1203-1232)
            state, packed, dt_out = model.multi_step(
                state, dt, chunk, collect_diagnostics=True,
                adaptive=params.adapt_time_step)
            rows = packed.cpu().numpy()       # one copy for the chunk
        for j in range(chunk):
            d = StepDiagnostics(rows[j], model.geo.dim)
            print("----------------------------------------")
            print(f"Time step {n + j} "
                  f"(dt carried in the chunk | final time={params.final_time})")
            print(f"   Max of local CFL numbers: {d.cfl:.6g}")
            print(f"   Max velocity (dimensionless): {d.max_velocity:.6g}")
            print(f"   Temperature range: [{d.T_min:.6g}, {d.T_max:.6g}]")
            print(f"   Post-projection max |div u|: {d.div_norm:.3g}")
        dt = float(dt_out)
        time_index = float(state.time)
        n += chunk
        output(state, time_index, n)
        if params.adapt_time_step:
            print(f"   New time step (dimensionless): {dt:.6g}")
        print(timers.summary())
    return 0
