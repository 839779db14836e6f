"""Command-line entry point of the PyTorch port:

    python -m dycoreplanet_tpu_torch -p parameters.prm --no-output

Counterpart of the JAX package's ``cli/main.py`` (reference executable:
source/main.cxx:20-159): ``-p`` parameter file (a template is written
and the run aborts if it is missing), the dimensionless-number table,
per-step diagnostics and timer summaries, catch-all error reporting.
Runs on the GPU; ``--device cpu`` runs the kernels' plain versions.
VTK output, checkpoints and ``--chunk`` are not ported yet and refused
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import sys


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
        ("Formulation", "standard (advective)"),
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
                        help="skip VTK output (required: not ported yet)")
    parser.add_argument("--chunk", type=int, default=1,
                        help="steps per on-device chunk (not ported yet)")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="checkpoint every N steps (not ported yet)")
    parser.add_argument("--restart", default=None,
                        help="checkpoint to resume from (not ported yet)")
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
    if not args.no_output:
        print("ERROR: VTK output not yet ported (ROADMAP.md: VTK output "
              "and checkpoints); run with --no-output", file=sys.stderr)
        return 1
    if args.checkpoint_every or args.restart:
        print("ERROR: checkpoints not yet ported (ROADMAP.md: VTK output "
              "and checkpoints)", file=sys.stderr)
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
        if args.chunk > 1:
            raise NotImplementedError(
                "not ported yet (ROADMAP.md: multi_step / --chunk)")
        return _run(params, args)
    except Exception as exc:  # reference main.cxx:128-156 catch-all
        print("----------------------------------------------------",
              file=sys.stderr)
        print(f"Exception on processing: {exc}\nAborting!", file=sys.stderr)
        return 1


def _run(params, args) -> int:
    import socket

    import torch

    from dycoreplanet_tpu_torch.diagnostics.timers import TimerRegistry
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    timers = TimerRegistry()
    with timers.scope("setup: geometry + model"):
        model = BoussinesqModel(params, device=args.device)
    if params.hello_from_cluster:
        name = (torch.cuda.get_device_name(model.device)
                if model.device.type == "cuda" else "cpu")
        print(f"Hello from {socket.gethostname()} device 0: {name} "
              f"({model.device.type})")
    print_parameter_info(params, model)
    with timers.scope("setup: initial state"):
        state = model.initial_state()

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
            state, diag = model.step(state, dt)
            sync()
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
        if params.adapt_time_step and n % params.NSE_solver_interval == 0:
            dt = model.compute_time_step(float(diag.cfl))
            print(f"   New time step (dimensionless): {dt:.6g}")
            print(f"   New time step (with dimensions): "
                  f"{dt * params.reference_quantities.time:.6g} s")
        if n % max(params.NSE_solver_interval, 10) == 0:
            print(timers.summary())

    print("----------------------------------------")
    print(timers.summary())
    return 0
