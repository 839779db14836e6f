#!/usr/bin/env python3
"""Where the coupled momentum solves stop meeting their tolerance: the
outer Krylov solves of one step.

    python3 scripts/probe_coupled_gate.py annulus [--refinements 4 5 6 7 8]
    python3 scripts/probe_coupled_gate.py feec [--shapes 16x64x128 32x128x256]
        [--dtype float32] [--device cpu] [--jax]

``annulus``: one step from rest of data/aqua_planet_test_2d.prm with
`momentum solver = coupled` at each `initial global refinement`, by the
prm's Schur GMRES and by the block FGMRES with its strong-preconditioner
retry. ``feec``: one step of data/aqua_planet_shell_test_3d-feec.prm's
coupled 3x3 FGMRES at each shape, dt 0.002, from the seeded developed
flow (models/presets.py). For the port it prints every outer solve:
restart, iterations, the true residual over |b| against the relative
tolerance max(tol, 16 eps), the verdict; then the step's gate and
max|div u|. ``--jax`` runs the JAX package's model instead (on the CPU;
its solves run inside the compiled step, so only the step's outer
iterations, residual, gate and max|div u| are printed); the port is not
imported then. The port runs on the card unless ``--device cpu`` is
given. The last line of standard output is one JSON object with the
rows.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
DT_FEEC = 0.002


def configs(args):
    """(label, parameter overrides) of each step to probe."""
    if args.case == "annulus":
        return [(f"refinement {r} {path}",
                 dict(refinement=r, schur=path == "schur"))
                for r in args.refinements for path in ("schur", "fgmres")]
    return [(f"{s} feec", dict(shape=tuple(int(n) for n in s.split("x"))))
            for s in args.shapes]


def params(P, case, dtype, refinement=None, schur=None, shape=None):
    if case == "annulus":
        p = P.from_file(os.path.join(HERE, "data", "aqua_planet_test_2d.prm"))
        p.initial_global_refinement = refinement
        p.numerics.momentum_solver = "coupled"
        p.use_schur_complement_solver = schur
    else:
        p = P.from_file(os.path.join(HERE, "data",
                                     "aqua_planet_shell_test_3d-feec.prm"))
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
        p.time_step = DT_FEEC
        p.adapt_time_step = False
    p.numerics.dtype = dtype
    return p


def seed_arrays(geo):
    """The seeded developed flow of models/presets.py as numpy: (u, p)."""
    cs = [np.asarray(a.centers) for a in geo.axes]
    r, lat, lon = np.meshgrid(*cs, indexing="ij")
    s = (r - cs[0][0]) / max(cs[0][-1] - cs[0][0], 1e-30)
    u = np.zeros((3,) + geo.cell_shape)
    u[2] = 0.1 * np.cos(lat) * (1.0 + 0.3 * np.sin(3 * lon)
                                * np.sin(np.pi * s))
    u[1] = 0.005 * np.cos(lat) * np.sin(2 * lon)
    return u, 0.01 * np.sin(lat) * np.cos(2 * lon) * s


def run_port(args):
    import torch

    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.models import boussinesq as bm
    from dycoreplanet_tpu_torch.models.presets import seed_developed_flow

    solves = []
    gmres = bm.gmres

    def recorded(op, b, *a, **kw):
        res = gmres(op, b, *a, **kw)
        eps = torch.finfo(b.dtype).eps
        solves.append(dict(
            restart=kw["restart"], iterations=res.iterations,
            rel_residual=float(res.residual_norm)
            / float(torch.linalg.vector_norm(b)),
            rtol=max(kw["rtol"], 16 * eps), converged=bool(res.converged)))
        return res

    bm.gmres = recorded
    rows = []
    for label, kw in configs(args):
        p = params(Parameters, args.case, args.dtype, **kw)
        m = BoussinesqModel(p, device=args.device)
        s0 = (m.initial_state() if args.case == "annulus"
              else seed_developed_flow(m))
        solves.clear()
        t0 = time.perf_counter()
        _, d = m.step(s0, p.time_step)
        row = dict(label=label, cells=list(m.geo.cell_shape),
                   solves=list(solves), solver_ok=d.solver_ok,
                   div_norm=d.div_norm, seconds=time.perf_counter() - t0)
        rows.append(row)
        print(f"{label} {tuple(m.geo.cell_shape)}: " + "; ".join(
            f"GMRES({s['restart']}) {s['iterations']} its, |r|/|b| "
            f"{s['rel_residual']:.3e} (rtol {s['rtol']:.3e}), converged "
            f"{s['converged']}" for s in solves)
            + f"; gate {d.solver_ok}, max|div u| {d.div_norm:.3e}",
            flush=True)
    return str(m.device), rows


def run_jax(args):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from dycoreplanet_tpu.base.params import Parameters
    from dycoreplanet_tpu.models import BoussinesqModel

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    rows = []
    for label, kw in configs(args):
        p = params(Parameters, args.case, args.dtype, **kw)
        m = BoussinesqModel(p)
        s0 = m.initial_state()
        if args.case == "feec":
            u, pres = seed_arrays(m.geo)
            u = jnp.asarray(u, s0.u.dtype)
            s0 = s0._replace(
                u=u, p=jnp.asarray(pres, s0.u.dtype),
                u_faces=tuple(m._apply_wall_face_values(
                    m._interp_component_to_faces(u[c], c), c)
                    for c in range(3)))
        t0 = time.perf_counter()
        _, d = m.step(s0, p.time_step)
        row = dict(label=label, cells=list(m.geo.cell_shape),
                   outer_iterations=d.poisson_iters,
                   outer_residual=d.helmholtz_residual,
                   solver_ok=d.solver_ok, div_norm=d.div_norm,
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(f"{label} {tuple(m.geo.cell_shape)} (JAX): outer "
              f"{d.poisson_iters} its, residual {d.helmholtz_residual:.3e}, "
              f"gate {d.solver_ok}, max|div u| {d.div_norm:.3e}", flush=True)
    return str(jax.devices()[0]), rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("case", choices=("annulus", "feec"))
    ap.add_argument("--refinements", type=int, nargs="+",
                    default=[4, 5, 6, 7, 8])
    ap.add_argument("--shapes", nargs="+",
                    default=["16x64x128", "32x128x256"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default=None)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    device, rows = run_jax(args) if args.jax else run_port(args)
    print(json.dumps({"case": args.case, "dtype": args.dtype,
                      "package": "jax" if args.jax else "port",
                      "device": device, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
