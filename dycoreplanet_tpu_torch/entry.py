"""Driver entry points of the port (counterparts of the JAX package's
``__graft_entry__``): the single-device step and the multi-device dry
run.

``entry()`` returns ``(fn, example_args)``: ``fn(state, dt)`` is one step
of the flagship model (the 3D spherical-shell Boussinesq core at
(8, 16, 32) f32), the new ``State`` of ``_step_impl``; on the card it
launches K2, K1 and K5 once each.

``dryrun_multichip(n)`` runs the JAX function's three parts on one mesh
of n shards over the flagship shell at a tiny size: (i) one sharded step
of the kernel-free path (``prepare_sharded(mesh, kernels=False)``, the
JAX ``pallas=False``: K2o's plain version and the plain Richardson
solves on the shards); (ii) the same step on the kernel path (K2o, K1o,
the sharded Poisson solve), held to (i) within 1e-5 as the JAX function
holds its kernel path to its plain one, and to the single-device step;
(iii) the mimetic (staggered C-grid) personality on the same mesh,
against its single-device step. The shards lie on the CUDA cards
round-robin (several shards a card where there are fewer cards than
shards), or, with ``device="cpu"``, on the CPU (the kernels' plain
versions).

    python -m dycoreplanet_tpu_torch.entry [--device cpu]

runs one ``entry()`` step, then ``dryrun_multichip(8)``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import make_model
from dycoreplanet_tpu_torch.models.boussinesq import (
    BoussinesqModel, resolve_device)
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_state, unshard_state)


def _make_model(dtype: str, shape=None, poisson_precision=None,
                momentum_fixed_iters=None, residual_check_interval=None,
                fixed_solver_iters=None, *, device=None,
                mimetic: bool = False) -> BoussinesqModel:
    """The JAX entry's ``_make_model``: the model of ``_params`` on
    ``device``."""
    return make_model(_params(dtype, shape, poisson_precision,
                              momentum_fixed_iters, residual_check_interval,
                              fixed_solver_iters, mimetic=mimetic),
                      device=device)


def _params(dtype: str, shape=None, poisson_precision=None,
            momentum_fixed_iters=None, residual_check_interval=None,
            fixed_solver_iters=None, *, mimetic: bool = False
            ) -> Parameters:
    """The parameters of the JAX entry's ``_make_model``: the shell-test
    physical setup (R0 = 1, R1 = 3, unit reference quantities) at
    ``shape`` (None: ``initial global refinement`` = 3, that is (8, 16,
    32)), with the four optional numerics knobs where given; with
    ``mimetic`` the FEEC staggered personality, as the JAX dry run's
    third part sets it."""
    p = Parameters.from_text("")
    if poisson_precision is not None:
        p.numerics.poisson_precision = poisson_precision
    if momentum_fixed_iters is not None:
        p.numerics.momentum_fixed_iters = momentum_fixed_iters
    if residual_check_interval is not None:
        p.numerics.residual_check_interval = residual_check_interval
    if fixed_solver_iters is not None:
        p.numerics.fixed_solver_iters = fixed_solver_iters
    p.space_dimension = 3
    p.cuboid_geometry = False
    p.use_FEEC_solver = mimetic
    if mimetic:
        p.numerics.feec_formulation = "staggered"
    p.time_step = 0.01
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    p.numerics.dtype = dtype
    if shape is not None:
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    else:
        p.initial_global_refinement = 3
    return p


def entry(device=None):
    """(fn, example_args): ``fn(state, dt)`` is one step of the flagship
    model at (8, 16, 32) f32 and returns the new State; the example
    arguments are its initial state and dt as the model rounds it. On
    the card unless ``device`` names another (``"cpu"``: the kernels'
    plain versions); without CUDA and without ``device`` it raises, as
    the model does. ``fn.model`` is the model the step runs on."""
    model = _make_model("float32", device=device)
    state = model.initial_state()
    dt = model._scalar(model.params.time_step)

    def fn(state, dt):
        new_state, _, _ = model._step_impl(state, dt)
        return new_state

    fn.model = model
    return fn, (state, dt)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three parts of the JAX entry over a mesh of ``n_devices``
    shards at (4, 8, 16) f32 (module docstring). Returns the mesh, the
    kernel path's active kernels (``sharded_kernels``), its max|u| and
    largest |u_mesh - u_single| ("err"), and a report of each part under
    "parts"; raises if a step is not finite or a comparison misses its
    bound (1e-5)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    shape = (4, 8, 16)
    single = _make_model("float32", shape, device=devices[0])
    mesh = build_mesh(single.geo, devices)
    state = single.initial_state()
    dt = float(single.params.time_step)

    def sharded_step(model, state):
        got, diag = model.step(shard_state(state, model.geo, mesh), dt)
        if not np.isfinite(diag.max_velocity):
            raise RuntimeError("sharded step produced NaN")
        return unshard_state(got, devices[0]), diag

    def gap(a, b) -> float:
        return float((a.u - b.u).abs().max())

    def check(name, err):
        if err >= 1e-5:
            raise RuntimeError(f"{name} diverged: {err}")
        return err

    # (i) the kernel-free mesh step
    plain = _make_model("float32", shape,
                        device=devices[0]).prepare_sharded(mesh,
                                                           kernels=False)
    got_plain, d_plain = sharded_step(plain, state)
    # (ii) the kernel path, against (i) and the single device
    model = _make_model("float32", shape,
                        device=devices[0]).prepare_sharded(mesh)
    got, diag = sharded_step(model, state)
    want, _ = single.step(state, dt)
    err_plain = check("sharded kernel path vs kernel-free path",
                      gap(got, got_plain))
    err = check("sharded step vs single device", gap(got, want))
    # (iii) the mimetic personality on the same mesh
    mim_1 = _make_model("float32", shape, device=devices[0], mimetic=True)
    mim = _make_model("float32", shape, device=devices[0],
                      mimetic=True).prepare_sharded(mesh)
    s3 = mim_1.initial_state()
    got3, d3 = sharded_step(mim, s3)
    err3 = check("sharded mimetic step vs single device",
                 gap(got3, mim_1.step(s3, dt)[0]))
    parts = {
        "plain": {"kernels": plain.sharded_kernels(),
                  "max_velocity": d_plain.max_velocity,
                  "div_norm": d_plain.div_norm},
        "kernels": {"kernels": model.sharded_kernels(),
                    "max_velocity": diag.max_velocity,
                    "div_norm": diag.div_norm, "err_plain": err_plain,
                    "err": err},
        "mimetic": {"kernels": mim.sharded_kernels(),
                    "max_velocity": d3.max_velocity,
                    "div_norm": d3.div_norm, "err": err3}}
    report = {"devices": n_devices, "mesh": dict(mesh.shape),
              "kernels": model.sharded_kernels(),
              "max_velocity": diag.max_velocity, "err": err, "parts": parts}
    where = (f"{n_devices} shards on {len(set(devices))} "
             f"device(s), mesh {report['mesh']}, shell {shape}")
    print(f"dryrun_multichip: {where}, kernel-free: max|u|="
          f"{d_plain.max_velocity:.3e}, div={d_plain.div_norm:.3e}, "
          f"kernels {parts['plain']['kernels']}")
    print(f"dryrun_multichip: kernel path: max|u|={diag.max_velocity:.3e}, "
          f"div={diag.div_norm:.3e}, kernels {report['kernels']}, "
          f"|u - kernel-free| = {err_plain:.2e}, "
          f"|u - single device| = {err:.2e}")
    print(f"dryrun_multichip: FEEC staggered mimetic on the same mesh: "
          f"kernels {parts['mimetic']['kernels']}, max|u|="
          f"{d3.max_velocity:.3e}, div={d3.div_norm:.3e}, "
          f"|u - single device| = {err3:.2e}")
    return report


def main(argv=None) -> None:
    """One ``entry()`` step, then ``dryrun_multichip(8)`` (the JAX
    module's ``__main__``)."""
    ap = argparse.ArgumentParser(description="the port's entry points: "
                                 "one entry() step and dryrun_multichip(8)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; cpu for the plain "
                         "versions")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    if not all(bool(torch.isfinite(x).all())
               for x in (out.u, out.p, out.T) + tuple(out.u_faces)):
        raise RuntimeError("entry(): the step produced non-finite fields")
    print("entry(): single-device step OK, shape", tuple(out.u.shape))
    dryrun_multichip(8, device=args.device)


if __name__ == "__main__":
    main()
