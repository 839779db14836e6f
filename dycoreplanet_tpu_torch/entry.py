"""Multi-device dry run of the port (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, standard personality).

``dryrun_multichip(n)`` prepares the flagship shell model at a tiny size
for a mesh of n shards (``BoussinesqModel.prepare_sharded``), runs one
sharded step of the kernel path (K2o, K1o, the sharded Poisson solve)
and holds it against the same step on one device. The shards lie on the
CUDA cards round-robin (several shards a card where there are fewer
cards than shards), or, with ``device="cpu"``, on the CPU (the kernels'
plain versions). The JAX function's last part, the mimetic personality
on the same mesh through GSPMD's plain path, has no counterpart: the
port's mesh refuses the mimetic model (ROADMAP.md: multi-device: CG,
escalation and the plain path on the mesh).

    python -c "from dycoreplanet_tpu_torch.entry import dryrun_multichip; \\
               dryrun_multichip(8)"
"""

from __future__ import annotations

import numpy as np
import torch

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import make_model
from dycoreplanet_tpu_torch.models.boussinesq import (
    BoussinesqModel, resolve_device)
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_state, unshard_state)


def _make_model(dtype: str, shape, device) -> BoussinesqModel:
    """The JAX entry's ``_make_model``: the shell-test physical setup
    (R0 = 1, R1 = 3, unit reference quantities) at ``shape``."""
    p = Parameters.from_text("")
    p.space_dimension = 3
    p.cuboid_geometry = False
    p.use_FEEC_solver = False
    p.time_step = 0.01
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    p.numerics.dtype = dtype
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    return make_model(p, device=device)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded step of the kernel path over a mesh of ``n_devices``
    shards at (4, 8, 16) f32, against the single-device step. Returns
    the mesh, the active kernels (``sharded_kernels``), max|u| and the
    largest |u_mesh - u_single|; raises if the step is not finite or the
    two differ by more than 1e-5."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    shape = (4, 8, 16)
    single = _make_model("float32", shape, devices[0])
    model = _make_model("float32", shape, devices[0])
    mesh = build_mesh(model.geo, devices)
    model.prepare_sharded(mesh)
    state = single.initial_state()
    dt = float(single.params.time_step)
    want, _ = single.step(state, dt)
    got, diag = model.step(shard_state(state, model.geo, mesh), dt)
    if not np.isfinite(diag.max_velocity):
        raise RuntimeError("sharded step produced NaN")
    err = float((unshard_state(got, devices[0]).u - want.u).abs().max())
    if err >= 1e-5:
        raise RuntimeError(f"sharded step vs single device diverged: {err}")
    report = {"devices": n_devices, "mesh": dict(mesh.shape),
              "kernels": model.sharded_kernels(),
              "max_velocity": diag.max_velocity, "err": err}
    print(f"dryrun_multichip: {n_devices} shards on "
          f"{len(mesh.distinct_devices())} device(s), mesh {report['mesh']}, "
          f"shell {shape}, max|u|={diag.max_velocity:.3e}, "
          f"div={diag.div_norm:.3e}, kernels {report['kernels']}, "
          f"|u - single device| = {err:.2e}")
    return report
