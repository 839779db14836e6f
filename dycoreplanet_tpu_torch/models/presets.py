"""The bench configuration and its seeded developed flow — the port's
own copies of the JAX repo's flagship setup (``__graft_entry__.py``
``_make_model``, ``bench.py`` ``_seed_state``), used by chip_smoke.py and
scripts/profile_torch_step.py — and a shell of non-uniform radial
spacing."""

from __future__ import annotations

import dataclasses

import numpy as np

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models.boussinesq import BoussinesqModel, State
from dycoreplanet_tpu_torch.models.convert import state_from_numpy

BENCH_SHAPE = (32, 128, 256)
BENCH_DT = 0.002


def bench_params(shape=BENCH_SHAPE, dtype: str = "float32",
                 time_step: float = BENCH_DT) -> Parameters:
    """The shell-test physical setup (R0 = 1, R1 = 3, unit reference
    quantities) with the bench's production opt-ins: `poisson precision
    = high`, `momentum fixed iters = 1`, `fixed solver iters = 1`,
    residuals checked every step."""
    p = Parameters.from_text("")
    p.numerics.poisson_precision = "high"
    p.numerics.momentum_fixed_iters = 1
    p.numerics.residual_check_interval = 1
    p.numerics.fixed_solver_iters = 1
    p.space_dimension = 3
    p.cuboid_geometry = False
    p.use_FEEC_solver = False
    p.time_step = time_step
    p.final_time = 1e9
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    p.numerics.dtype = dtype
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    return p


def seed_developed_flow(model: BoussinesqModel, amp: float = 0.1) -> State:
    """Deterministic developed-flow seed (the bench's): a zonal jet
    u_lon ~ amp cos(lat) with a radial-longitudinal perturbation and a
    weak meridional flow, plus a smooth pressure field so that the
    pressure gradient acts from the first step."""
    geo = model.geo
    cs = [np.asarray(a.centers) for a in geo.axes]
    r, lat, lon = np.meshgrid(*cs, indexing="ij")
    r0, r1 = float(cs[0][0]), float(cs[0][-1])
    s = (r - r0) / max(r1 - r0, 1e-30)
    u = np.zeros((3,) + geo.cell_shape)
    u[2] = amp * np.cos(lat) * (1.0 + 0.3 * np.sin(3 * lon)
                                * np.sin(np.pi * s))
    u[1] = 0.05 * amp * np.cos(lat) * np.sin(2 * lon)
    pres = 0.01 * np.sin(lat) * np.cos(2 * lon) * s
    st0 = state_from_numpy(model, u, [np.zeros(geo.cell_shape)] * 3, pres,
                           model.T_init)
    return st0._replace(u_faces=model.interp_to_faces(st0.u))


def stretched_shell(shape=BENCH_SHAPE, r0: float = 1.0, r1: float = 3.0,
                    power: float = 1.3, factory=None, geometry=None):
    """make_shell's shell with its radial faces stretched toward the
    inner wall, face i at r0 + (r1 - r0) (i / nr)^power, every metric of
    the radial axis recomputed as make_shell computes it: a shell of
    non-uniform radial spacing, on which make_poisson_solver builds
    ShellPoissonSpectral. ``factory`` and ``geometry`` are the modules of
    ``make_shell`` and ``Axis`` (the port's by default; the tests pass
    the JAX package's to build the same arrays there)."""
    if factory is None:
        from dycoreplanet_tpu_torch.grid import factory
    if geometry is None:
        from dycoreplanet_tpu_torch.grid import geometry
    nr, nlat, nlon = shape
    g = factory.make_shell(nr, nlat, nlon, r0, r1)
    rf = r0 + (r1 - r0) * np.linspace(0.0, 1.0, nr + 1) ** power
    rc = 0.5 * (rf[1:] + rf[:-1])
    latf = np.asarray(g.axes[1].faces)
    latc = np.asarray(g.axes[1].centers)
    dlat, dlon = np.pi / nlat, 2.0 * np.pi / nlon
    sin_band = np.sin(latf[1:]) - np.sin(latf[:-1])
    r3 = (rf[1:] ** 3 - rf[:-1] ** 3) / 3.0
    r2 = (rf[1:] ** 2 - rf[:-1] ** 2) / 2.0
    vol = r3.reshape(-1, 1, 1) * sin_band.reshape(1, -1, 1) * dlon
    area_r = (rf ** 2).reshape(-1, 1, 1) * sin_band.reshape(1, -1, 1) * dlon
    area_lat = r2.reshape(-1, 1, 1) * np.cos(latf).reshape(1, -1, 1) * dlon
    area_lat[:, 0, :] = 0.0
    area_lat[:, -1, :] = 0.0
    area_lon = r2.reshape(-1, 1, 1) * np.full((1, nlat, 1), dlat)
    # centre to centre across interior faces, twice the wall gap at walls
    dr = np.concatenate([[2 * (rc[0] - rf[0])], np.diff(rc),
                         [2 * (rf[-1] - rc[-1])]])
    dist_r = dr.reshape(-1, 1, 1)
    dist_lat = rc.reshape(-1, 1, 1) * np.full((1, nlat + 1, 1), dlat)
    dist_lon = rc.reshape(-1, 1, 1) * np.cos(latc).reshape(1, -1, 1) * dlon
    ar = geometry.Axis(name="r", n=nr, periodic=False, centers=rc, faces=rf)
    extras = dict(g.extras, r_centers=rc.reshape(-1, 1, 1),
                  r_faces=rf.reshape(-1, 1, 1))
    return dataclasses.replace(
        g, axes=(ar,) + tuple(g.axes[1:]), vol=vol,
        face_area=(area_r, area_lat, area_lon),
        face_dist=(dist_r, dist_lat, dist_lon), extras=extras)
