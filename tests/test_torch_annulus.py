"""The 2D annulus in the PyTorch port against the JAX package, on CPU in
float64 at nr 8 x nphi 48, from numpy-seeded inputs:

  * the static fields (vol, gravity, T_init, T_wall, p_hydro,
    rho_background, the BC specs, the solvers' constants) of both
    annulus prm files, and the 2D IC with `ic width scale` 1 and 100;
  * the annulus branches of the vector operators and the stencils, to
    1e-12 relative;
  * ``AnnulusPoissonFastDiag`` and ``AnnulusHelmholtzDirect`` (C = 2 and
    C = 1) against the JAX solvers and as exact inverses, and K4's
    description of the direct solver's operands (no copy, two column
    axes, no pair axis);
  * ``step``, ``step_strong``, ``temperature_step``, ``run`` and
    ``multi_step`` on the default (Richardson, every residual tracked)
    and the direct path: 1 step to 1e-10 and 8 steps to 1e-9 of the
    field scale (tests/test_torch_model.py's tolerances);
  * a forced miss that escalates and is repaired by CG, the shell kernel
    wrappers refusing the annulus, and both prm files through the CLI.
No Pallas kernel runs on the annulus: the JAX model runs as it is."""

import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid.factory import make_annulus as j_make_annulus
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import bc as j_bc
from dycoreplanet_tpu.ops import stencil as j_st
from dycoreplanet_tpu.ops import vector as j_vec
from dycoreplanet_tpu.ops.diagonal import (
    weak_laplacian_diagonal as j_wl_diag)
from dycoreplanet_tpu.physics.initial_data import (
    TemperatureInitialValues as JIC)
from dycoreplanet_tpu.solvers.helmholtz import (
    AnnulusHelmholtzDirect as JHelmholtz)
from dycoreplanet_tpu.solvers.spectral import (
    AnnulusPoissonFastDiag as JFastDiag)
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.factory import make_annulus, make_cuboid
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    state_from_numpy, state_to_numpy)
from dycoreplanet_tpu_torch.ops import bc as t_bc
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.ops.diagonal import weak_laplacian_diagonal
from dycoreplanet_tpu_torch.ops.forcing import ShellForcing
from dycoreplanet_tpu_torch.ops.projection import ShellProjection
from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson
from dycoreplanet_tpu_torch.physics.initial_data import (
    TemperatureInitialValues)
from dycoreplanet_tpu_torch.solvers.helmholtz import (
    AnnulusHelmholtzDirect, make_helmholtz_solver)
from dycoreplanet_tpu_torch.solvers.spectral import (
    AnnulusPoissonFastDiag, make_poisson_solver)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
PRMS = ("aqua_planet_test_2d.prm", "aqua_planet.prm")
SHAPE = (8, 48)
TOL = 1e-12
AS, NEU = BC.ANTISYM, BC.NEUMANN
# tolerances that two Richardson sweeps meet at this grid in f64 with a
# margin (on the seeded flows ~2e-9 and ~1e-9 relative; the prm's
# `temperature tol` of 1e-12 they miss), so that the fast path runs
GATE = dict(helmholtz_tol=1e-7, temperature_tol=1e-8)


def _params(cls, prm="aqua_planet_test_2d.prm", **num):
    p = cls.from_file(os.path.join(DATA, prm))
    p.numerics.dtype = "float64"
    p.final_time = 1e9
    p.numerics.n_radial, p.numerics.n_lon = SHAPE
    for k, v in num.items():
        setattr(p.numerics, k, v)
    return p


def _pair(prm="aqua_planet_test_2d.prm", nse_interval=1, **num):
    jp, tp = _params(JParameters, prm, **num), _params(Parameters, prm, **num)
    jp.NSE_solver_interval = tp.NSE_solver_interval = nse_interval
    return JModel(jp), BoussinesqModel(tp, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


def _seeded_states(jm, tm, seed=0):
    """The same seeded flow in both packages: random velocity, its
    interpolated faces, a random pressure, the initial temperature."""
    rng = np.random.default_rng(seed)
    u = jnp.asarray(0.05 * rng.standard_normal((2,) + jm.geo.cell_shape))
    faces = tuple(jm._apply_wall_face_values(
        jm._interp_component_to_faces(u[c], c), c) for c in range(2))
    p = jnp.asarray(0.01 * rng.standard_normal(jm.geo.cell_shape))
    js = jm.initial_state()._replace(u=u, u_faces=faces, p=p)
    ts = state_from_numpy(tm, np.asarray(js.u),
                          [np.asarray(f) for f in js.u_faces],
                          np.asarray(js.p), np.asarray(js.T))
    return js, ts


def _max_rel(js, ts):
    """Largest scale-relative difference over u, p, T and the faces."""
    u, faces, p, T, _, _ = state_to_numpy(ts)
    out = 0.0
    for want, got in [(js.u, u), (js.p, p), (js.T, T)] + list(
            zip(js.u_faces, faces)):
        out = max(out, rel(got, want))
    return out


def _check_rows(trow, jrow):
    """Packed diagnostics: cfl, max|u| and the T range (packed in f32;
    T_min and T_max with an absolute floor of 1e-14 where they are
    round-off values near 0), iteration counts and solver_ok exactly,
    the divergence (a round-off residual) bounded."""
    trow, jrow = _np(trow), _np(jrow)
    np.testing.assert_allclose(trow[:2], jrow[:2], rtol=1e-6, atol=1e-30)
    np.testing.assert_allclose(trow[2:4], jrow[2:4], rtol=1e-6, atol=1e-14)
    assert trow[4] < max(2 * jrow[4], 1e-12)
    np.testing.assert_array_equal(trow[5:7], jrow[5:7])
    np.testing.assert_array_equal(trow[10:], jrow[10:])


# ----------------------------------------------------------- static data
@pytest.mark.parametrize("prm", PRMS)
def test_static_fields_match(prm):
    jm, tm = _pair(prm, helmholtz_solver="direct")
    assert tm.geo.kind == "annulus" and tm.geo.cell_shape == SHAPE
    for name in ("vol", "gravity", "T_init", "p_hydro", "T_lap_offset",
                 "helm_diags", "T_diag"):
        want = np.asarray(getattr(jm, name))
        got = getattr(tm, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-13,
                                   atol=1e-13 * np.abs(want).max(),
                                   err_msg=name)
    assert tm.rho_background == pytest.approx(jm.rho_background, rel=1e-14)
    assert tm.T_ref == jm.T_ref
    # the BC tables: kinds, and the Dirichlet wall values
    for got, want in ((tm.u_specs, jm.u_specs),
                      ([tm.p_specs, tm.T_specs_hom],
                       [jm.p_specs, jm.T_specs_hom])):
        for g_row, w_row in zip(got, want):
            assert [None if g is None else (g.lo.name, g.hi.name)
                    for g in g_row] == [None if w is None else
                                        (w.lo.name, w.hi.name)
                                        for w in w_row]
    assert tm.T_specs[1] is None and jm.T_specs[1] is None
    assert (tm.T_specs[0].lo, tm.T_specs[0].hi) == (BC.DIRICHLET, NEU)
    # T_wall: the IC on the inner wall (the JAX model keeps it in the
    # Dirichlet spec only)
    want = np.asarray(jm.T_specs[0].lo_value)
    np.testing.assert_allclose(tm.T_wall, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    assert torch.equal(tm.T_specs[0].lo_value, torch.as_tensor(tm.T_wall))
    for name in ("_F", "_G", "_W", "_inv_denom"):
        np.testing.assert_array_equal(
            getattr(tm.poisson_spectral, name),
            np.asarray(getattr(jm.poisson_spectral, name)), err_msg=name)
    assert tm.poisson_spectral.check_amp == jm.poisson_spectral.check_amp
    for solver in ("helmholtz_direct", "temperature_direct"):
        for name in ("_F", "_G", "_v", "_trd", "_shift", "_low", "_up"):
            np.testing.assert_array_equal(
                getattr(getattr(tm, solver), name),
                np.asarray(getattr(getattr(jm, solver), name)),
                err_msg=f"{solver}.{name}")
    assert tm._dt_scaling_const() == jm._dt_scaling_const()
    assert tm.compute_time_step(0.3) == jm.compute_time_step(0.3)


@pytest.mark.parametrize("width_scale", [1.0, 100.0])
def test_initial_data_2d(width_scale):
    r0, r1 = 637.1, 647.1                  # aqua_planet.prm, nondim
    jic = JIC(2, r0, r1, width_scale=width_scale)
    tic = TemperatureInitialValues(2, r0, r1, width_scale=width_scale)
    np.testing.assert_allclose(tic.center1, np.asarray(jic.center1),
                               rtol=1e-15, atol=1e-12)
    np.testing.assert_allclose(tic.center2, np.asarray(jic.center2),
                               rtol=1e-15, atol=1e-12)
    # the rotation by 2 pi/3 of the reference's R * c * R^T
    assert np.linalg.norm(tic.center1) == pytest.approx(r0 + 0.35 * 10.0)
    assert np.arctan2(tic.center1[1], tic.center1[0]) == pytest.approx(
        2 * np.pi / 3)
    rng = np.random.default_rng(7)
    ang = rng.uniform(0, 2 * np.pi, 400)
    rad = rng.uniform(r0, r1, 400)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    # points near the bumps too, where the narrow IC is nonzero
    pts = np.concatenate([pts, tic.center1 + 0.3 * rng.standard_normal(
        (50, 2)), tic.center2 + 0.3 * rng.standard_normal((50, 2))])
    want = np.asarray(jic(jnp.asarray(pts)))
    got = tic(pts)
    assert float(np.max(want)) > 0
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-15 * float(np.max(want)))


# ------------------------------------------------------------ operators
def _geos(shape=SHAPE):
    return (j_make_annulus(*shape, 10.0, 30.0),
            make_annulus(*shape, 10.0, 30.0))


def _specs(mod, rng, shape=SHAPE):
    """The annulus model's BC tables in one package: u_specs, p_specs,
    T_specs (random Dirichlet wall values), T_specs_hom."""
    B, S = mod.BC, mod.BCSpec
    wall = rng.standard_normal(shape[1:])
    u = [[S(B.ANTISYM, B.ANTISYM), None], [S(B.ANTISYM, B.NEUMANN), None]]
    return {"u0": u[0], "u1": u[1], "p": [S(B.NEUMANN, B.NEUMANN), None],
            "T": [S(B.DIRICHLET, B.NEUMANN,
                    lo_value=torch.as_tensor(wall) if mod is not j_bc
                    else wall), None],
            "Th": [S(B.ANTISYM, B.NEUMANN), None]}


@pytest.mark.parametrize("mode", ["reference", "physical"])
def test_vector_terms(mode):
    jgeo, geo = _geos()
    rng = np.random.default_rng(5)
    js, ts = _specs(j_bc, rng), _specs(t_bc, np.random.default_rng(5))
    u = rng.standard_normal((2,) + SHAPE)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    assert rel(vec.advection_curvature(geo, tu),
               j_vec.advection_curvature(jgeo, ju)) <= TOL
    assert rel(vec.vector_laplacian_curvature(geo, tu, [ts["u0"], ts["u1"]]),
               j_vec.vector_laplacian_curvature(
                   jgeo, ju, [js["u0"], js["u1"]])) <= TOL
    got = vec.coriolis_acceleration(geo, tu, 0.7, mode)
    want = j_vec.coriolis_acceleration(jgeo, ju, 0.7, mode)
    assert rel(got, want) <= TOL
    # reference: +2 (u_phi, -u_r), no Omega; physical: -2 Omega e_z x u
    f = 2.0 if mode == "reference" else 2.0 * 0.7
    np.testing.assert_allclose(_np(got[0]), f * u[1], rtol=1e-15)
    np.testing.assert_allclose(_np(got[1]), -f * u[0], rtol=1e-15)


def test_vector_terms_refuse_the_cuboid():
    """Once a refusal: the cuboid's vector terms now run (their full
    parity: tests/test_torch_cuboid.py). Curvature terms are zero, and
    the Coriolis acceleration of either mode is -2 Omega e_z x u, the
    JAX package's, on a seeded velocity."""
    from dycoreplanet_tpu.grid.factory import make_cuboid as j_make_cuboid

    geo, jgeo = make_cuboid(4, 4, 4), j_make_cuboid(4, 4, 4)
    u = 0.1 * np.random.default_rng(8).standard_normal((3, 4, 4, 4))
    tu = torch.as_tensor(u)
    assert not vec.advection_curvature(geo, tu).any()
    assert not vec.vector_laplacian_curvature(geo, tu, [[None] * 3] * 3).any()
    for mode in ("reference", "physical"):
        got = vec.coriolis_acceleration(geo, tu, 0.7, mode)
        assert rel(got, j_vec.coriolis_acceleration(
            jgeo, jnp.asarray(u), 0.7, mode)) <= TOL
        np.testing.assert_allclose(_np(got[1]), -1.4 * u[2], rtol=1e-15)
        np.testing.assert_allclose(_np(got[2]), 1.4 * u[1], rtol=1e-15)
        assert not got[0].any()


def test_annulus_prm_on_the_slab_runs():
    """The annulus prm with `cuboid geometry = true` (once refused, naming
    "cuboid geometry") is the 2D (z, x) slab at 2^4 x 2^4: one step
    against the JAX model's, within TOL of each field's scale."""
    p, jp = _params(Parameters), _params(JParameters)
    for q in (p, jp):
        q.cuboid_geometry = True
    tm, jm = BoussinesqModel(p, device="cpu"), JModel(jp)
    assert tm.geo.kind == "cuboid" and tm.geo.cell_shape == (16, 16)
    (ts, td), (js, jd) = (m.step(m.initial_state(), m.params.time_step)
                          for m in (tm, jm))
    assert td.solver_ok == jd.solver_ok
    for g, w in ((ts.u, js.u), (ts.p, js.p), (ts.T, js.T)):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("spec", ["u0", "u1", "p", "T", "Th"])
def test_stencils(spec):
    jgeo, geo = _geos()
    rng = np.random.default_rng(6)
    js, ts = _specs(j_bc, rng), _specs(t_bc, np.random.default_rng(6))
    f = rng.standard_normal(SHAPE)
    jf, tf = jnp.asarray(f), torch.as_tensor(f)
    jsp, tsp = js[spec], ts[spec]
    for d in range(2):
        for name in ("to_faces", "grad_left_faces", "centered_gradient"):
            assert rel(getattr(st, name)(geo, tf, d, tsp[d]),
                       getattr(j_st, name)(jgeo, jf, d, jsp[d])) <= TOL, \
                (name, d)
    assert rel(st.weak_laplacian(geo, tf, tsp),
               j_st.weak_laplacian(jgeo, jf, jsp)) <= TOL
    if spec != "T":
        assert rel(weak_laplacian_diagonal(geo, tsp),
                   j_wl_diag(jgeo, jsp)) <= TOL
    uf = [rng.standard_normal(SHAPE) for _ in range(2)]
    for scheme in ("muscl", "upwind", "centered"):
        for form in ("advective", "flux"):
            got = st.advect_scalar(geo, [torch.as_tensor(x) for x in uf], tf,
                                   tsp, scheme=scheme, form=form)
            want = j_st.advect_scalar(jgeo, [jnp.asarray(x) for x in uf], jf,
                                      jsp, scheme=scheme, form=form)
            assert rel(got, want) <= TOL, (scheme, form)
    assert rel(st.divergence(geo, [torch.as_tensor(x) for x in uf]),
               j_st.divergence(jgeo, [jnp.asarray(x) for x in uf])) <= TOL
    assert rel(st.volume_mean(geo, tf), j_st.volume_mean(jgeo, jf)) <= TOL


# --------------------------------------------------------------- solvers
def test_annulus_fast_diag_matches_jax_and_inverts():
    jgeo, geo = _geos()
    solver = make_poisson_solver(geo, dtype=np.float64)
    assert isinstance(solver, AnnulusPoissonFastDiag)
    jsolver = JFastDiag(jgeo, dtype=np.float64)
    rng = np.random.default_rng(8)
    b = rng.standard_normal(SHAPE)
    b -= b.mean()
    got, iters = solver.solve(torch.as_tensor(b))
    assert iters == 0
    assert rel(got, jsolver.solve(jnp.asarray(b))[0]) <= TOL
    # manufactured: b = -weak_laplacian(x) with Neumann walls
    specs = [BCSpec(NEU, NEU), None]
    x = torch.as_tensor(rng.standard_normal(SHAPE))
    x = x - st.volume_mean(geo, x)
    b = -st.weak_laplacian(geo, x, specs)
    xs = solver(b)
    xs = xs - st.volume_mean(geo, xs)
    assert rel(xs, x) <= 1e-10
    assert rel(-st.weak_laplacian(geo, xs, specs), b) <= 1e-11


@pytest.mark.parametrize("fields", ["momentum", "temperature"])
def test_annulus_helmholtz_matches_jax_and_inverts(fields):
    jgeo, geo = _geos()
    specs = ([[BCSpec(AS, AS), None], [BCSpec(AS, NEU), None]]
             if fields == "momentum" else [[BCSpec(AS, NEU), None]])
    jspecs = ([[j_bc.BCSpec(j_bc.BC.ANTISYM, j_bc.BC.ANTISYM), None],
               [j_bc.BCSpec(j_bc.BC.ANTISYM, j_bc.BC.NEUMANN), None]]
              if fields == "momentum" else
              [[j_bc.BCSpec(j_bc.BC.ANTISYM, j_bc.BC.NEUMANN), None]])
    C = len(specs)
    solver = make_helmholtz_solver(geo, [s[0] for s in specs],
                                   dtype=np.float64)
    assert isinstance(solver, AnnulusHelmholtzDirect)
    jsolver = JHelmholtz(jgeo, [s[0] for s in jspecs], dtype=np.float64,
                         use_pallas=False)
    rng = np.random.default_rng(9)
    vol = torch.as_tensor(np.broadcast_to(geo.vol, SHAPE).copy())
    for c in (1e-3, 0.37, 5.0):
        b = rng.standard_normal((C,) + SHAPE)
        got = solver.solve(torch.as_tensor(b), c)
        assert rel(got, jsolver.solve(jnp.asarray(b), c)) <= TOL
        res = vol[None] * got - c * torch.stack([
            st.weak_laplacian(geo, got[k], specs[k]) for k in range(C)])
        assert float((res - torch.as_tensor(b)).norm()
                     / np.linalg.norm(b)) <= 1e-11
    assert solver.tridiag.launches == 0       # the plain version on CPU


@pytest.mark.parametrize("C", [2, 1])
def test_tridiag_layout_of_the_annulus_operands(C):
    """K4 reads AnnulusHelmholtzDirect's operands as passed: lower and
    upper one value a row, diag (nr, C, 2nm), rhs a strided view of the
    (C, nr, 2nm) transform: no copy, the columns (C, 2nm) (one axis at
    C = 1), no pair axis; rebuilt from the description, each operand
    equals its broadcast to (nr, C * 2nm)."""
    _, geo = _geos()
    solver = AnnulusHelmholtzDirect(geo, [BCSpec(AS, NEU)] * C,
                                    dtype=np.float64)
    nr, nphi = SHAPE
    m2 = 2 * (nphi // 2 + 1)
    b = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (C, nr, nphi)))
    sys4 = solver.systems(b, 0.3)
    assert sys4[3].stride() == (m2, nr * m2, 1)       # a view, not a copy
    lay = k4.layout(*sys4)
    assert lay.copied == () and lay.pair_axis is None and lay.pair == 1
    assert [size for size, _ in lay.axes] == ([C, m2] if C > 1 else [m2])
    assert lay.row_coefficients and lay.cols == C * m2 and lay.n == nr
    shape = (nr, C, m2)
    for name, a in zip(k4.NAMES, list(sys4) + [torch.empty(shape,
                                                          dtype=b.dtype)]):
        desc = lay.desc(name)
        op = lay.operands.get(name, a)
        sizes = [nr] + [s for s, _ in lay.columns()]
        flat = torch.as_strided(op, sizes, (desc[0],) + desc[1:4])
        if name != "x":
            assert torch.equal(flat.reshape(nr, -1),
                               a.expand(shape).reshape(nr, -1)), name
    # the values the solve must move: rhs, x and diag whole, lower and
    # upper one value a row
    assert k4.values_moved(*sys4) == 3 * nr * C * m2 + 2 * nr


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("numerics", [{}, {"helmholtz_solver": "direct"}],
                         ids=["default", "direct"])
def test_steps_match_jax_f64(numerics):
    jm, tm = _pair(**numerics)
    js, ts = _seeded_states(jm, tm)
    dt = 0.02
    for n in range(8):
        js, jd = jm.step(js, dt)
        ts, td = tm.step(ts, dt)
        err = _max_rel(js, ts)
        assert err <= (1e-10 if n == 0 else 1e-9), (n, err)
        _check_rows(td._h(), jd.packed)
        assert len(td.helmholtz_iters) == 2
    assert ts.step_number == int(js.step_number)
    assert ts.time == pytest.approx(float(js.time), rel=1e-14)


@pytest.mark.parametrize("numerics", [{}, {"helmholtz_solver": "direct"}],
                         ids=["default", "direct"])
def test_step_strong_matches_jax(numerics):
    jm, tm = _pair(**numerics)
    js, ts = _seeded_states(jm, tm, seed=2)
    js, jd = jm.step_strong(js, 0.02)
    ts, td = tm.step_strong(ts, 0.02)
    assert _max_rel(js, ts) <= 1e-9
    assert td.solver_ok and jd.solver_ok
    assert td.poisson_iters == jd.poisson_iters > 0


@pytest.mark.parametrize("numerics", [{}, {"helmholtz_solver": "direct"}],
                         ids=["default", "direct"])
def test_temperature_step_matches_jax(numerics):
    jm, tm = _pair(nse_interval=2, **numerics)
    js, ts = _seeded_states(jm, tm, seed=4)
    js, _ = jm.step(js, 0.02)
    ts, _ = tm.step(ts, 0.02)
    j2, jd = jm.temperature_step(js, 0.02)
    t2, td = tm.temperature_step(ts, 0.02)
    assert _max_rel(j2, t2) <= 1e-12
    assert torch.equal(t2.u, ts.u) and torch.equal(t2.p, ts.p)
    assert t2.time == pytest.approx(float(j2.time), rel=1e-14)
    _check_rows(td._h(), jd.packed)
    assert list(td.helmholtz_iters) == [0, 0]


@pytest.mark.parametrize("prm,numerics", [
    ("aqua_planet_test_2d.prm", {}),
    ("aqua_planet_test_2d.prm", dict(GATE)),
    ("aqua_planet_test_2d.prm", {"helmholtz_solver": "direct"}),
    ("aqua_planet.prm", {"ic_width_scale": 100.0}),
    ("aqua_planet_test_2d.prm", dict(GATE, residual_check_interval=4)),
], ids=["default", "gated", "direct", "production-dynamic", "interval-4"])
def test_run_matches_jax(prm, numerics):
    """The gated loop from the initial state. At the prm's own
    tolerances two Richardson sweeps miss `temperature tol` = 1e-12 in
    f64, and both packages redo each step with CG and open the same
    escalation window; with looser ones the fast path runs. With
    `residual check interval` = 4 the JAX annulus path still tracks
    every residual (its residual-free kernel is shell-only), and so does
    the port's."""
    jm, tm = _pair(prm, **numerics)
    js, jh = jm.run(max_steps=4)
    ts, th = tm.run(max_steps=4)
    assert len(th) == len(jh) == 4
    for g, w in zip(th, jh):
        for key in ("cfl", "max_velocity", "T_min", "T_max"):
            assert g[key] == pytest.approx(w[key], rel=1e-9, abs=1e-14), key
        assert g["div_norm"] < max(2 * w["div_norm"], 1e-9)
        assert g["poisson_iters"] == w["poisson_iters"]
        assert g["temperature_iters"] == w["temperature_iters"]
    assert _max_rel(js, ts) <= 1e-9
    assert tm._strong_steps_left == jm._strong_steps_left
    assert tm.escalations == (1 if prm == PRMS[0] and not numerics else 0)
    assert tm._richardson is None and tm._richardson_free is None
    _, d = tm.step(ts, tm.params.time_step)
    if numerics.get("helmholtz_solver") != "direct":
        assert d.helmholtz_residual >= 0 and d.temperature_residual >= 0


@pytest.mark.parametrize("numerics,nse", [
    ({}, 1), (GATE, 1), (GATE, 2), (dict(GATE, residual_check_interval=4), 1),
    ({"helmholtz_solver": "direct"}, 1)],
    ids=["default", "gated", "gated-nse2", "gated-interval-4", "direct"])
def test_multi_step_matches_jax(numerics, nse):
    """A chunk of 6: at the prm's tolerances the chunk misses and both
    packages redo it with CG from the original state. Every Richardson
    step reports its tracked residuals, also at `residual check interval`
    = 4 (no residual-free variant off the shell)."""
    jm, tm = _pair(nse_interval=nse, **numerics)
    js, ts = _seeded_states(jm, tm, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        js, jrows, _ = jm.multi_step(js, 0.02, 6)
        ts, trows, _ = tm.multi_step(ts, 0.02, 6)
    assert _max_rel(js, ts) <= 1e-9
    assert trows.shape == np.asarray(jrows).shape == (6, 13)
    for t, j in zip(trows, np.asarray(jrows)):
        _check_rows(t, j)
    assert tm._strong_steps_left == jm._strong_steps_left
    assert tm.escalations == (0 if numerics else 1)
    if "helmholtz_solver" not in numerics:
        assert bool((trows[:, 7] >= 0).all() and (trows[:, 9] >= 0).all())


@pytest.mark.parametrize("refinement,ok", [(4, True), (6, False)])
def test_fast_path_gate_by_refinement(refinement, ok):
    """aqua_planet_test_2d.prm in f32 from its initial state, one step of
    the default path in both packages: at its own grid (refinement 4,
    16 x 192) the two Richardson sweeps meet the gate; at refinement 6
    (64 x 768) the diffusion numbers have grown 16-fold and they miss
    it, in the JAX model as in the port, so the step is the
    escalation's (ROADMAP Queue 3). The verdicts are equal and the
    Helmholtz and temperature residuals agree to 1e-3 relative (the
    Poisson residual is a round-off value, held by the verdict alone)."""
    diags = []
    for cls, model in ((JParameters, JModel),
                       (Parameters, lambda p: BoussinesqModel(p,
                                                              device="cpu"))):
        p = cls.from_file(os.path.join(DATA, "aqua_planet_test_2d.prm"))
        p.initial_global_refinement = refinement
        m = model(p)
        assert m.geo.cell_shape == (2 ** refinement, 12 * 2 ** refinement)
        assert np.dtype(m.dtype) == np.float32
        _, d = m.step(m.initial_state(), p.time_step)
        diags.append(d)
    jd, td = diags
    assert bool(jd.solver_ok) is bool(td.solver_ok) is ok
    for name in ("helmholtz_residual", "temperature_residual"):
        want, got = float(getattr(jd, name)), float(getattr(td, name))
        assert want > 0 and abs(got - want) <= 1e-3 * want, (name, got,
                                                             want)


def test_forced_miss_escalates_and_cg_repairs():
    """A corrupted fast-diagonalization constant trips the Poisson
    spot-check; run() redoes the step with full CG, which repairs it."""
    _, tm = _pair()
    tm.poisson_spectral._inv_denom = 3.0 * tm.poisson_spectral._inv_denom
    tm.poisson_spectral.to(tm.device)
    s, d = tm.step(tm.initial_state(), tm.params.time_step)
    assert not d.solver_ok
    with pytest.warns(RuntimeWarning, match="retrying chunk with full CG"):
        got, rows, _ = tm.multi_step(tm.initial_state(),
                                     tm.params.time_step, 3)
    assert tm.escalations == 1
    assert bool((rows[:, 10] == 1).all()) and all(r[5] > 0 for r in rows)
    want = tm.initial_state()
    for _ in range(3):
        want, _ = tm.step_strong(want, tm.params.time_step)
    assert torch.equal(got.u, want.u) and torch.equal(got.T, want.T)
    _, hist = tm.run(max_steps=3)
    assert tm.escalations == 1            # the window is still open
    assert all(h["div_norm"] < 1e-9 for h in hist)


# ------------------------------------------------------ what runs where
@pytest.mark.parametrize("numerics", [{}, {"helmholtz_solver": "direct"}],
                         ids=["default", "direct"])
def test_annulus_step_calls_no_shell_kernel(numerics, monkeypatch):
    """The annulus step is the model's own plain PyTorch: no wrapper or
    plain version of K1, K2, K3 or K5 is called, by step, step_strong or
    temperature_step."""
    def refuse(*args, **kwargs):
        raise AssertionError("a shell kernel was called on the annulus")

    for cls in (ShellForcing, ShellRichardson):
        monkeypatch.setattr(cls, "__call__", refuse)
        monkeypatch.setattr(cls, "plain", refuse)
    for name in ("faces_div", "correct", "plain", "correct_plain"):
        monkeypatch.setattr(ShellProjection, name, refuse)
    monkeypatch.setattr(ShellForcing, "explicit_forcing", refuse)
    monkeypatch.setattr(ShellForcing, "advected_temperature", refuse)
    _, tm = _pair(nse_interval=2, **numerics)
    s = tm.initial_state()
    s, _ = tm.step(s, 0.01)
    s, _ = tm.temperature_step(s, 0.01)
    s, d = tm.step_strong(s, 0.01)
    assert d.solver_ok and bool(torch.isfinite(s.u).all())


def test_annulus_model_builds_no_shell_kernel():
    _, tm = _pair(helmholtz_solver="direct")
    assert list(tm.kernels()) == ["tridiag"]
    assert tm._forcing is None and tm._proj is None
    s, _ = tm.step(tm.initial_state(), 0.01)
    assert tm.kernels()["tridiag"].launches == 0      # plain on the CPU
    geo = tm.geo
    kw = dict(u_specs=tm.u_specs, T_specs_hom=tm.T_specs_hom)
    for build in (
            lambda: ShellForcing(
                geo, beta=1.0, T_ref=0.0, rho_background=1.0,
                gravity=tm.gravity, one_over_Re=1.0, omega_hat=1.0,
                coriolis_mode="reference", buoyancy="perturbation",
                scheme="muscl", include_gradp=True, p_specs=tm.p_specs,
                T_specs=tm.T_specs, T_wall=tm.T_wall, u_specs=tm.u_specs),
            lambda: ShellProjection(geo, tm.u_specs, tm.p_specs, True),
            lambda: ShellRichardson(
                geo, one_over_Re=1.0, one_over_Pe=1.0, nse_interval=1,
                helm_diags=tm.helm_diags, T_diag=tm.T_diag, iters_u=1,
                iters_T=1, **kw)):
        with pytest.raises(ValueError):
            build()


@pytest.mark.parametrize("setting", [
    ("numerics.temperature_advection", "semi-lagrangian", None),
    ("numerics.dtype", "bfloat16", "bf16"),
    ("numerics.poisson_solver", "cg", None),
    ("numerics.poisson_solver", "mg", None),
])
def test_annulus_refusals_name_their_item(setting):
    """The annulus configurations once refused here, each with the
    ROADMAP.md item that brought it (None: an earlier slice's), all of
    which run now: the semi-Lagrangian transport, bf16 and `poisson
    solver = cg | mg` — two steps through ``run``, finite and
    divergence-free (max|div u| < 1e-9; < 1e-2 in bf16, the JAX
    package's bf16 test's bound), with the fast Poisson solve or a
    Poisson CG (tests/test_torch_sl2d.py, tests/test_torch_multigrid.py
    and tests/test_torch_bf16_model.py hold them against the JAX
    model)."""
    p = _params(Parameters)
    name, value, item = setting
    obj = p.numerics if name.startswith("numerics.") else p
    setattr(obj, name.split(".")[-1], value)
    m = BoussinesqModel(p, device="cpu")
    krylov = name == "numerics.poisson_solver"
    assert (m.poisson_spectral is None) == krylov
    assert (m.poisson_precond is not None) == (value == "mg")
    assert (m._semi_lagrangian is not None) == (value == "semi-lagrangian")
    state, hist = m.run(max_steps=2)
    tol = 1e-2 if item == "bf16" else 1e-9
    assert all((h["poisson_iters"] > 0 or not krylov)
               and h["div_norm"] < tol for h in hist)
    assert bool(torch.isfinite(state.u).all())
    assert state.u.dtype == (torch.bfloat16 if item == "bf16"
                             else m.torch_dtype)


def test_without_cuda_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BoussinesqModel(_params(Parameters))


@pytest.mark.parametrize("prm", PRMS)
@pytest.mark.parametrize("chunk", [[], ["--chunk", "2"]],
                         ids=["per-step", "chunk-2"])
def test_cli_runs_annulus_prm(prm, chunk, capsys, tmp_path):
    """Both annulus prm files through the CLI at a reduced grid (a copy
    with an `n radial` / `n lon` override appended)."""
    from dycoreplanet_tpu_torch.cli.main import main

    path = tmp_path / prm
    with open(os.path.join(DATA, prm)) as f:
        path.write_text(f.read() + "\nsubsection Numerics\n  set n radial = "
                        "8\n  set n lon = 48\nend\n")
    rc = main(["-p", str(path), "--max-steps", "2", "--no-output",
               "--device", "cpu"] + chunk)
    out = capsys.readouterr().out
    assert rc == 0
    assert "Geometry               : annulus" in out
    assert "Grid cells             : 8 x 48" in out
    assert len([ln for ln in out.splitlines()
                if "Post-projection" in ln]) == 2
    if not chunk:
        assert "helmholtz=[2, 2]" in out
