"""The PyTorch port's BoussinesqModel against the JAX package's, on CPU:
static fields, whole steps from the same state (f64: 1 step to 1e-10,
8 steps to 1e-9 of the field scale; f32 with the bench opt-ins: 1 step
to 1e-5), the run loop, the Poisson spot-check escalation, and the
configurations the port refuses."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    state_from_numpy, state_to_numpy)

PRM = os.path.join(os.path.dirname(__file__), "..", "data",
                   "aqua_planet_shell_test_3d-classic.prm")
SHAPE = (4, 8, 16)
OPT_INS = dict(momentum_fixed_iters=1, fixed_solver_iters=1,
               poisson_precision="high")


def _params(cls, dtype="float64", shape=SHAPE, **num):
    p = cls.from_file(PRM)
    p.numerics.dtype = dtype
    p.adapt_time_step = False
    p.final_time = 1e9
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    for k, v in num.items():
        setattr(p.numerics, k, v)
    return p


def _pair(dtype="float64", **num):
    return (JModel(_params(JParameters, dtype, **num)),
            BoussinesqModel(_params(Parameters, dtype, **num), device="cpu"))


def _seeded_states(jm, tm, seed=0):
    """The same seeded flow in both packages: random velocity, its
    interpolated faces, a random pressure, the initial temperature."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(jm.dtype)
    u = jnp.asarray(0.05 * rng.standard_normal((3,) + jm.geo.cell_shape), dt)
    faces = tuple(jm._apply_wall_face_values(
        jm._interp_component_to_faces(u[c], c), c) for c in range(3))
    p = jnp.asarray(0.01 * rng.standard_normal(jm.geo.cell_shape), dt)
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
        want = np.asarray(want)
        scale = max(float(np.max(np.abs(want))), 1e-30)
        out = max(out, float(np.max(np.abs(got - want))) / scale)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_static_fields_match(dtype):
    jm, tm = _pair(dtype)
    tol = 1e-13 if dtype == "float64" else 1e-6
    for name in ("vol", "gravity", "T_init", "T_lap_offset", "helm_diags",
                 "T_diag"):
        want = np.asarray(getattr(jm, name))
        got = getattr(tm, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max(), err_msg=name)
    for name in ("_F", "_G", "_V", "_Q", "_inv_denom"):
        np.testing.assert_array_equal(
            getattr(tm.poisson_spectral, name),
            np.asarray(getattr(jm.poisson_spectral, name)), err_msg=name)
    assert tm.rho_background == pytest.approx(jm.rho_background, rel=1e-14)
    # the direct Helmholtz solvers' constants, built from the same prm
    jm, tm = _pair(dtype, helmholtz_solver="direct")
    for solver in ("helmholtz_direct", "temperature_direct"):
        for name in ("_F", "_G", "_V", "_v", "_trd", "_lam", "_low", "_up"):
            np.testing.assert_array_equal(
                getattr(getattr(tm, solver), name),
                np.asarray(getattr(getattr(jm, solver), name)),
                err_msg=f"{solver}.{name}")


@pytest.mark.parametrize("numerics", [{}, OPT_INS],
                         ids=["default", "bench-opt-ins"])
def test_steps_match_jax_f64(numerics):
    jm, tm = _pair("float64", **numerics)
    js, ts = _seeded_states(jm, tm)
    dt = 0.02
    for n in range(8):
        js, jd = jm.step(js, dt)
        ts, td = tm.step(ts, dt)
        err = _max_rel(js, ts)
        assert err <= (1e-10 if n == 0 else 1e-9), (n, err)
        # cfl, max|u|, T range (packed in f32); the divergence is a
        # round-off residual: bound it instead of diffing it
        np.testing.assert_allclose(td._h()[:4], np.asarray(jd.packed)[:4],
                                   rtol=1e-6, atol=1e-30)
        assert td.div_norm < max(2 * jd.div_norm, 1e-12)
        assert td.solver_ok == jd.solver_ok
        assert td.poisson_iters == jd.poisson_iters
        assert td.temperature_iters == jd.temperature_iters
        assert list(td.helmholtz_iters) == list(jd.helmholtz_iters)
    assert ts.step_number == int(js.step_number)
    assert ts.time == pytest.approx(float(js.time), rel=1e-14)


def test_step_matches_jax_f32_opt_ins():
    jm, tm = _pair("float32", **OPT_INS)
    js, ts = _seeded_states(jm, tm, seed=1)
    js, jd = jm.step(js, 0.02)
    ts, td = tm.step(ts, 0.02)
    assert _max_rel(js, ts) <= 1e-5
    assert td.solver_ok == jd.solver_ok


def test_step_strong_matches_jax():
    """The escalated (full-CG) step, where K3 runs instead of K1."""
    jm, tm = _pair("float64")
    js, ts = _seeded_states(jm, tm, seed=2)
    js, jd = jm.step_strong(js, 0.02)
    ts, td = tm.step_strong(ts, 0.02)
    assert _max_rel(js, ts) <= 1e-9
    assert td.solver_ok and jd.solver_ok
    assert td.poisson_iters == jd.poisson_iters


def test_run_matches_jax():
    jm, tm = _pair("float64")
    _, jh = jm.run(max_steps=3)
    _, th = tm.run(max_steps=3)
    assert len(th) == len(jh) == 3
    for g, w in zip(th, jh):
        for key in ("cfl", "max_velocity", "T_min", "T_max"):
            assert g[key] == pytest.approx(w[key], rel=1e-9, abs=1e-14), key
        assert g["div_norm"] < max(2 * w["div_norm"], 1e-9)
        assert g["poisson_iters"] == w["poisson_iters"]


class TestSpectralResidualCheck:
    """Port twin of tests/test_model.py::TestSpectralResidualCheck: a
    corrupted fast-diagonalization constant trips the Poisson residual
    spot-check, and run() repairs the step with the full-CG path."""

    def _model(self):
        p = _params(Parameters)
        p.NSE_solver_interval = 1
        p.numerics.helmholtz_tol = 1e-4
        p.numerics.temperature_tol = 1e-6
        return BoussinesqModel(p, device="cpu")

    def test_healthy_solve_reports_real_residual(self):
        m = self._model()
        s, d = m.step(m.initial_state(), m.params.time_step)
        assert d.poisson_residual >= 0.0
        assert d.solver_ok

    def test_corrupted_fast_diag_trips_escalation_and_cg_repairs(self):
        m = self._model()
        m.poisson_spectral._inv_denom = 3.0 * m.poisson_spectral._inv_denom
        m.poisson_spectral.to(m.device)
        s, d = m.step(m.initial_state(), m.params.time_step)
        assert not d.solver_ok          # spot-check caught it
        strong_calls = []
        real_strong = m.step_strong

        def spy_strong(state, dt):
            strong_calls.append(int(state.step_number))
            return real_strong(state, dt)

        m.step_strong = spy_strong
        state, hist = m.run(max_steps=3)
        assert strong_calls, "escalation never fired"
        assert m.escalations == 1
        assert all(h["div_norm"] < 1e-6 for h in hist)


def test_without_cuda_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BoussinesqModel(_params(Parameters))


@pytest.mark.parametrize("setting", [
    (("use_FEEC_solver", True), ("numerics.feec_formulation", "staggered")),
    (("cuboid_geometry", True), ("use_FEEC_solver", True),
     ("numerics.feec_formulation", "staggered")),
    (("cuboid_geometry", True), ("numerics.dtype", "bfloat16")),
    (("space_dimension", 2),
     ("numerics.temperature_advection", "semi-lagrangian")),
    ("numerics.dtype", "bfloat16"), ("numerics.poisson_solver", "cg"),
    ("numerics.poisson_solver", "mg"),
    (("numerics.fixed_solver_iters", 0), ("numerics.momentum_fixed_iters", 1)),
])
def test_unsupported_configurations_raise(setting):
    """Each configuration this list once refused; settings in a tuple are
    applied together. Every one runs now: the mimetic FEEC realization,
    on the shell and on the cube (the ``cube_3d_feec_staggered``
    golden's), bf16 (on the shell and the cuboid), `poisson solver = cg |
    mg`, the annulus with the semi-Lagrangian transport, and Richardson
    momentum beside CG temperature — built through ``make_model`` (the
    mimetic model for the first two), two steps through ``run``, finite
    and divergence-free: max|div u| < 1e-9, or < 1e-2 in bf16 (the JAX
    package's bf16 test's bound; tests/test_torch_bf16*.py hold bf16
    against the JAX package). tests/test_torch_mimetic.py,
    tests/test_torch_multigrid.py, tests/test_torch_sl2d.py and
    tests/test_torch_richardson_cg.py hold the others against it. FEEC in
    its collocated realization and the coupled solves run
    (tests/test_torch_feec.py), as do the annulus
    (tests/test_torch_annulus.py) and the cuboid
    (test_cuboid_configurations_run, tests/test_torch_cuboid.py)."""
    from dycoreplanet_tpu_torch.models import make_model
    from dycoreplanet_tpu_torch.models.mimetic import MimeticBoussinesqModel

    p = _params(Parameters)
    settings = setting if isinstance(setting[0], tuple) else (setting,)
    for name, value in settings:
        obj = p.numerics if name.startswith("numerics.") else p
        setattr(obj, name.split(".")[-1], value)
    bf16 = dict(settings).get("numerics.dtype") == "bfloat16"
    p.numerics.nz = p.numerics.ny = p.numerics.nx = 8
    p.numerics.n_radial, p.numerics.n_lon = (
        (8, 48) if p.space_dimension == 2 else SHAPE[::2])
    m = make_model(p, device="cpu")
    assert isinstance(m, MimeticBoussinesqModel) == p.use_FEEC_solver
    state, hist = m.run(max_steps=2)
    tol = 1e-2 if bf16 else 1e-9
    assert len(hist) == 2 and all(h["div_norm"] < tol for h in hist)
    assert all(bool(torch.isfinite(x).all())
               for x in (state.u, state.p, state.T))
    assert state.T.dtype == (torch.bfloat16 if bf16 else torch.float64)


@pytest.mark.parametrize("setting", [
    (("use_FEEC_solver", True), ("numerics.feec_formulation", "staggered")),
    (("numerics.poisson_solver", "cg"),), (("numerics.poisson_solver", "mg"),),
])
def test_mesh_refuses_krylov_poisson_and_mimetic(setting):
    """On a mesh (``prepare_sharded``) the mimetic model, `poisson solver
    = cg` and `poisson solver = mg` (each of which raised before its
    solves were ported to the mesh) prepare, their Poisson solve reported
    as the JAX package reports it; the mg model's V-cycle rebuilt with
    its line smoother on the radial axis alone, as the JAX mesh rebuilds
    it."""
    from dycoreplanet_tpu_torch.models import make_model
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh

    p = _params(Parameters)
    for name, value in setting:
        obj = p.numerics if name.startswith("numerics.") else p
        setattr(obj, name.split(".")[-1], value)
    m = make_model(p, device="cpu")
    mesh = Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("lat", "lon"))
    assert m.prepare_sharded(mesh) is m
    assert m.sharded_kernels()["poisson"] == {
        "cg": "jacobi-cg", "mg": "mg-cg"}.get(
            p.numerics.poisson_solver, "ShardedShellPoissonFastDiag")
    if p.numerics.poisson_solver == "mg":
        assert m.poisson_precond.line_axes == [0]
        assert m._mesh.multigrid.line_solves_per_cycle() == \
            m.poisson_precond.line_solves_per_cycle()


@pytest.mark.parametrize("dim", [3, 2])
def test_cuboid_configurations_run(dim):
    """The two cuboid configurations once refused here (naming "cuboid
    geometry"): the 3D box and the 2D (z, x) slab at this file's
    physics, f64, on the CPU: two steps through ``run``, finite,
    divergence-free, no flow through the bottom wall."""
    p = _params(Parameters)
    p.cuboid_geometry = True
    p.space_dimension = dim
    p.numerics.nz = p.numerics.ny = p.numerics.nx = 8
    m = BoussinesqModel(p, device="cpu")
    assert m.geo.kind == "cuboid" and m.geo.dim == dim
    state, hist = m.run(max_steps=2)
    assert len(hist) == 2 and all(h["div_norm"] < 1e-9 for h in hist)
    assert all(bool(torch.isfinite(x).all())
               for x in (state.u, state.p, state.T))
    assert not state.u_faces[0][0].any()
