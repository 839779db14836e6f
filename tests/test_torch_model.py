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
    ("use_FEEC_solver", True), ("cuboid_geometry", True),
    ("space_dimension", 2), ("NSE_solver_interval", 2),
    ("numerics.dtype", "bfloat16"), ("numerics.helmholtz_solver", "direct"),
    ("numerics.poisson_solver", "mg"),
    ("numerics.temperature_advection", "semi-lagrangian"),
    ("numerics.residual_check_interval", 4),
    ("numerics.momentum_solver", "coupled"),
])
def test_unsupported_configurations_raise(setting):
    p = _params(Parameters)
    name, value = setting
    obj = p.numerics if name.startswith("numerics.") else p
    setattr(obj, name.split(".")[-1], value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        BoussinesqModel(p, device="cpu")


def test_multi_step_raises():
    m = BoussinesqModel(_params(Parameters), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        m.multi_step(m.initial_state(), 0.01, 4)
