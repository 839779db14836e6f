"""The semi-Lagrangian temperature transport on the 2D geometries in the
PyTorch port against the JAX package, on CPU in float64: the annulus
(aqua_planet_test_2d.prm at 8 x 48, periodic phi) and the (z, x) slab
(tests/test_model.py's TestCuboid2D physics at 8 x 16).

  * the transport alone on a seeded velocity and temperature, to 1e-12
    of the field scale;
  * N steps from a seeded flow (the annulus) or from rest (the slab): the
    iteration counts and the gate's verdict equal, the fields within
    1e-10 of their scale; ``run`` the same records and final state;
  * a ``multi_step`` chunk of 4 bitwise the step loop.
No Pallas kernel lies on these paths in either package."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops.semi_lagrangian import semi_lagrangian_transport
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    state_from_numpy, state_to_numpy)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
STEP_TOL = 1e-10
N = 3
CASES = ("annulus", "slab")


def _params(cls, case):
    if case == "annulus":
        p = cls.from_file(os.path.join(DATA, "aqua_planet_test_2d.prm"))
        p.numerics.n_radial, p.numerics.n_lon = 8, 48
        # two Richardson sweeps meet these at this grid in f64
        # (tests/test_torch_annulus.py), so the fast path runs
        p.numerics.helmholtz_tol = 1e-7
        p.numerics.temperature_tol = 1e-8
    else:
        p = cls.from_text("")
        p.space_dimension = 2
        p.cuboid_geometry = True
        p.numerics.nz, p.numerics.nx = 8, 16
        p.physical_constants.expansion_coefficient = 0.2
        p.reference_quantities.velocity = 1.0
        p.reference_quantities.length = 1.0
        p.reference_quantities.temperature_ref = 3.0
        p.time_step = 0.01
    p.numerics.dtype = "float64"
    p.adapt_time_step = False
    p.final_time = 1e9
    p.numerics.temperature_advection = "semi-lagrangian"
    return p


def _pair(case):
    return (JModel(_params(JParameters, case)),
            BoussinesqModel(_params(Parameters, case), device="cpu"))


def _start(jm, tm, case, seed=11):
    """The annulus from a seeded flow, the slab from rest (its buoyancy
    spins it up), the same state in both packages."""
    js = jm.initial_state()
    if case == "annulus":
        rng = np.random.default_rng(seed)
        u = jnp.asarray(0.05 * rng.standard_normal((2,) + jm.geo.cell_shape))
        faces = tuple(jm._apply_wall_face_values(
            jm._interp_component_to_faces(u[c], c), c) for c in range(2))
        js = js._replace(u=u, u_faces=faces)
    ts = state_from_numpy(tm, np.asarray(js.u),
                          [np.asarray(f) for f in js.u_faces],
                          np.asarray(js.p), np.asarray(js.T))
    return js, ts


def _max_rel(js, ts):
    u, faces, p, T, _, _ = state_to_numpy(ts)
    out = 0.0
    for want, got in [(js.u, u), (js.p, p), (js.T, T)] + list(
            zip(js.u_faces, faces)):
        want = np.asarray(want)
        out = max(out, float(np.max(np.abs(got - want)))
                  / max(float(np.max(np.abs(want))), 1e-30))
    return out


@pytest.mark.parametrize("case", CASES)
def test_transport_matches_jax(case):
    """The departure-point interpolation on a seeded velocity (a CFL of
    ~1-2 cells) and temperature, periodic phi (the annulus) and x (the
    slab) wrapped, to 1e-12 of the field scale."""
    jm, tm = _pair(case)
    rng = np.random.default_rng(3)
    u = 0.3 * rng.standard_normal((2,) + jm.geo.cell_shape)
    T = np.asarray(jm.T_init) + 0.1 * rng.standard_normal(jm.geo.cell_shape)
    dt = 0.05
    want = np.asarray(semi_lagrangian_transport(
        jm.geo, jnp.asarray(u), jnp.asarray(T), jm.T_specs, dt))
    got = tm._semi_lagrangian(torch.as_tensor(u), torch.as_tensor(T), dt)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-12 * float(np.abs(want).max()), err


@pytest.mark.parametrize("case", CASES)
def test_steps_and_run_match_jax(case):
    """N steps: equal iteration counts and verdicts, fields within
    STEP_TOL; the model has only K4's wrapper, launched 0 times on the
    CPU; ``run`` from the initial state, the same records, the final
    states within STEP_TOL, no escalation."""
    jm, tm = _pair(case)
    assert list(tm.kernels()) == ["tridiag"]
    js, ts = _start(jm, tm, case)
    dt = tm.params.time_step
    for k in range(N):
        js, jd = jm.step(js, dt)
        ts, d = tm.step(ts, dt)
        assert d.helmholtz_iters.tolist() == \
            np.asarray(jd.helmholtz_iters).tolist(), k
        assert d.temperature_iters == int(jd.temperature_iters), k
        assert d.poisson_iters == int(jd.poisson_iters), k
        assert d.solver_ok == bool(jd.solver_ok) and d.solver_ok, k
        assert _max_rel(js, ts) <= STEP_TOL, (case, k)
    assert float(d.max_velocity) > 1e-6
    assert tm._semi_lagrangian.calls == N
    jm, tm = _pair(case)
    js, jh = jm.run(max_steps=N)
    ts, th = tm.run(max_steps=N)
    assert len(th) == len(jh) == N
    for a, b in zip(th, jh):
        assert a["temperature_iters"] == b["temperature_iters"]
        np.testing.assert_allclose(a["max_velocity"], b["max_velocity"],
                                   rtol=1e-8, atol=1e-30)
    assert tm.escalations == 0
    assert _max_rel(js, ts) <= STEP_TOL
    assert all(k.launches == 0 for k in tm.kernels().values())


@pytest.mark.parametrize("case", CASES)
def test_multi_step_chunk_equals_steps(case):
    """A chunk of 4 (eager on the CPU) is the step loop, bitwise."""
    _, tm = _pair(case)
    s0 = tm.initial_state()
    dt = tm.params.time_step
    s = s0
    for _ in range(4):
        s, _ = tm.step(s, dt)
    c, rows, _ = tm.multi_step(s0, dt, 4)
    assert rows.shape[0] == 4 and bool((rows[:, 10] > 0.5).all())
    for x, y in zip((c.u, c.p, c.T) + tuple(c.u_faces),
                    (s.u, s.p, s.T) + tuple(s.u_faces)):
        assert torch.equal(x, y)
