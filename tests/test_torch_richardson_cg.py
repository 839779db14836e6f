"""Richardson momentum beside CG temperature (`fixed solver iters` = 0,
`momentum fixed iters` > 0, iterative Helmholtz) in the PyTorch port
against the JAX package, on CPU in float64:

  * steps from the same seeded flow on the shell (the classic prm at
    4 x 8 x 16) and on the annulus (aqua_planet_test_2d.prm at 8 x 48):
    the momentum Richardson sweeps, the temperature CG's iterations and
    the gate's verdict equal, the fields within 1e-10 of their scale;
    ``run`` the same record for record; on the shell no K1 wrapper is
    built (the JAX factory builds no Richardson kernel there either);
  * the gate: with `helmholtz tol` far below what the sweeps reach, every
    fast step misses. The JAX model reports solver_ok false and redoes
    nothing (its gate keys on `fixed solver iters` > 0 alone, ROADMAP.md
    Queue 3); the port escalates, and its step is then the JAX model's
    ``step_strong``; ``multi_step`` the same for a chunk."""

import os
import warnings

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

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CASES = {"shell": ("aqua_planet_shell_test_3d-classic.prm", (4, 8, 16)),
         "annulus": ("aqua_planet_test_2d.prm", (8, 48))}
STEP_TOL = 1e-10
N = 3
MOMENTUM_ITERS = 2
# `helmholtz tol` that two momentum sweeps meet on the seeded flows (f64:
# |r|/|b| ~1e-3 on the shell at 4 x 8 x 16, ~1e-9 on the annulus), and
# one they cannot (the forced miss)
GATE = {"shell": dict(helmholtz_tol=1e-2, temperature_tol=1e-10),
        "annulus": dict(helmholtz_tol=1e-6, temperature_tol=1e-10)}
MISS = dict(helmholtz_tol=1e-15, temperature_tol=1e-10)


def _params(cls, case, **num):
    prm, shape = CASES[case]
    p = cls.from_file(os.path.join(DATA, prm))
    p.numerics.dtype = "float64"
    p.adapt_time_step = False
    p.final_time = 1e9
    if case == "shell":
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    else:
        p.numerics.n_radial, p.numerics.n_lon = shape
    p.numerics.helmholtz_solver = "auto"
    p.numerics.fixed_solver_iters = 0
    p.numerics.momentum_fixed_iters = MOMENTUM_ITERS
    for k, v in num.items():
        setattr(p.numerics, k, v)
    return p


def _pair(case, **num):
    return (JModel(_params(JParameters, case, **num)),
            BoussinesqModel(_params(Parameters, case, **num), device="cpu"))


def _seeded(jm, tm, seed=3):
    """The same seeded flow in both packages: random velocity, its faces,
    a random pressure, the initial temperature."""
    rng = np.random.default_rng(seed)
    dim = jm.geo.dim
    u = jnp.asarray(0.05 * rng.standard_normal((dim,) + jm.geo.cell_shape))
    faces = tuple(jm._apply_wall_face_values(
        jm._interp_component_to_faces(u[c], c), c) for c in range(dim))
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
        want = np.asarray(want)
        out = max(out, float(np.max(np.abs(got - want)))
                  / max(float(np.max(np.abs(want))), 1e-30))
    return out


def _same_counts(d, jd):
    assert d.helmholtz_iters.tolist() == \
        np.asarray(jd.helmholtz_iters).tolist()
    assert d.temperature_iters == int(jd.temperature_iters)
    assert d.poisson_iters == int(jd.poisson_iters)
    assert d.solver_ok == bool(jd.solver_ok)


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    """N steps from the seeded flow: Richardson momentum (MOMENTUM_ITERS
    sweeps, the gate met), CG temperature, the fields within STEP_TOL."""
    jm, tm = _pair(case, **GATE[case])
    if case == "shell":
        assert "richardson" not in tm.kernels()
        assert {"forcing", "faces_div", "correct"} <= set(tm.kernels())
    assert tm._fixed_gate and not tm._graphable(False, False)
    js, ts = _seeded(jm, tm)
    dt = tm.params.time_step
    for k in range(N):
        js, jd = jm.step(js, dt)
        ts, d = tm.step(ts, dt)
        _same_counts(d, jd)
        assert d.helmholtz_iters[0] == MOMENTUM_ITERS and d.solver_ok
        assert d.temperature_iters > 0
        assert _max_rel(js, ts) <= STEP_TOL, (case, k)
    assert all(k.launches == 0 for k in tm.kernels().values())


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_jax(case):
    """``run`` for N steps from the initial state: the same records, no
    escalation, the final states within STEP_TOL."""
    jm, tm = _pair(case, **GATE[case])
    js, jh = jm.run(max_steps=N)
    ts, th = tm.run(max_steps=N)
    assert len(th) == len(jh) == N
    for a, b in zip(th, jh):
        assert a["temperature_iters"] == b["temperature_iters"]
        assert a["poisson_iters"] == b["poisson_iters"]
        np.testing.assert_allclose(a["max_velocity"], b["max_velocity"],
                                   rtol=1e-8)
    assert tm.escalations == 0 and jm._strong_steps_left == 0
    assert _max_rel(js, ts) <= STEP_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_momentum_miss_escalates_in_the_port_only(case):
    """`helmholtz tol` 1e-15: the momentum sweeps miss on every fast step.
    The JAX model's run keeps the missed steps (solver_ok false, no
    escalation: its gate keys on `fixed solver iters` > 0); the port's run
    escalates at the first step and redoes it with CG, so its first step
    is the JAX model's step_strong from the same state. ``multi_step``
    from a seeded flow: the JAX chunk reports the miss and keeps it, the
    port's is redone with CG and passes the gate."""
    jm, tm = _pair(case, **MISS)
    js0, ts0 = _seeded(jm, tm)
    dt = tm.params.time_step
    _, jd = jm.step(js0, dt)
    _, td = tm.step(ts0, dt)
    assert not bool(jd.solver_ok) and not td.solver_ok   # the same miss
    # from the initial state (the JAX run takes no other): the JAX run
    # keeps its missed steps, no escalation window opened
    _, jd = jm.step(jm.initial_state(), dt)
    assert not bool(jd.solver_ok)
    _, jh = jm.run(max_steps=2)
    assert jm._strong_steps_left == 0 and len(jh) == 2
    # the port's run: escalated at step 0, the step redone with CG
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ts1, th = tm.run(max_steps=1)
    assert tm.escalations == 1 and tm._strong_steps_left > 0
    js1, jd1 = jm.step_strong(jm.initial_state(), dt)
    assert bool(jd1.solver_ok)
    assert th[0]["temperature_iters"] == int(jd1.temperature_iters)
    assert _max_rel(js1, ts1) <= STEP_TOL
    # multi_step: a chunk of 2
    jm2, tm2 = _pair(case, **MISS)
    _, jrows, _ = jm2.multi_step(js0, dt, 2)
    assert jm2._strong_steps_left == 0
    assert not np.asarray(jrows)[:, 10].all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ts2, rows, _ = tm2.multi_step(ts0, dt, 2)
    assert tm2.escalations == 1
    assert bool((rows[:, 10] > 0.5).all())
    js2, _, _ = jm2.multi_step(js0, dt, 2, force_cg=True)
    assert _max_rel(js2, ts2) <= STEP_TOL
    assert bool(torch.isfinite(ts2.u).all())
