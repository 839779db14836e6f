"""The port's bfloat16 model against the JAX package's, on the CPU, and
the JAX package's bfloat16 faults pinned.

One step from the same bfloat16 state (a seeded flow, each value rounded
to bfloat16 once) on every configuration the JAX package steps in
bfloat16 (multigrid aside: ``tests/test_torch_bf16.py`` holds the port's
bf16 multigrid against its f32 one), both held against the float64 step
of the JAX package from the same values: each field's error may exceed
the JAX package's by at most TOL = 2^-7 of its scale (two bfloat16
ulps). Then three annulus steps against float64 at the JAX test's bounds
(tests/test_mixed_precision.py: 10% of the max velocity, div_norm <
1e-2), every field bfloat16 after every step, ``multi_step`` bitwise
``run``.

The JAX package's faults (ROADMAP.md Queue 3): its bfloat16 temperature
leaves bfloat16 at the first step (the Dirichlet ghost's host constant
promotes it), so its ``multi_step`` raises on the scan's carry, and its
``time`` stays bfloat16, so that 4.0 + 0.01 is 4.0. The port keeps every
field bfloat16 and ``time`` in float32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import source_info_util

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import make_model as j_make_model
from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import make_model
from dycoreplanet_tpu_torch.models.convert import (
    state_from_numpy, state_to_numpy)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
TOL = 2.0 ** -7
DT = 0.01
SHELL = {"numerics.n_radial": 4, "numerics.n_lat": 8, "numerics.n_lon": 16}
ANNULUS = {"numerics.n_radial": 8, "numerics.n_lon": 48}
CUBE = {"numerics.nz": 8, "numerics.ny": 8, "numerics.nx": 8}
CASES = {
    "shell": ("aqua_planet_shell_test_3d-classic.prm", SHELL),
    "shell_direct": ("aqua_planet_shell_test_3d-classic.prm",
                     dict(SHELL, **{"numerics.helmholtz_solver": "direct"})),
    "shell_sl": ("aqua_planet_shell_test_3d-classic.prm", dict(
        SHELL, **{"numerics.temperature_advection": "semi-lagrangian"})),
    "shell_feec": ("aqua_planet_shell_test_3d-feec.prm", SHELL),
    "shell_mimetic": ("aqua_planet_shell_test_3d-feec.prm", dict(
        SHELL, **{"numerics.feec_formulation": "staggered"})),
    "annulus": ("aqua_planet_test_2d.prm", ANNULUS),
    "annulus_direct": ("aqua_planet_test_2d.prm", dict(
        ANNULUS, **{"numerics.helmholtz_solver": "direct"})),
    "annulus_sl": ("aqua_planet_test_2d.prm", dict(
        ANNULUS, **{"numerics.temperature_advection": "semi-lagrangian"})),
    "cube": ("aqua_planet_cube_test_3d.prm", CUBE),
}


def _params(cls, case, dtype):
    name, settings = CASES[case]
    p = cls.from_file(os.path.join(DATA, name))
    p.numerics.dtype = dtype
    p.adapt_time_step = False
    p.final_time = 1e9
    for key, value in settings.items():
        obj = p
        for part in key.split(".")[:-1]:
            obj = getattr(obj, part)
        setattr(obj, key.split(".")[-1], value)
    return p


def _seeded(tm, seed=0, amp=0.05):
    """A seeded flow as numpy arrays, each value rounded to bfloat16: a
    random cell velocity, its face interpolant (the port's, in float64),
    a random pressure and the initial temperature. (u, faces, p, T)."""
    rng = np.random.default_rng(seed)
    shp, dim = tm.geo.cell_shape, tm.geo.dim
    u = amp * rng.standard_normal((dim,) + shp)
    faces = [f.numpy() for f in tm.interp_to_faces(torch.as_tensor(u))]
    p = 0.01 * rng.standard_normal(shp)
    T = np.asarray(tm.T_init, np.float64)
    return [dtypes.round_bf16(x) for x in (u, *faces, p, T)]


def _jax_state(jm, arrays, dtype):
    u, *faces, p, T = arrays
    j = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    return jm.initial_state()._replace(u=j(u), u_faces=tuple(
        j(f) for f in faces), p=j(p), T=j(T))


def _fields(state):
    """u, the faces, p and T of either package's state as float64
    numpy."""
    if torch.is_tensor(state.u):
        u, faces, p, T, _, _ = state_to_numpy(state)
    else:
        u, faces, p, T = state.u, state.u_faces, state.p, state.T
    return [np.asarray(x, np.float64) for x in (u, *faces, p, T)]


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_vs_jax(case):
    """One step from the same bf16 state: the port's bf16 step and the
    JAX package's, each against the JAX package's f64 step."""
    tm = make_model(_params(Parameters, case, "bfloat16"), device="cpu")
    j16 = j_make_model(_params(JParameters, case, "bfloat16"))
    j64 = j_make_model(_params(JParameters, case, "float64"))
    arrays = _seeded(tm)
    u, *faces, p, T = arrays
    ts = state_from_numpy(tm, u, faces, p, T)
    t1, td = tm.step(ts, DT)
    j1, _ = j16.step(_jax_state(j16, arrays, jnp.bfloat16), DT)
    r1, rd = j64.step(_jax_state(j64, arrays, jnp.float64), DT)
    for x in (t1.u, t1.p, t1.T) + tuple(t1.u_faces):
        assert x.dtype == torch.bfloat16
    names = ["u"] + [f"face {d}" for d in range(len(faces))] + ["p", "T"]
    for name, g, j, r in zip(names, _fields(t1), _fields(j1), _fields(r1)):
        scale = max(float(np.max(np.abs(r))), 1e-30)
        e_port = float(np.max(np.abs(g - r))) / scale
        e_jax = float(np.max(np.abs(j - r))) / scale
        assert e_port <= e_jax + TOL, (case, name, e_port, e_jax)
    assert np.isfinite(td.max_velocity)
    assert t1.time == pytest.approx(DT, rel=2.0 ** -8)


def _annulus(cls, dtype):
    """tests/test_mixed_precision.py's annulus (8 x 48, dt 0.01)."""
    p = cls.from_text("")
    p.space_dimension = 2
    p.numerics.dtype = dtype
    p.numerics.n_radial, p.numerics.n_lon = 8, 48
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.expansion_coefficient = 0.3
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    p.time_step = DT
    return p


def test_three_steps_track_float64_and_stay_bf16():
    """The JAX test's bf16 trajectory in the port: three steps within 10%
    of the f64 max velocity, div_norm < 1e-2, every field bfloat16 and
    time float32 after every step; multi_step (3 steps in one chunk)
    bitwise run's state."""
    m16 = make_model(_annulus(Parameters, "bfloat16"), device="cpu")
    m64 = make_model(_annulus(Parameters, "float64"), device="cpu")
    s16, s64 = m16.initial_state(), m64.initial_state()
    for n in range(3):
        s16, d16 = m16.step(s16, DT)
        s64, d64 = m64.step(s64, DT)
        for x in (s16.u, s16.p, s16.T) + tuple(s16.u_faces):
            assert x.dtype == torch.bfloat16
        assert s16.time == float(np.float32(s16.time))
        assert abs(d16.max_velocity - d64.max_velocity) < 0.1 * max(
            d64.max_velocity, 1e-6)
        assert d16.div_norm < 1e-2
    m16b = make_model(_annulus(Parameters, "bfloat16"), device="cpu")
    sc, rows, _ = m16b.multi_step(m16b.initial_state(), DT, 3)
    assert rows.shape[0] == 3 and bool((rows[:, 10] == 1).all())
    for x, y in zip((sc.u, sc.p, sc.T) + tuple(sc.u_faces),
                    (s16.u, s16.p, s16.T) + tuple(s16.u_faces)):
        assert torch.equal(x, y)
    assert sc.time == s16.time and sc.step_number == 3


def _first_widening(jaxpr, tainted):
    """The first operation of ``jaxpr`` that turns a bfloat16 value
    derived from the ``tainted`` inputs into float32 or float64: (its
    primitive, its source line), or None."""
    for eqn in jaxpr.eqns:
        hit = [v for v in eqn.invars if not isinstance(
            v, jax.extend.core.Literal) and v in tainted]
        if not hit:
            continue
        sub = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
        if sub is not None:
            inner = getattr(sub, "jaxpr", sub)
            found = _first_widening(inner, {
                w for v, w in zip(eqn.invars, inner.invars)
                if not isinstance(v, jax.extend.core.Literal)
                and v in tainted})
            if found:
                return found
        if (any(v.aval.dtype == jnp.bfloat16 for v in hit)
                and any(v.aval.dtype in (jnp.float32, jnp.float64)
                        for v in eqn.outvars)):
            return (eqn.primitive.name,
                    source_info_util.summarize(eqn.source_info))
        tainted.update(eqn.outvars)
    return None


def test_jax_bf16_temperature_leaves_bf16_at_the_dirichlet_ghost():
    """The JAX package's bf16 annulus: after one step T is no longer
    bfloat16. A walk of the Eulerian transport's jaxpr from T finds the
    first widening in ops/bc.py ``_ghost``, the Dirichlet ghost 2 value -
    interior: the wall value is a host ml_dtypes bfloat16 array, and 2.0
    times it is a float32 array on the host. The port's T stays
    bfloat16."""
    jm = j_make_model(_annulus(JParameters, "bfloat16"))
    js = jm.initial_state()
    assert js.T.dtype == jnp.bfloat16
    j1, _ = jm.step(js, DT)
    assert j1.T.dtype != jnp.bfloat16
    wall = jm.T_specs[0].lo_value
    assert wall.dtype.name == "bfloat16" and (2.0 * wall).dtype == np.float32
    closed = jax.make_jaxpr(lambda u, uf, T: jm._advected_temperature(
        u, uf, T, jnp.asarray(DT, jnp.bfloat16)))(js.u, js.u_faces, js.T)
    assert closed.out_avals[0].dtype != jnp.bfloat16
    prim, where = _first_widening(closed.jaxpr, {closed.jaxpr.invars[-1]})
    assert prim == "convert_element_type"
    assert "ops/bc.py" in where and "_ghost" in where, where
    tm = make_model(_annulus(Parameters, "bfloat16"), device="cpu")
    t1, _ = tm.step(tm.initial_state(), DT)
    assert t1.T.dtype == torch.bfloat16


def test_jax_bf16_multi_step_raises_where_the_port_runs():
    """The JAX package's multi_step scans the step; the carry's T changes
    dtype, which lax.scan refuses. The port's multi_step runs."""
    jm = j_make_model(_annulus(JParameters, "bfloat16"))
    with pytest.raises(TypeError, match="carry"):
        jm.multi_step(jm.initial_state(), DT, 2)
    tm = make_model(_annulus(Parameters, "bfloat16"), device="cpu")
    s, rows, _ = tm.multi_step(tm.initial_state(), DT, 2)
    assert s.T.dtype == torch.bfloat16 and s.step_number == 2


def test_jax_bf16_time_stalls_where_the_port_advances():
    """dt 0.01 is 0.010009765625 in bfloat16, and the JAX package keeps
    time in bfloat16: from time 4.0 a step leaves it at 4.0 (its ulp there
    is 2^-5), so 1000 steps from 0 end at 4.0. The port adds the same dt
    in float32."""
    assert dtypes.round_scalar(DT, torch.bfloat16) == 0.010009765625
    jm = j_make_model(_annulus(JParameters, "bfloat16"))
    js = jm.initial_state()._replace(time=jnp.asarray(4.0, jnp.bfloat16))
    j1, _ = jm.step(js, DT)
    assert j1.time.dtype == jnp.bfloat16 and float(j1.time) == 4.0
    tm = make_model(_annulus(Parameters, "bfloat16"), device="cpu")
    t1, _ = tm.step(tm.initial_state()._replace(time=4.0), DT)
    assert t1.time == float(np.float32(4.0) + np.float32(0.010009765625))
    assert t1.time > 4.01
