"""The kernel modules of the PyTorch port — K2 forcing, K1 Richardson +
projection head, K3 faces_div — through their wrappers on CPU tensors
(which take the plain PyTorch versions), held against

  * the JAX package's jnp oracles (the paths its model runs on the CPU),
    in f64 to 1e-12, and
  * the JAX Pallas kernels in interpret mode at (8, 16, 32) f32, to the
    tolerances of tests/test_pallas_richardson.py: rtol = atol = 2e-6
    for iterates and faces, rtol = 1e-4, atol = 2e-5 * scale for the
    Poisson right-hand side; K2 to 1e-5 of the field scale.

The CUDA kernels themselves run only on a card: the test marked
``cuda`` holds them against the plain versions there and skips here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import stencil as j_st
from dycoreplanet_tpu.ops.pallas_richardson import make_richardson
from dycoreplanet_tpu.ops.pallas_stencil import (
    ShellProjectionPallas, make_shell_forcing)
from dycoreplanet_tpu.solvers.fixed import richardson_solve as j_rich
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel


def _configure(p, dtype, shape, scheme="muscl", coriolis="reference",
               buoyancy="perturbation", iters=2, iters_u=0):
    p.space_dimension = 3
    p.cuboid_geometry = False
    p.numerics.dtype = dtype
    p.numerics.advection_scheme = scheme
    p.numerics.coriolis_mode = coriolis
    p.numerics.buoyancy = buoyancy
    p.numerics.fixed_solver_iters = iters
    p.numerics.momentum_fixed_iters = iters_u
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = shape
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.omega = 0.7
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    return p


def _models(dtype, shape, **kw):
    jm = JModel(_configure(JParameters.from_text(""), dtype, shape, **kw))
    tm = BoussinesqModel(_configure(Parameters.from_text(""), dtype, shape,
                                    **kw), device="cpu")
    return jm, tm


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(got, want):
    want = _np(want)
    return float(np.max(np.abs(_np(got) - want))) / max(
        float(np.max(np.abs(want))), 1e-300)


def _fields(m, seed, dtype):
    rng = np.random.default_rng(seed)
    shape = m.geo.cell_shape
    u = rng.standard_normal((3,) + shape)
    faces = [rng.standard_normal(shape) for _ in range(3)]
    T = np.asarray(m.T_init) + 0.1 * rng.standard_normal(shape)
    pres = rng.standard_normal(shape)
    return [np.asarray(x, dtype) for x in (u, *faces, T, pres)]


def _t(xs):
    return [torch.as_tensor(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------- K2
@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
@pytest.mark.parametrize("coriolis", ["reference", "physical"])
@pytest.mark.parametrize("buoyancy", ["perturbation", "full"])
def test_forcing_plain_vs_jnp_f64(scheme, coriolis, buoyancy):
    jm, tm = _models("float64", (8, 8, 16), scheme=scheme,
                     coriolis=coriolis, buoyancy=buoyancy)
    u, f0, f1, f2, T, pres = _fields(jm, 0, np.float64)
    dt = 0.01
    ju, jf, jT, jp = jnp.asarray(u), _j([f0, f1, f2]), jnp.asarray(T), \
        jnp.asarray(pres)
    want_u = ju + dt * jm._explicit_forcing(ju, jf, jp, jT)
    want_T = jT - dt * j_st.advect_scalar(jm.geo, jf, jT, jm.T_specs,
                                          scheme=scheme, form="advective")
    rhs_u, T_adv = tm._forcing(torch.as_tensor(u), _t([f0, f1, f2]),
                               torch.as_tensor(T), torch.as_tensor(pres), dt)
    assert _rel(rhs_u, want_u) <= 1e-12
    assert _rel(T_adv, want_T) <= 1e-12


@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
@pytest.mark.parametrize("coriolis,buoyancy",
                         [("reference", "perturbation"), ("physical", "full")])
def test_forcing_plain_vs_pallas_interpret_f32(scheme, coriolis, buoyancy):
    jm, tm = _models("float32", (8, 16, 32), scheme=scheme,
                     coriolis=coriolis, buoyancy=buoyancy)
    pall = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    assert pall is not None and pall.advect_T
    u, f0, f1, f2, T, pres = _fields(jm, 1, np.float32)
    dt = np.float32(0.004)
    want_u, want_T = pall(jnp.asarray(u), tuple(_j([f0, f1, f2])),
                          jnp.asarray(T), jnp.asarray(pres), dt)
    rhs_u, T_adv = tm._forcing(torch.as_tensor(u), _t([f0, f1, f2]),
                               torch.as_tensor(T), torch.as_tensor(pres),
                               float(dt))
    assert _rel(rhs_u, want_u) <= 1e-5
    assert _rel(T_adv, want_T) <= 1e-5


# ---------------------------------------------------------------- K1
def _richardson_oracle(jm, rhs_u, rhs_T, T0, dt):
    """The JAX package's jnp fast path: both Richardson solves + the
    faces/Poisson-RHS block of _project_velocity (as in
    tests/test_pallas_richardson.py)."""
    geo = jm.geo
    p = jm.params
    vol = jnp.asarray(jm.vol, rhs_u.dtype)
    coef = dt * jm.one_over_Re
    kT = (dt / p.NSE_solver_interval) * jm.one_over_Pe

    def helm_op(x):
        return vol[None] * x - coef * jnp.stack([
            j_st.weak_laplacian(geo, x[c], jm.u_specs[c]) for c in range(3)])

    res_u = j_rich(helm_op, vol[None] * rhs_u, rhs_u,
                   diag=vol[None] + coef * jnp.asarray(jm.helm_diags),
                   iters=jm.momentum_iters, rtol=p.numerics.helmholtz_tol)

    def temp_op(x):
        return vol * x - kT * j_st.weak_laplacian(geo, x, jm.T_specs_hom)

    res_T = j_rich(temp_op, rhs_T, T0, diag=vol + kT * jnp.asarray(jm.T_diag),
                   iters=p.numerics.fixed_solver_iters,
                   rtol=p.numerics.temperature_tol)
    uf = [jm._apply_wall_face_values(
        jm._interp_component_to_faces(res_u.x[c], c), c) for c in range(3)]
    rhs_phi = -vol * j_st.divergence(geo, uf) / dt
    rhs_phi = rhs_phi - jnp.mean(rhs_phi)
    bn_u = jnp.sqrt(jnp.sum((vol[None] * rhs_u) ** 2))
    bn_T = jnp.sqrt(jnp.sum(rhs_T ** 2))
    return (res_u.x, res_T.x, uf + [rhs_phi],
            (res_u.residual_norm, bn_u, res_T.residual_norm, bn_T))


def _rand_rhs(m, seed, dtype):
    rng = np.random.RandomState(seed)
    shp = m.geo.cell_shape
    return [np.asarray(x, dtype) for x in (rng.randn(3, *shp),
                                           rng.randn(*shp), rng.randn(*shp))]


@pytest.mark.parametrize("iters,iters_u", [(1, 1), (2, 0), (3, 0), (2, 1),
                                           (1, 3)])
def test_richardson_plain_vs_jnp_f64(iters, iters_u):
    jm, tm = _models("float64", (4, 8, 16), iters=iters, iters_u=iters_u)
    rhs_u, rhs_T, T0 = _rand_rhs(jm, 3, np.float64)
    dt = 0.004
    want = _richardson_oracle(jm, *_j([rhs_u, rhs_T, T0]), dt)
    u_star, T_new, pre, norms = tm._richardson(*_t([rhs_u, rhs_T, T0]), dt)
    assert _rel(u_star, want[0]) <= 1e-12
    assert _rel(T_new, want[1]) <= 1e-12
    for g, w in zip(pre, want[2]):
        assert _rel(g, w) <= 1e-12
    for g, w in zip(norms, want[3]):
        # tracked residuals sit near round-off: compare to 1e-9 relative
        assert abs(float(g) - float(w)) <= 1e-9 * abs(float(w)) + 1e-300


@pytest.mark.parametrize("iters,iters_u", [(1, 1), (2, 0), (2, 1)])
def test_richardson_plain_vs_pallas_interpret_f32(iters, iters_u):
    jm, tm = _models("float32", (8, 16, 32), iters=iters, iters_u=iters_u)
    kern = make_richardson(jm.geo, jm, interpret=True, use_pallas=True)
    assert kern is not None
    rhs_u, rhs_T, T0 = _rand_rhs(jm, 7, np.float32)
    dt = np.float32(0.004)
    w_u, w_T, w_pre, _ = kern(*_j([rhs_u, rhs_T, T0]), dt)
    u_star, T_new, pre, _ = tm._richardson(*_t([rhs_u, rhs_T, T0]),
                                           float(dt))
    for g, w in [(u_star, w_u), (T_new, w_T)] + list(zip(pre[:3],
                                                          w_pre[:3])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-6,
                                   atol=2e-6)
    scale = float(jnp.max(jnp.abs(w_pre[3]))) + 1e-30
    np.testing.assert_allclose(_np(pre[3]), np.asarray(w_pre[3]),
                               rtol=1e-4, atol=2e-5 * scale)


# ---------------------------------------------------------------- K3
def test_faces_div_plain_vs_jnp_f64():
    jm, tm = _models("float64", (8, 8, 16))
    u_star = _fields(jm, 4, np.float64)[0]
    dt = 0.01
    ju = jnp.asarray(u_star)
    uf = [jm._apply_wall_face_values(jm._interp_component_to_faces(ju[c], c),
                                     c) for c in range(3)]
    vol = jnp.asarray(jm.vol)
    rhs = -vol * j_st.divergence(jm.geo, uf) / dt
    f0, f1, f2, rhs_raw, total = tm._proj.faces_div(torch.as_tensor(u_star),
                                                    dt)
    for g, w in zip((f0, f1, f2, rhs_raw), uf + [rhs]):
        assert _rel(g, w) <= 1e-12
    assert abs(float(total) - float(jnp.sum(rhs))) <= \
        1e-12 * float(jnp.sum(jnp.abs(rhs)))


def test_faces_div_plain_vs_pallas_interpret_f32():
    jm, tm = _models("float32", (8, 16, 32))
    proj = ShellProjectionPallas(jm.geo, dtype=np.float32, incremental=True,
                                 interpret=True)
    u_star = _fields(jm, 5, np.float32)[0]
    dt = np.float32(0.004)
    w0, w1, w2, w_rhs, w_ps = proj.faces_div(jnp.asarray(u_star), dt)
    f0, f1, f2, rhs_raw, total = tm._proj.faces_div(torch.as_tensor(u_star),
                                                    float(dt))
    for g, w in zip((f0, f1, f2), (w0, w1, w2)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-6,
                                   atol=2e-6)
    scale = float(jnp.max(jnp.abs(w_rhs))) + 1e-30
    n = jm.geo.n_cells
    np.testing.assert_allclose(
        _np(rhs_raw - total / n),
        np.asarray(w_rhs - jnp.sum(w_ps) / n), rtol=1e-4, atol=2e-5 * scale)


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a card: each CUDA kernel against its plain version (the same
    check chip_smoke.py makes at full width, here at (8, 16, 32))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    jm, tm = _models("float32", (8, 16, 32))
    m = BoussinesqModel(tm.params, device="cuda")
    u, f0, f1, f2, T, pres = [torch.as_tensor(x, device="cuda")
                              for x in _fields(jm, 6, np.float32)]
    dt = 0.004
    args = (u, (f0, f1, f2), T, pres, dt)
    got, want = m._forcing(*args), m._forcing.plain(*args)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    args = (got[0], got[1], T, dt)
    got, want = m._richardson(*args), m._richardson.plain(*args)
    for g, w in [(got[0], want[0]), (got[1], want[1])] + list(
            zip(got[2][:3], want[2][:3])):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-6, atol=2e-6)
    got3, want3 = m._proj.faces_div(got[0], dt), m._proj.plain(got[0], dt)
    for g, w in zip(got3[:3], want3[:3]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-6, atol=2e-6)
    assert m._forcing.launches == 1 and m._richardson.launches == 1
    assert m._proj.launches == 1
