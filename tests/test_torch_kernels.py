"""The kernel modules of the PyTorch port — K2 forcing, K1 Richardson +
projection head, K3 faces_div, K5 correct — through their wrappers on
CPU tensors (which take the plain PyTorch versions), held against

  * the JAX package's jnp oracles (the paths its model runs on the CPU),
    in f64 to 1e-12, and
  * the JAX Pallas kernels in interpret mode at (8, 16, 32) f32, to the
    tolerances of tests/test_pallas_richardson.py: rtol = atol = 2e-6
    for iterates and faces (and every output of K5), rtol = 1e-4,
    atol = 2e-5 * scale for the Poisson right-hand side; K2 to 1e-5 of
    the field scale.

The CUDA kernels themselves run only on a card: the test marked
``cuda`` holds them against the plain versions there (K1 and K2 also at
a shape no tile divides, one smaller than a tile, four iteration pairs,
f32 and f64; K4, the tridiagonal solve, at seven n, two layouts, f32
and f64, and on the direct solver's systems) and skips here.
"""

import copy

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
from dycoreplanet_tpu_torch.ops import stencil as tm_st
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve
from tests.test_torch_helmholtz import _random_spd_tridiag


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


# ---------------------------------------------------------------- K5
def _correct_inputs(jm, seed, dtype):
    u_star, f0, f1, f2, _, pres = _fields(jm, seed, dtype)
    phi = np.random.default_rng(seed + 1).standard_normal(
        jm.geo.cell_shape).astype(dtype)
    return u_star, (f0, f1, f2), phi, pres


@pytest.mark.parametrize("incremental", [True, False])
def test_correct_plain_vs_jnp_f64(incremental):
    """The jnp oracle of tests/test_pallas_stencil.py (post-Poisson
    stage), for the incremental and the pressure-free projection."""
    jm, tm = _models("float64", (8, 8, 16))
    tm._proj.incremental = incremental
    geo = jm.geo
    u_star, uf, phi, pres = _correct_inputs(jm, 8, np.float64)
    dt = 0.01
    jphi = jnp.asarray(phi)
    phi0 = jphi - j_st.volume_mean(geo, jphi)
    faces_ref = [jm._apply_wall_face_values(
        jnp.asarray(uf[d]) - dt * j_st.grad_left_faces(geo, phi0, d,
                                                       jm.p_specs[d]), d)
        for d in range(3)]
    gradc = jnp.stack([j_st.centered_gradient(geo, phi0, d, jm.p_specs[d])
                       for d in range(3)])
    want = ([jnp.asarray(u_star) - dt * gradc] + faces_ref
            + [jnp.asarray(pres) + phi0 if incremental else phi0])
    tphi = torch.as_tensor(phi)
    got = tm._proj.correct(torch.as_tensor(u_star), _t(uf), tphi,
                           torch.as_tensor(pres), dt,
                           tm_st.volume_mean(tm.geo, tphi))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12
    assert tm._proj.correct_count.launches == 0


@pytest.mark.parametrize("incremental", [True, False])
def test_correct_plain_vs_pallas_interpret_f32(incremental):
    jm, tm = _models("float32", (8, 16, 32))
    proj = ShellProjectionPallas(jm.geo, dtype=np.float32,
                                 incremental=incremental, interpret=True)
    tm._proj.incremental = incremental
    u_star, uf, phi, pres = _correct_inputs(jm, 9, np.float32)
    dt = np.float32(0.004)
    jphi = jnp.asarray(phi)
    want = proj.correct(jnp.asarray(u_star), tuple(_j(uf)), jphi,
                        jnp.asarray(pres), dt, j_st.volume_mean(jm.geo, jphi))
    tphi = torch.as_tensor(phi)
    got = tm._proj.correct(torch.as_tensor(u_star), _t(uf), tphi,
                           torch.as_tensor(pres), float(dt),
                           tm_st.volume_mean(tm.geo, tphi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-6,
                                   atol=2e-6)


# ---------------------------------------------------------------- card
def _k1_k2_match_plain(shape, dtype, device):
    """K2, then K1 at the iteration pairs (1,1), (2,1), (1,3), (3,3) on
    K2's output, against their plain versions on one grid: K2 1e-5 x
    scale (f64 1e-12); K1 iterates and faces rtol = atol = 2e-6 (f64
    1e-12), rhs_phi rtol 1e-4, atol 2e-5 x scale (f64 1e-11); the b norms
    rtol 1e-5 (f64 1e-12); each residual norm rn within 0.1 rn + 2 eps
    |r_pre|, r_pre the plain residual one sweep earlier (the versions
    round the last update r - A (r/D) differently, by about an ulp of
    r_pre a cell), and within eps |b| (the honesty gate's f32 floor is 16
    eps |b|)."""
    from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson

    f32 = dtype == "float32"
    _, tm = _models(dtype, shape)
    m = BoussinesqModel(tm.params, device=device)
    npd = np.float32 if f32 else np.float64
    u, f0, f1, f2, T, pres = [torch.as_tensor(x, device=device)
                              for x in _fields(tm, 11, npd)]
    dt = 0.004
    args = (u, (f0, f1, f2), T, pres, dt)
    got, want = m._forcing(*args), m._forcing.plain(*args)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= (1e-5 if f32 else 1e-12) * scale
    rhs_T = torch.as_tensor(np.random.default_rng(12).standard_normal(
        shape).astype(npd), device=device)
    eps = float(np.finfo(npd).eps)
    tol = 2e-6 if f32 else 1e-12
    for iu, iT in [(1, 1), (2, 1), (1, 3), (3, 3)]:
        rk = ShellRichardson(
            m.geo, one_over_Re=m.one_over_Re, one_over_Pe=m.one_over_Pe,
            nse_interval=m.params.NSE_solver_interval,
            helm_diags=m.helm_diags, T_diag=m.T_diag, iters_u=iu,
            iters_T=iT, u_specs=m.u_specs, T_specs_hom=m.T_specs_hom)
        a1 = (got[0], rhs_T, T, dt)
        g1, w1 = rk(*a1), rk.plain(*a1)
        for g, w in [(g1[0], w1[0]), (g1[1], w1[1])] + list(
                zip(g1[2][:3], w1[2][:3])):
            np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=tol)
        sc = float(w1[2][3].abs().max()) + 1e-30
        np.testing.assert_allclose(
            _np(g1[2][3]), _np(w1[2][3]), rtol=1e-4 if f32 else 1e-11,
            atol=(2e-5 if f32 else 1e-11) * sc)
        short = copy.copy(rk)
        short.iters_u, short.iters_T = iu - 1, iT - 1
        pre = [float(x) for x in short.plain(*a1)[3]]
        gn, wn = [float(x) for x in g1[3]], [float(x) for x in w1[3]]
        for r, b in ((0, 1), (2, 3)):
            assert abs(gn[b] - wn[b]) <= (1e-5 if f32 else 1e-12) * wn[b]
            assert abs(gn[r] - wn[r]) <= 0.1 * wn[r] + 2 * eps * pre[r]
            assert abs(gn[r] - wn[r]) <= eps * wn[b]


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
    # K5 on the K3 faces and a seeded phi
    phi = torch.as_tensor(np.random.default_rng(6).standard_normal(
        m.geo.cell_shape).astype(np.float32), device="cuda")
    args = (got[0], got3[:3], phi, pres, dt, tm_st.volume_mean(m.geo, phi))
    for g, w in zip(m._proj.correct(*args), m._proj.correct_plain(*args)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=2e-6, atol=2e-6)
    # K4 at any n (600 rows exceed what a block stages in shared memory:
    # the general kernel), m = 786 (not a multiple of 4), f32 and f64, the
    # coefficients full or broadcast as the direct solver passes them;
    # lower[0] and upper[n-1] never read, the operands bitwise unchanged
    rng = np.random.RandomState(0)
    for dtype in (np.float32, np.float64):
        for n in (1, 2, 5, 32, 33, 40, 600):
            for bcast in (False, True):
                low, diag, up = (a.astype(dtype) for a in _random_spd_tridiag(
                    rng, n, (3, 2, 131)))
                if bcast:          # one value a row, diag over the pair
                    low, up = low[:, :1, :1, :1], up[:, :1, :1, :1]
                    diag = diag[:, :, :1] + 2.0
                ops = [torch.as_tensor(np.ascontiguousarray(a), device="cuda")
                       for a in (low, diag, up,
                                 rng.randn(n, 3, 2, 131).astype(dtype))]
                want = m._tridiag.plain(*ops)
                ops[0][0] = float("nan")
                ops[2][-1] = float("nan")
                before = [a.clone() for a in ops]
                tk = TridiagSolve()
                got4 = tk(*ops)
                sc = float(want.abs().max())
                tol = (1e-5 if dtype == np.float32 else 1e-12) * sc
                np.testing.assert_allclose(_np(got4), _np(want), rtol=tol,
                                           atol=tol)
                assert (tk.launches, tk.copies) == (1, 0)
                bits = torch.int32 if dtype == np.float32 else torch.int64
                for a, b in zip(ops, before):
                    assert torch.equal(a.view(bits), b.view(bits))
    # the direct solver's systems, as it passes them
    p = copy.deepcopy(tm.params)
    p.numerics.helmholtz_solver = "direct"
    d = BoussinesqModel(p, device="cuda")
    sys4 = d.helmholtz_direct.systems(d._vol_t[None] * u, 0.004)
    want = d._tridiag.plain(*sys4)
    np.testing.assert_allclose(
        _np(d._tridiag(*sys4)), _np(want), rtol=1e-5,
        atol=1e-5 * float(want.abs().max()))
    assert (d._tridiag.launches, d._tridiag.copies) == (1, 0)
    assert m._forcing.launches == 1 and m._richardson.launches == 1
    assert m._proj.faces_div_count.launches == 1
    assert m._proj.correct_count.launches == 1
    # K1 and K2 at a shape no tile divides and one smaller than a tile
    for shape in [(6, 20, 36), (4, 8, 16)]:
        for dtype in ["float32", "float64"]:
            _k1_k2_match_plain(shape, dtype, "cuda")
