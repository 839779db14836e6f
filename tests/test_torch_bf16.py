"""The bfloat16 forms of the kernel modules — K2 with and without the
temperature transport, K1 (and its residual-free K1u), K3, K5 and K4 —
through their wrappers on CPU tensors (the plain versions), on the CPU.

A bfloat16 kernel of the port reads bfloat16, computes in float32 and
rounds each output once; its plain version is the float32 plain version
on the widened inputs, each output rounded once, which the first test
pins bit for bit. The JAX Pallas kernels in interpret mode take the
state dtype and compute in it. Both get the same inputs, made from a
seed and rounded to bfloat16 once, and both are held against the
float32 result of the same inputs: the port's error may exceed the JAX
kernel's by at most TOL = 2^-7 of each output's scale (two bfloat16
ulps). K4 in bfloat16 (a bfloat16 rhs, the multigrid line smoother's)
is held against the float64 solution of the same rounded system; the
line solve and a multigrid run against the port's float32 ones, and
the JAX package's bfloat16 line solve pinned. The CUDA forms run on the
card (chip_smoke.py phase 12).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import stencil as j_st
from dycoreplanet_tpu.ops.pallas_richardson import make_richardson
from dycoreplanet_tpu.ops.pallas_stencil import (
    ShellProjectionPallas, make_shell_forcing)
from dycoreplanet_tpu.solvers.multigrid import (
    PoissonMultigrid as JPoissonMultigrid)
from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.ops import stencil as tm_st
from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson
from dycoreplanet_tpu_torch.ops.tridiag import TridiagSolve
from dycoreplanet_tpu_torch.solvers.multigrid import PoissonMultigrid
from tests.test_torch_kernels import _configure

SHAPE = (4, 8, 16)
PRM = os.path.join(os.path.dirname(__file__), "..", "data",
                   "aqua_planet_shell_test_3d-classic.prm")
TOL = 2.0 ** -7
BF = torch.bfloat16
DT = 0.004      # a bfloat16 value's neighbour: the models round it


def _models(**kw):
    """(JAX bf16 model, port bf16 model, port f32 model) of one setup."""
    sl = kw.pop("sl", False)

    def cfg(cls, dtype):
        p = _configure(cls.from_text(""), dtype, SHAPE, **kw)
        if sl:
            p.numerics.temperature_advection = "semi-lagrangian"
        return p

    return (JModel(cfg(JParameters, "bfloat16")),
            BoussinesqModel(cfg(Parameters, "bfloat16"), device="cpu"),
            BoussinesqModel(cfg(Parameters, "float32"), device="cpu"))


def _inputs(m, seed, n):
    """n seeded cell-shaped float32 arrays (the first a 3-component
    stack), each value rounded to bfloat16 once; T near the model's."""
    rng = np.random.default_rng(seed)
    shp = m.geo.cell_shape
    out = [rng.standard_normal((3,) + shp)] + [
        rng.standard_normal(shp) for _ in range(n - 1)]
    return [dtypes.round_bf16(x) for x in out]


def _j(xs):
    return [jnp.asarray(x, jnp.bfloat16) for x in xs]


def _t(xs, dtype=BF):
    return [torch.as_tensor(x).to(dtype) for x in xs]


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _hold(name, port, jax, ref):
    """Each output: max|port - ref| <= max|jax - ref| + TOL x scale, the
    scale max|ref|; the port's outputs bfloat16. Returns the errors."""
    errs = []
    for k, (p, j, r) in enumerate(zip(port, jax, ref)):
        assert p.dtype == BF, f"{name} output {k}: {p.dtype}"
        r = _f32(r)
        scale = max(float(np.max(np.abs(r))), 1e-30)
        e_p = float(np.max(np.abs(_f32(p) - r))) / scale
        e_j = float(np.max(np.abs(_f32(j) - r))) / scale
        assert e_p <= e_j + TOL, f"{name} output {k}: port {e_p:.3e}, " \
            f"JAX {e_j:.3e} (tol +{TOL})"
        errs.append((e_p, e_j))
    return errs


def test_plain_bf16_is_f32_rounded_once():
    """Every bf16 plain version: the same wrapper's f32 plain version on
    the widened inputs, each field output rounded once, bit for bit; K1's
    norms and K3's sum stay float32."""
    _, tb, _ = _models(iters=1, iters_u=1)
    t32 = tb
    u, f0, f1, f2, T, pres = _inputs(tb, 1, 6)
    a16 = (*_t([u]), tuple(_t([f0, f1, f2])), *_t([T, pres]))
    a32 = (*_t([u], torch.float32), tuple(_t([f0, f1, f2], torch.float32)),
           *_t([T, pres], torch.float32))
    for g, w in zip(tb._forcing(*a16, DT), t32._forcing(*a32, DT)):
        assert torch.equal(g, w.to(BF))
    g1 = tb._richardson(a16[0], a16[2], a16[2], DT)
    w1 = t32._richardson(a32[0], a32[2], a32[2], DT)
    for g, w in zip((g1[0], g1[1]) + tuple(g1[2]),
                    (w1[0], w1[1]) + tuple(w1[2])):
        assert torch.equal(g, w.to(BF))
    for g, w in zip(g1[3], w1[3]):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    g3, w3 = tb._proj.faces_div(a16[0], DT), t32._proj.faces_div(a32[0], DT)
    for g, w in zip(g3[:4], w3[:4]):
        assert torch.equal(g, w.to(BF))
    assert g3[4].dtype == torch.float32 and torch.equal(g3[4], w3[4])


@pytest.mark.parametrize("sl", [False, True], ids=["K2", "K2m"])
def test_forcing_bf16_vs_pallas_interpret(sl):
    """K2 (with T) and K2m (without), the Pallas kernel at bf16."""
    jm, tb, t32 = _models(sl=sl)
    pall = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    assert pall is not None and pall.advect_T == (not sl)
    assert tb._forcing.advect_T == (not sl)
    u, f0, f1, f2, T, pres = _inputs(tb, 2, 6)
    T = dtypes.round_bf16(np.asarray(tb.T_init) + 0.1 * T)
    want = pall(*_j([u]), tuple(_j([f0, f1, f2])), *_j([T, pres]),
                jnp.asarray(DT, jnp.bfloat16))
    got = tb._forcing(*_t([u]), tuple(_t([f0, f1, f2])), *_t([T, pres]),
                      tb._scalar(DT))
    ref = t32._forcing(*_t([u], torch.float32),
                       tuple(_t([f0, f1, f2], torch.float32)),
                       *_t([T, pres], torch.float32), tb._scalar(DT))
    if sl:
        want, got, ref = (want,), (got,), (ref,)
    _hold("K2m" if sl else "K2", got, want, ref)


@pytest.mark.parametrize("iters,iters_u", [(1, 1), (2, 1)])
def test_richardson_bf16_vs_pallas_interpret(iters, iters_u):
    """K1: u*, T_new, the three faces and rhs_phi."""
    jm, tb, t32 = _models(iters=iters, iters_u=iters_u)
    kern = make_richardson(jm.geo, jm, interpret=True, use_pallas=True)
    assert kern is not None
    rhs_u, rhs_T, T0 = _inputs(tb, 3, 3)
    dt = tb._scalar(DT)
    w_u, w_T, w_pre, _ = kern(*_j([rhs_u, rhs_T, T0]),
                              jnp.asarray(dt, jnp.bfloat16))
    g_u, g_T, g_pre, g_n = tb._richardson(*_t([rhs_u, rhs_T, T0]), dt)
    r_u, r_T, r_pre, r_n = t32._richardson(
        *_t([rhs_u, rhs_T, T0], torch.float32), dt)
    _hold("K1", [g_u, g_T, *g_pre], [w_u, w_T, *w_pre],
          [r_u, r_T, *r_pre])
    # the norms float32 (the JAX kernel's are bf16); the b norms of the
    # same inputs within TOL of the f32 model's
    assert all(g.dtype == torch.float32 for g in g_n)
    for k in (1, 3):
        assert abs(float(g_n[k]) - float(r_n[k])) <= TOL * float(r_n[k])


def _residual_free(m):
    """K1u of model m (the wrapper a `residual check interval` > 1 model
    builds)."""
    return ShellRichardson(
        m.geo, one_over_Re=m.one_over_Re, one_over_Pe=m.one_over_Pe,
        nse_interval=m.params.NSE_solver_interval, helm_diags=m.helm_diags,
        T_diag=m.T_diag, iters_u=m.momentum_iters,
        iters_T=m.params.numerics.fixed_solver_iters, u_specs=m.u_specs,
        T_specs_hom=m.T_specs_hom, track_residual=False)


def test_richardson_free_bf16_vs_pallas_interpret():
    """K1u: the residual-free variant, norms -1."""
    jm, tb, t32 = _models(iters=2, iters_u=1)
    kern = make_richardson(jm.geo, jm, interpret=True, use_pallas=True,
                           track_residual=False)
    rhs_u, rhs_T, T0 = _inputs(tb, 4, 3)
    dt = tb._scalar(DT)
    w = kern(*_j([rhs_u, rhs_T, T0]), jnp.asarray(dt, jnp.bfloat16))
    g = _residual_free(tb)(*_t([rhs_u, rhs_T, T0]), dt)
    r = _residual_free(t32)(*_t([rhs_u, rhs_T, T0], torch.float32), dt)
    _hold("K1u", [g[0], g[1], *g[2]], [w[0], w[1], *w[2]],
          [r[0], r[1], *r[2]])
    assert float(g[3][0]) == float(g[3][2]) == -1.0


def test_faces_div_bf16_vs_pallas_interpret():
    """K3: the faces and the compatible right-hand side."""
    jm, tb, t32 = _models()
    proj = ShellProjectionPallas(jm.geo, dtype=ml_dtypes.bfloat16,
                                 incremental=True, interpret=True)
    u_star = _inputs(tb, 5, 1)[0]
    dt = tb._scalar(DT)
    n = jm.geo.n_cells
    w = proj.faces_div(*_j([u_star]), jnp.asarray(dt, jnp.bfloat16))
    g = tb._proj.faces_div(*_t([u_star]), dt)
    r = t32._proj.faces_div(*_t([u_star], torch.float32), dt)
    w_rhs = w[3].astype(jnp.float32) - jnp.sum(
        w[4].astype(jnp.float32)) / n
    _hold("K3", [*g[:3], (g[3] - g[4] / n).to(BF)],
          [*w[:3], w_rhs], [*r[:3], r[3] - r[4] / n])


def test_correct_bf16_vs_pallas_interpret():
    """K5: u, the three faces and p."""
    jm, tb, t32 = _models()
    proj = ShellProjectionPallas(jm.geo, dtype=ml_dtypes.bfloat16,
                                 incremental=True, interpret=True)
    u_star, f0, f1, f2, phi, pres = _inputs(tb, 6, 6)
    dt = tb._scalar(DT)
    jphi = jnp.asarray(phi, jnp.bfloat16)
    w = proj.correct(*_j([u_star]), tuple(_j([f0, f1, f2])), jphi,
                     *_j([pres]), jnp.asarray(dt, jnp.bfloat16),
                     j_st.volume_mean(jm.geo, jphi))
    tphi = torch.as_tensor(phi).to(BF)
    pm = tm_st.volume_mean(tb.geo, tphi)
    g = tb._proj.correct(*_t([u_star]), _t([f0, f1, f2]), tphi,
                         *_t([pres]), dt, pm)
    r = t32._proj.correct(*_t([u_star], torch.float32),
                          _t([f0, f1, f2], torch.float32), tphi.float(),
                          *_t([pres], torch.float32), dt, pm.float())
    _hold("K5", g, w, r)


@pytest.mark.parametrize("n", [1, 5, 32])
def test_tridiag_bf16_vs_f64_solution(n):
    """K4 on bfloat16 lines (lower, diag, upper, rhs): x in float32, the
    recurrences in float32, within 1e-5 of the scale of the float64
    solution of the same rounded system."""
    rng = np.random.default_rng(n)
    m = 37
    lo = -rng.uniform(0.1, 1.0, (n, m))
    up = -rng.uniform(0.1, 1.0, (n, m))
    d = 2.5 + rng.uniform(0.0, 1.0, (n, m))
    b = rng.standard_normal((n, m))
    ops = [dtypes.round_bf16(x) for x in (lo, d, up, b)]
    x = TridiagSolve()(*_t(ops))
    assert x.dtype == torch.float32
    A = np.zeros((m, n, n))
    L, D, U, B = (np.asarray(o, np.float64) for o in ops)
    for i in range(n):
        A[:, i, i] = D[i]
        if i > 0:
            A[:, i, i - 1] = L[i]
        if i + 1 < n:
            A[:, i, i + 1] = U[i]
    want = np.linalg.solve(A, B.T[..., None])[..., 0].T
    assert np.max(np.abs(x.numpy() - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("axis", [0, 2], ids=["r", "lon periodic"])
def test_mg_line_solve_bf16(axis):
    """The multigrid line solve at level 0 of an 8 x 32 x 64 shell on a
    bfloat16 residual (K4's f32 recurrences, float32 tables; the
    periodic lon lines' K4 operands the bfloat16 residual alone, their
    Sherman-Morrison column solved once), against the f32 line solve:
    within TOL of its scale. The JAX package casts
    the tables to the residual's bfloat16: its radial lines agree as
    well, but its periodic lon lines, nearly singular near the poles,
    come out more than 10 times the f32 solution's scale off (ROADMAP.md
    Queue 3)."""
    shape = (8, 32, 64)
    jm = JModel(_configure(JParameters.from_text(""), "float32", shape))
    tm = BoussinesqModel(_configure(Parameters.from_text(""), "float32",
                                    shape), device="cpu")
    r = np.random.default_rng(8).standard_normal(shape)
    want = PoissonMultigrid(tm.geo, tm.p_specs, dtype=torch.float32
                            )._line_solve(0, axis, torch.as_tensor(r).float())
    mg16 = PoissonMultigrid(tm.geo, tm.p_specs, dtype=BF)
    r16 = torch.as_tensor(r).to(BF)
    ops = mg16.line_operands(0, axis, r16)
    assert [o.dtype for o in ops] == [torch.float32] * 3 + [BF]
    assert ops[3].shape == torch.movedim(r16, axis, 0).shape
    got = mg16._line_solve(0, axis, r16)
    assert got.dtype == BF
    want = _f32(want)
    scale = float(np.max(np.abs(want)))
    assert np.max(np.abs(_f32(got) - want)) <= TOL * scale
    jmg = JPoissonMultigrid(jm.geo, jm.p_specs, dtype=ml_dtypes.bfloat16)
    j16 = _f32(jmg._line_solve(0, axis, jnp.asarray(r, jnp.bfloat16)))
    err = np.max(np.abs(j16 - want)) / scale
    assert err <= TOL if axis == 0 else err > 10.0


def test_mg_model_bf16_vs_f32():
    """`poisson solver = mg` in bfloat16 (the JAX package's bf16
    multigrid is left out: its V-cycle is the one above), three steps
    against the port's f32 mg run: every field within 2^-5 of its scale
    (the bf16 CG stops at 16 eps = 0.125 of |b|, the f32 one at the
    prm's 1e-8), no bf16 escalation, div_norm < 1e-2 (the JAX bf16 test's
    bound), the state bfloat16."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        p = Parameters.from_file(PRM)
        p.numerics.dtype = dtype
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = SHAPE
        p.numerics.poisson_solver = "mg"
        p.adapt_time_step = False
        p.final_time = 1e9
        m = BoussinesqModel(p, device="cpu")
        s, hist = m.run(max_steps=3)
        out[dtype] = (s, hist, m.escalations)
    s16, h16, esc = out["bfloat16"]
    s32 = out["float32"][0]
    assert esc == 0
    assert all(h["poisson_iters"] >= 1 and h["div_norm"] < 1e-2 for h in h16)
    for x, y in zip((s16.u, s16.p, s16.T) + s16.u_faces,
                    (s32.u, s32.p, s32.T) + s32.u_faces):
        assert x.dtype == BF
        scale = float(y.abs().max())
        assert float((x.float() - y).abs().max()) <= 2.0 ** -5 * scale


# ------------------------------------------------ the port's model alone
DATA = os.path.join(os.path.dirname(__file__), "..", "data")
_SH = {"n_radial": 4, "n_lat": 8, "n_lon": 16}
_AN = {"n_radial": 8, "n_lon": 48}
_CU = {"nz": 8, "ny": 8, "nx": 8}
CONFIGS = {
    "shell": ("classic", _SH, {}),
    "shell_bench": ("classic", _SH, dict(momentum_fixed_iters=1,
                                         fixed_solver_iters=1)),
    "shell_direct": ("classic", _SH, dict(helmholtz_solver="direct")),
    "shell_sl": ("classic", _SH,
                 dict(temperature_advection="semi-lagrangian")),
    "shell_interval": ("classic", _SH, dict(residual_check_interval=2,
                                            fixed_solver_iters=1)),
    "shell_nse2": ("classic", _SH, dict(NSE_solver_interval=2)),
    "shell_cg": ("classic", _SH, dict(poisson_solver="cg")),
    "shell_feec": ("feec", _SH, {}),
    "shell_feec_projection": ("feec", _SH, dict(momentum_solver="projection")),
    "shell_coupled_schur": ("classic", _SH, dict(
        momentum_solver="coupled", use_schur_complement_solver=True)),
    "shell_mimetic": ("feec", _SH, dict(feec_formulation="staggered")),
    "annulus": ("2d", _AN, {}),
    "annulus_direct": ("2d", _AN, dict(helmholtz_solver="direct")),
    "annulus_sl": ("2d", _AN, dict(temperature_advection="semi-lagrangian")),
    "annulus_coupled": ("2d", _AN, dict(momentum_solver="coupled")),
    "annulus_mg": ("2d", _AN, dict(poisson_solver="mg")),
    "cube": ("cube", _CU, {}),
    "cube_feec_3x3": ("cube", _CU, dict(use_schur_complement_solver=False)),
    "cube_mimetic": ("cube", _CU, dict(use_FEEC_solver=True,
                                       feec_formulation="staggered")),
    "box_standard": ("cube", _CU, dict(use_FEEC_solver=False,
                                       momentum_solver="projection")),
    "slab": ("cube", {"nz": 8, "nx": 16}, dict(
        space_dimension=2, use_FEEC_solver=False,
        momentum_solver="projection")),
}
PRMS = {"classic": "aqua_planet_shell_test_3d-classic.prm",
        "feec": "aqua_planet_shell_test_3d-feec.prm",
        "2d": "aqua_planet_test_2d.prm",
        "cube": "aqua_planet_cube_test_3d.prm"}


def _config(name, dtype="bfloat16"):
    prm, sizes, settings = CONFIGS[name]
    p = Parameters.from_file(os.path.join(DATA, PRMS[prm]))
    p.numerics.dtype = dtype
    p.adapt_time_step = False
    p.final_time = 1e9
    for k, v in list(sizes.items()) + list(settings.items()):
        setattr(p if hasattr(p, k) and not hasattr(p.numerics, k)
                else p.numerics, k, v)
    return p


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_single_device_configuration_runs_bf16(name):
    """Two steps through ``run`` of every single-device configuration in
    bfloat16, built by ``make_model``: nothing refused, every field
    bfloat16 and finite after each step, time float32, max|div u| below
    1e-2 (the JAX bf16 test's bound) off the shell and below 1 on it,
    where the pole cells' short lon faces magnify the rounding
    (chip_smoke.py phase 12 (b) bounds it)."""
    from dycoreplanet_tpu_torch.models import make_model

    m = make_model(_config(name), device="cpu")
    seen = []

    def check(state, rec):
        for x in (state.u, state.p, state.T) + tuple(state.u_faces):
            assert x.dtype == BF and bool(torch.isfinite(x).all())
        assert state.time == float(np.float32(state.time))
        seen.append(rec["div_norm"])

    m.run(max_steps=2, callback=check)
    assert len(seen) == 2
    assert max(seen) < (1.0 if m.geo.kind == "shell" else 1e-2)


def test_mesh_bf16_matches_one_device():
    """The shell's mesh step (2 x 2 shards on the CPU: K2o and K1o's plain
    versions, the sharded Poisson solve) in bfloat16, three steps against
    the single-device bf16 steps: every field within TOL of its scale,
    the shards bfloat16, the fixed-order sums in float32."""
    from dycoreplanet_tpu_torch.parallel.halo import psum
    from dycoreplanet_tpu_torch.parallel.mesh import (
        Mesh, build, shard_state, unshard_state)

    p = _config("shell_bench")
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 16, 32
    one = BoussinesqModel(p, device="cpu")
    mesh_model = BoussinesqModel(p, device="cpu")
    mesh = Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("lat", "lon"))
    mesh_model.prepare_sharded(mesh)
    s1, _ = one.run(max_steps=3)
    sm, hist = mesh_model.run(max_steps=3)
    assert sm.u[0, 0].dtype == BF and len(hist) == 3
    assert mesh_model.escalations == 0
    g = unshard_state(sm, "cpu")
    for x, y in zip((g.u, g.p, g.T) + tuple(g.u_faces),
                    (s1.u, s1.p, s1.T) + tuple(s1.u_faces)):
        assert x.dtype == BF
        scale = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= TOL * scale
    total = psum(build(mesh, lambda a, b: sm.T[a, b].sum()), mesh)
    assert all(t.dtype == torch.float32 for t in total.values())
    assert shard_state(s1, one.geo, mesh).T[0, 0].dtype == BF
