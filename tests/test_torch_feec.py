"""The FEEC personality and the coupled momentum solves of the PyTorch
port against the JAX package, on the CPU in float64, from the same
numpy-seeded inputs:

  * ``curl_2d`` (annulus), ``curl_3d`` (shell), ``rotational_advection``
    and the rotational form of the plain forcing (``Forcing`` with
    ``advection_form="rotational"``, the JAX model's
    ``_explicit_forcing``), each within 1e-12 of the field's scale; the
    cuboid branches refused;
  * three steps of each coupled path: the annulus block FGMRES and Schur
    solves, the shell's coupled 2x2 and FEEC 3x3 solves, the FEEC shell's
    Schur 2x2 solve (``use schur complement solver``), FEEC with
    ``momentum solver = projection`` on the shell (through the plain
    versions of K1, K3 and K5; the JAX model's jnp path), and the stiff
    configuration of tests/test_coupled_solver.py with the
    strong-preconditioner retry on and off: equal outer iteration
    counts every step, u, p, T and the faces within 1e-9 of their scale;
  * the kernels each model builds, ``step_verbose``'s trails, a coupled
    ``multi_step`` chunk against the step loop, and the coupled and
    rotational models through ``prepare_sharded`` on a 2 x 2 mesh, one
    step against one device.

The JAX models (and their compiled steps) are shared through a
module-scoped fixture."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import vector as j_vec
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid.factory import make_cuboid
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, shard_state, unshard_state)

OP_TOL = 1e-12
STEP_TOL = 1e-9
# a converged solve's true residual ||b - A x||, and the Poisson
# spot-check's, are round-off of the right-hand side (1e-15 to 1e-12
# here), known to a few digits only
RES_RTOL, RES_ATOL = 1e-3, 1e-13
N = 3
DT = 0.01


def _params(cls, case):
    """tests/test_coupled_solver.py's configurations: the annulus at
    8 x 48, the shell at 6 x 8 x 16, dt 0.01, f64."""
    p = cls.from_text("")
    if case.startswith("annulus") or case.startswith("stiff"):
        p.space_dimension = 2
        p.numerics.n_radial, p.numerics.n_lon = 8, 48
    else:
        p.space_dimension = 3
        p.cuboid_geometry = False
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 6, 8, 16
    p.numerics.dtype = "float64"
    p.physical_constants.R0 = 1.0
    p.physical_constants.atm_height = 2.0
    p.physical_constants.expansion_coefficient = 0.3
    p.physical_constants.__post_init__()
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.__post_init__()
    p.time_step = DT
    if case in ("annulus_fgmres", "annulus_schur", "shell_coupled"):
        p.numerics.momentum_solver = "coupled"
    if case in ("annulus_schur", "shell_feec_schur"):
        p.use_schur_complement_solver = True
    if case.startswith("shell_feec"):
        p.use_FEEC_solver = True          # momentum solver auto: coupled
    if case == "shell_feec_projection":
        p.numerics.momentum_solver = "projection"
    if case.startswith("stiff"):
        # Re = 0.02: the Jacobi u-sweep stalls within max_cg_iters
        p.numerics.momentum_solver = "coupled"
        p.numerics.max_cg_iters = 12
        p.physical_constants.dynamic_viscosity = 50.0
        p.physical_constants.__post_init__()
    return p


def _model(cls, case, **kw):
    m = cls(_params(JParameters if cls is JModel else Parameters, case), **kw)
    if case == "stiff_no_fallback":
        m._enable_solver_fallback = False
    return m


class _JaxRuns:
    """The JAX models and their N-step trajectories, made once a case."""

    def __init__(self):
        self.models, self.runs = {}, {}

    def model(self, case):
        if case not in self.models:
            self.models[case] = _model(JModel, case)
        return self.models[case]

    def run(self, case):
        if case not in self.runs:
            m = self.model(case)
            s, out = m.initial_state(), []
            for _ in range(N):
                s, d = m.step(s, DT)
                out.append((s, d))
            self.runs[case] = out
        return self.runs[case]


@pytest.fixture(scope="module")
def jax_runs():
    return _JaxRuns()


def _field(rng, shape):
    return 0.1 * rng.standard_normal(shape)


def _close(got, want, tol, what):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


# ------------------------------------------------------------- operators
@pytest.mark.parametrize("geometry", ["annulus", "shell"])
def test_curl_and_rotational_advection(jax_runs, geometry):
    case = "annulus_fgmres" if geometry == "annulus" else "shell_feec"
    jm = jax_runs.model(case)
    tm = _model(BoussinesqModel, case, device="cpu")
    rng = np.random.default_rng(3)
    u = _field(rng, (tm.geo.dim,) + tm.geo.cell_shape)
    tu = torch.as_tensor(u)
    if geometry == "annulus":
        _close(vec.curl_2d(tm.geo, tu, tm.u_specs),
               j_vec.curl_2d(jm.geo, jnp.asarray(u), jm.u_specs), OP_TOL,
               "curl_2d")
    else:
        _close(vec.curl_3d(tm.geo, tu, tm.u_specs),
               j_vec.curl_3d(jm.geo, jnp.asarray(u), jm.u_specs), OP_TOL,
               "curl_3d")
    _close(vec.rotational_advection(tm.geo, tu, tm.u_specs, tm.p_specs),
           j_vec.rotational_advection(jm.geo, jnp.asarray(u), jm.u_specs,
                                      jm.scalar_specs),
           OP_TOL, "rotational_advection")


@pytest.mark.parametrize("case", ["shell_feec", "shell_feec_projection"])
def test_rotational_forcing_matches_jax(jax_runs, case):
    """The plain forcing in the rotational form, with -grad p (incremental
    projection): the JAX model's ``_explicit_forcing``."""
    jm = jax_runs.model(case)
    tm = _model(BoussinesqModel, case, device="cpu")
    assert tm._plain_forcing.advection_form == "rotational"
    rng = np.random.default_rng(4)
    shp = tm.geo.cell_shape
    u = _field(rng, (3,) + shp)
    faces = [_field(rng, shp) for _ in range(3)]
    pres = _field(rng, shp)
    T = tm.T_init + _field(rng, shp)
    got = tm._plain_forcing.explicit_forcing(
        torch.as_tensor(u), [torch.as_tensor(f) for f in faces],
        torch.as_tensor(pres), torch.as_tensor(T))
    want = jm._explicit_forcing(jnp.asarray(u),
                                tuple(jnp.asarray(f) for f in faces),
                                jnp.asarray(pres), jnp.asarray(T))
    _close(got, want, OP_TOL, "rotational forcing")


def test_cuboid_branches_refused():
    """Once a refusal: the cuboid branches of ``curl_3d`` and
    ``rotational_advection`` now run (the cube prm's steps:
    tests/test_torch_cuboid.py). On the fully periodic 4 x 4 x 4 box and
    a seeded velocity, each within OP_TOL of the JAX package's."""
    from dycoreplanet_tpu.grid.factory import make_cuboid as j_make_cuboid

    geo = make_cuboid(4, 4, 4, periodic_z=True)
    jgeo = j_make_cuboid(4, 4, 4, periodic_z=True)
    u = _field(np.random.default_rng(9), (3,) + geo.cell_shape)
    specs = [[None] * 3] * 3
    _close(vec.curl_3d(geo, torch.as_tensor(u), specs),
           j_vec.curl_3d(jgeo, jnp.asarray(u), specs), OP_TOL, "curl_3d")
    _close(vec.rotational_advection(geo, torch.as_tensor(u), specs,
                                    [None] * 3),
           j_vec.rotational_advection(jgeo, jnp.asarray(u), specs,
                                      [None] * 3),
           OP_TOL, "rotational_advection")


# ------------------------------------------------------------ the steps
CASES = ["annulus_fgmres", "annulus_schur", "shell_coupled", "shell_feec",
         "shell_feec_schur", "shell_feec_projection", "stiff_fallback",
         "stiff_no_fallback"]


@pytest.mark.parametrize("case", CASES)
def test_three_steps_match_jax(jax_runs, case):
    """N steps from the initial state: the same outer iteration counts
    every step (helmholtz = [outer] * dim, poisson = outer for the
    coupled solves), u, p, T and the faces within 1e-9 of their scale,
    and the same residuals (RES_RTOL, RES_ATOL) and verdict."""
    want = jax_runs.run(case)
    tm = _model(BoussinesqModel, case, device="cpu")
    s = tm.initial_state()
    for k, (js, jd) in enumerate(want):
        s, d = tm.step(s, DT)
        assert d.poisson_iters == jd.poisson_iters, (case, k)
        assert d.helmholtz_iters.tolist() == \
            np.asarray(jd.helmholtz_iters).tolist(), (case, k)
        assert d.temperature_iters == jd.temperature_iters, (case, k)
        assert d.solver_ok == jd.solver_ok, (case, k)
        for name in ("helmholtz_residual", "poisson_residual",
                     "temperature_residual"):
            np.testing.assert_allclose(getattr(d, name), getattr(jd, name),
                                       rtol=RES_RTOL, atol=RES_ATOL,
                                       err_msg=f"{case} {k} {name}")
        for name, g, w in (("u", s.u, js.u), ("p", s.p, js.p),
                           ("T", s.T, js.T)) + tuple(
                (f"face {i}", g, w)
                for i, (g, w) in enumerate(zip(s.u_faces, js.u_faces))):
            _close(g, w, STEP_TOL, f"{case} step {k} {name}")
        assert d.div_norm < 1e-6 or not d.solver_ok
    if case in ("shell_feec_projection",):
        assert sorted(tm.kernels()) == ["correct", "faces_div", "richardson",
                                        "tridiag"]
        assert tm.momentum_solver == "projection"
    else:
        assert list(tm.kernels()) == ["tridiag"]
        assert tm.momentum_solver == "coupled"
    if case == "stiff_no_fallback":
        # without the retry the outer residual stalls far above tolerance
        assert not d.solver_ok and d.helmholtz_residual > 1e-5
    if case == "stiff_fallback":
        assert d.solver_ok and d.helmholtz_residual < 1e-8


@pytest.mark.parametrize("case", ["shell_feec", "annulus_fgmres"])
def test_step_verbose_trails_match_jax(jax_runs, case):
    """``step_verbose``: the outer solve's per-cycle trail under the JAX
    name, beside the temperature Richardson's (float32 trails, within
    RES_RTOL and RES_ATOL)."""
    jm = jax_runs.model(case)
    tm = _model(BoussinesqModel, case, device="cpu")
    _, _, jh = jm.step_verbose(jm.initial_state(), DT)
    _, _, th = tm.step_verbose(tm.initial_state(), DT)
    outer = "FEEC 3x3 FGMRES" if case == "shell_feec" else "coupled FGMRES"
    assert sorted(th) == sorted(jh) == sorted([outer,
                                               "temperature richardson"])
    for name in jh:
        want, got = np.asarray(jh[name]), th[name]
        assert np.array_equal(np.isnan(got), np.isnan(want)), name
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=RES_RTOL,
                                   atol=RES_ATOL)


def test_coupled_multi_step_matches_steps():
    """A coupled chunk (eager: its Krylov loops read back) is the step
    loop, bitwise, and reports the AND of the steps' verdicts."""
    tm = _model(BoussinesqModel, "annulus_fgmres", device="cpu")
    s0 = tm.initial_state()
    s = s0
    for _ in range(N):
        s, _ = tm.step(s, DT)
    sc, rows, _ = tm.multi_step(s0, DT, N)
    assert rows.shape[0] == N and bool((rows[:, 10] == 1).all())
    for a, b in zip((sc.u, sc.p, sc.T) + tuple(sc.u_faces),
                    (s.u, s.p, s.T) + tuple(s.u_faces)):
        assert torch.equal(a, b)
    assert not tm._graphable(adaptive=False, force_cg=False)


@pytest.mark.parametrize("case", ["shell_feec", "shell_coupled",
                                  "shell_feec_projection"])
def test_prepare_sharded_refuses(case):
    """The coupled and rotational models, which the mesh refused before
    their solves were ported to it, prepare on a 2 x 2 mesh and take one
    step from the initial state as on one device: the fields within 1e-9
    of their scale, equal outer (or Poisson) and temperature counts."""
    tm = _model(BoussinesqModel, case, device="cpu")
    one = _model(BoussinesqModel, case, device="cpu")
    mesh = Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("lat", "lon"))
    assert tm.prepare_sharded(mesh) is tm
    assert tm.sharded_kernels()["forcing"] == "jnp"
    s1 = one.initial_state()
    sm, dm = tm.step(shard_state(s1, tm.geo, mesh), DT)
    s1, d1 = one.step(s1, DT)
    got = unshard_state(sm)
    for a, b in zip((got.u, got.p, got.T) + tuple(got.u_faces),
                    (s1.u, s1.p, s1.T) + tuple(s1.u_faces)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= STEP_TOL * scale
    assert (dm.poisson_iters, dm.temperature_iters) == (
        d1.poisson_iters, d1.temperature_iters)
    assert dm.solver_ok == d1.solver_ok


@pytest.mark.parametrize("schur", [True, False], ids=["schur", "fgmres"])
def test_f32_coupled_gate_by_refinement(schur):
    """The annulus prm's coupled solve in float32 on the CPU (the Schur
    GMRES the prm selects, and the block FGMRES with its retry): at
    `initial global refinement` 5 (32 x 384) the outer solve meets its
    relative tolerance max(tol, 16 eps) = 1.9e-6, at 6 (64 x 768) it
    stalls above it in the JAX model and the port alike (f32's attainable
    accuracy of the stabilized saddle point grows with 1/h^2). The
    temperature tolerance is set to 1e-4 so that the gate's verdict is
    the momentum solve's alone (the prm's two temperature sweeps miss
    the f32 gate from refinement 6 too)."""
    import os

    data = os.path.join(os.path.dirname(__file__), "..", "data")
    for refinement, ok in ((5, True), (6, False)):
        verdicts = []
        for P, M, kw in ((JParameters, JModel, {}),
                         (Parameters, BoussinesqModel, {"device": "cpu"})):
            p = P.from_file(os.path.join(data, "aqua_planet_test_2d.prm"))
            p.initial_global_refinement = refinement
            p.numerics.dtype = "float32"
            p.numerics.momentum_solver = "coupled"
            p.numerics.temperature_tol = 1e-4
            p.use_schur_complement_solver = schur
            m = M(p, **kw)
            _, d = m.step(m.initial_state(), p.time_step)
            verdicts.append(d.solver_ok)
        assert verdicts == [ok, ok], (refinement, verdicts)
