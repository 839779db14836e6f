"""The cuboid geometry of the PyTorch port against the JAX package, on
the CPU in float64, from the same numpy-seeded inputs:

  * the closures (``vertical_gravity_vector``, ``gravity_vector``), the
    cuboid temperature IC and the cuboid branches of ``ops/vector.py``
    (curvature terms, ``curl_3d``, ``rotational_advection``,
    ``coriolis_acceleration``) at 6 x 8 x 10, within 1e-12 of the
    field's scale;
  * ``CuboidPoissonFastDiag`` (z walls and fully periodic),
    ``Cuboid2DPoissonFastDiag``, ``CuboidHelmholtzDirect`` and
    ``CuboidPoissonDirect`` (K4's plain version on the CPU, the JAX
    package's ``thomas_solve``) at 8 x 12 x 16, within 1e-10, and each
    an exact inverse of its operator; K4's description of
    ``CuboidPoissonDirect``'s operands: no copy, the real and imaginary
    parts as the pair axis;
  * the model's static fields, and three steps at 8^3 of
    data/aqua_planet_cube_test_3d.prm as it stands (the Schur GMRES),
    with `use schur complement solver = false` (the FEEC 3x3 FGMRES with
    the cuboid curls), of the standard personality (default and direct
    Helmholtz, the semi-Lagrangian transport), the 2D (z, x) slab and
    the fully periodic box: equal
    iteration counts, fields within 1e-12 of their scale, residuals
    within tests/test_torch_feec.py's RES_RTOL / RES_ATOL;
  * a multi_step chunk of 4 equal to 4 steps, FEEC on the slab raising
    ValueError in both packages, the direct solve refused where the
    JAX package has none, a cuboid state carried across as numpy, and
    ``prepare_sharded`` refusing the cuboid under its own ROADMAP title.

The JAX models and their trajectories are shared through a
module-scoped fixture."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import vector as j_vec
from dycoreplanet_tpu.physics import closures as j_cl
from dycoreplanet_tpu.physics import initial_data as j_ic
from dycoreplanet_tpu.solvers import helmholtz as j_helm
from dycoreplanet_tpu.solvers import spectral as j_spec
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    state_from_numpy, state_to_numpy)
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, shard_state, unshard_state)
from dycoreplanet_tpu_torch.physics import closures as t_cl
from dycoreplanet_tpu_torch.physics import initial_data as t_ic
from dycoreplanet_tpu_torch.solvers import helmholtz as t_helm
from dycoreplanet_tpu_torch.solvers import spectral as t_spec

OP_TOL = 1e-12
SOLVE_TOL = 1e-10
STEP_TOL = 1e-12
# a converged solve's true residual, and the Poisson spot-check's, are
# round-off of the right-hand side, known to a few digits only (as in
# tests/test_torch_feec.py)
RES_RTOL, RES_ATOL = 1e-3, 1e-13
N = 3
PRM = os.path.join(os.path.dirname(__file__), "..", "data",
                   "aqua_planet_cube_test_3d.prm")
OP_SHAPE = (6, 8, 10)
SOLVE_SHAPE = (8, 12, 16)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol, what):
    want, got = np.asarray(want), _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


# ------------------------------------------------------------- the cases
def _params(cls, case):
    """The cube prm (f64, 8^3) as it stands ("schur"), with the FEEC 3x3
    FGMRES ("fgmres3x3"), in the standard personality ("default",
    "direct") and with the semi-Lagrangian transport ("sl"); the 2D slab
    at 8 x 16 with tests/test_model.py's
    TestCuboid2D physics ("slab"); the fully periodic box at 8^3
    ("periodic", its geometry made by _geometry)."""
    if case == "slab":
        p = cls.from_text("")
        p.space_dimension = 2
        p.cuboid_geometry = True
        p.numerics.nz, p.numerics.nx = 8, 16
        p.physical_constants.expansion_coefficient = 0.2
        p.reference_quantities.velocity = 1.0
        p.reference_quantities.length = 1.0
        p.reference_quantities.temperature_ref = 3.0
        p.time_step = 0.01
    else:
        p = cls.from_file(PRM)
        p.numerics.nz = p.numerics.ny = p.numerics.nx = 8
    p.numerics.dtype = "float64"
    if case == "fgmres3x3":
        p.use_schur_complement_solver = False
    if case in ("default", "direct", "periodic", "sl"):
        p.use_FEEC_solver = False
    if case == "direct":
        p.numerics.helmholtz_solver = "direct"
    if case == "sl":
        p.numerics.temperature_advection = "semi-lagrangian"
    return p


def _geometry(factory, case):
    if case == "periodic":
        return factory.make_cuboid(8, 8, 8, periodic_z=True)
    return None


def _model(case, jax_side=False):
    if jax_side:
        return JModel(_params(JParameters, case),
                      geometry=_geometry(j_factory, case))
    return BoussinesqModel(_params(Parameters, case),
                           geometry=_geometry(t_factory, case), device="cpu")


STEP_CASES = ["schur", "fgmres3x3", "default", "direct", "sl", "slab",
              "periodic"]


class _JaxRuns:
    """The JAX models and their N-step trajectories, made once a case."""

    def __init__(self):
        self.models, self.runs = {}, {}

    def model(self, case):
        if case not in self.models:
            self.models[case] = _model(case, jax_side=True)
        return self.models[case]

    def run(self, case):
        if case not in self.runs:
            m = self.model(case)
            s, out = m.initial_state(), []
            for _ in range(N):
                s, d = m.step(s, m.params.time_step)
                out.append((s, d))
            self.runs[case] = out
        return self.runs[case]


@pytest.fixture(scope="module")
def jax_runs():
    return _JaxRuns()


# ------------------------------------------------------------- closures
def test_gravity_vectors_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-2.0, 2.0, OP_SHAPE + (3,))
    p[0, 0, 0] = 0.0                              # the origin: r = 0
    for t_fn, j_fn in ((t_cl.vertical_gravity_vector,
                        j_cl.vertical_gravity_vector),
                       (t_cl.gravity_vector, j_cl.gravity_vector)):
        _close(t_fn(p, 9.81), j_fn(jnp.asarray(p), 9.81), OP_TOL,
               t_fn.__name__)
    g = t_cl.vertical_gravity_vector(p, 2.0)
    assert (g[..., :2] == 0).all() and (g[..., 2] == -2.0).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_cuboid_ic_matches_jax(dim):
    rng = np.random.default_rng(2)
    center = np.full(dim, 0.5)
    diameter = float(np.sqrt(dim))
    p = rng.uniform(0.0, 1.0, OP_SHAPE[:dim] + (dim,))
    got = t_ic.TemperatureInitialValuesCuboid(dim, center, diameter)(p)
    want = j_ic.TemperatureInitialValuesCuboid(
        dim, jnp.asarray(center), diameter)(jnp.asarray(p))
    _close(got, want, OP_TOL, f"{dim}D cuboid IC")


# ------------------------------------------------------- vector branches
def _op_models():
    """A port and a JAX model on the 6 x 8 x 10 box (the cube prm's
    boundary specs)."""
    out = []
    for P, M, kw in ((Parameters, BoussinesqModel, {"device": "cpu"}),
                     (JParameters, JModel, {})):
        p = P.from_file(PRM)
        p.numerics.dtype = "float64"
        p.numerics.nz, p.numerics.ny, p.numerics.nx = OP_SHAPE
        out.append(M(p, **kw))
    return out


VECTOR_OPS = ["advection_curvature", "vector_laplacian_curvature",
              "curl_3d", "rotational_advection", "coriolis_reference",
              "coriolis_physical"]


def _vector_op(mod, name, geo, u, specs, ke_spec):
    if name == "advection_curvature":
        return mod.advection_curvature(geo, u)
    if name == "vector_laplacian_curvature":
        return mod.vector_laplacian_curvature(geo, u, specs)
    if name == "curl_3d":
        return mod.curl_3d(geo, u, specs)
    if name == "rotational_advection":
        return mod.rotational_advection(geo, u, specs, ke_spec)
    return mod.coriolis_acceleration(geo, u, 0.7, name.split("_")[1])


@pytest.mark.parametrize("name", VECTOR_OPS)
def test_vector_branches_match_jax(name):
    """The cuboid branches on a seeded velocity with the cube prm's
    specs: zero curvature terms, the (z, y, x) curl, the cross product
    and -2 Omega e_z x u (both modes)."""
    tm, jm = _op_models()
    u = 0.1 * np.random.default_rng(3).standard_normal((3,) + OP_SHAPE)
    got = _vector_op(vec, name, tm.geo, torch.as_tensor(u), tm.u_specs,
                     tm.p_specs)
    want = _vector_op(j_vec, name, jm.geo, jnp.asarray(u), jm.u_specs,
                      jm.scalar_specs)
    if name.endswith("curvature"):
        assert not np.asarray(want).any() and not _np(got).any()
        assert got.shape == u.shape
    else:
        _close(got, want, OP_TOL, name)


def test_curl_3d_of_a_linear_field():
    """curl (0, x, 0) = e_z in the (z, y, x) stacking: om_z = 1 inside."""
    geo = t_factory.make_cuboid(*OP_SHAPE, periodic_z=True)
    x = torch.as_tensor(geo.axes[2].centers).expand(OP_SHAPE)
    u = torch.stack([torch.zeros(OP_SHAPE, dtype=torch.float64), x,
                     torch.zeros(OP_SHAPE, dtype=torch.float64)])
    om = vec.curl_3d(geo, u, [[None] * 3] * 3)
    assert torch.allclose(om[0, :, :, 1:-1], torch.ones(()).double())
    assert not om[1:].any()


@pytest.mark.parametrize("mode", ["reference", "physical"])
def test_slab_vector_branches_match_jax(mode):
    """The 2D slab: zero curvature terms, the 2D Coriolis of either mode."""
    tm, jm = _model("slab"), _JaxRuns().model("slab")
    shp = tm.geo.cell_shape
    u = 0.1 * np.random.default_rng(4).standard_normal((2,) + shp)
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    assert not vec.advection_curvature(tm.geo, tu).any()
    assert not vec.vector_laplacian_curvature(tm.geo, tu, tm.u_specs).any()
    _close(vec.coriolis_acceleration(tm.geo, tu, 0.7, mode),
           j_vec.coriolis_acceleration(jm.geo, ju, 0.7, mode), OP_TOL,
           f"slab coriolis {mode}")


# ---------------------------------------------------------------- solves
def _geos(kind):
    nz, ny, nx = SOLVE_SHAPE
    if kind == "slab":
        return (t_factory.make_cuboid_2d(nz, nx),
                j_factory.make_cuboid_2d(nz, nx))
    periodic = kind == "periodic"
    return (t_factory.make_cuboid(nz, ny, nx, periodic_z=periodic),
            j_factory.make_cuboid(nz, ny, nx, periodic_z=periodic))


def _p_specs(geo):
    if geo.axes[0].periodic:
        return [None] * geo.dim
    return [BCSpec(BC.NEUMANN, BC.NEUMANN)] + [None] * (geo.dim - 1)


POISSON = {"fastdiag": ("walls", "CuboidPoissonFastDiag"),
           "fastdiag_periodic": ("periodic", "CuboidPoissonFastDiag"),
           "fastdiag_2d": ("slab", "Cuboid2DPoissonFastDiag"),
           "direct": ("walls", "CuboidPoissonDirect")}


@pytest.mark.parametrize("case", list(POISSON))
def test_poisson_solvers_match_jax(case):
    """Each cuboid Poisson solve on a seeded mean-free right-hand side:
    within 1e-10 of the JAX solve (the direct solves pin a cell of the
    nullspace, so both are compared mean-free), and an exact inverse:
    -weak_laplacian(x) = b within 1e-10 of |b|."""
    kind, name = POISSON[case]
    tgeo, jgeo = _geos(kind)
    b = np.random.default_rng(5).standard_normal(tgeo.cell_shape)
    b -= b.mean()
    sol = getattr(t_spec, name)(tgeo, dtype=np.float64)
    x = _np(sol.solve(torch.as_tensor(b))[0])
    xj = np.asarray(getattr(j_spec, name)(jgeo, dtype=np.float64).solve(
        jnp.asarray(b))[0])
    _close(x - x.mean(), xj - xj.mean(), SOLVE_TOL, case)
    Ax = -st.weak_laplacian(tgeo, torch.as_tensor(x), _p_specs(tgeo))
    _close(Ax, b, SOLVE_TOL, f"{case}: -L x = b")
    assert isinstance(t_spec.make_poisson_solver(tgeo, np.float64),
                      t_spec.CuboidPoissonFastDiag
                      if name == "CuboidPoissonDirect"
                      else getattr(t_spec, name))


def test_poisson_direct_k4_layout():
    """CuboidPoissonDirect's operands as K4 reads them: one solve, the
    rfft2's real and imaginary parts as the pair axis, lower and upper
    one value a row (stride 0 across every column), nothing copied."""
    tgeo, _ = _geos("walls")
    sol = t_spec.CuboidPoissonDirect(tgeo, dtype=np.float64)
    b = torch.as_tensor(np.random.default_rng(6).standard_normal(
        tgeo.cell_shape))
    low, diag, up, rhs = sol.systems(b)
    nz, ny, nx = tgeo.cell_shape
    assert rhs.shape == (nz, ny, nx // 2 + 1, 2)
    assert low.shape == up.shape == (nz, 1, 1, 1)
    assert diag.shape == (nz, ny, nx // 2 + 1, 1)
    lay = k4.layout(low, diag, up, rhs)
    assert lay.copied == () and lay.pair == 2 and lay.row_coefficients
    assert lay.cols == ny * (nx // 2 + 1)
    # the plain version on the CPU: no launch, no copy
    sol.solve(b)
    assert sol.tridiag.launches == 0 and sol.tridiag.copies == 0


HELM = {"w": "u_AS", "v": "u_NEU", "T": "T_hom"}


@pytest.mark.parametrize("c", [1e-4, 3.3e-2, 0.7])
def test_helmholtz_direct_matches_jax(c):
    """CuboidHelmholtzDirect on a stack of the cube's z wall rules (w:
    ANTISYM both walls, v and u: no-slip bottom, free-slip top) against
    the JAX solver within 1e-10, and an exact inverse of (vol - c L)."""
    from dycoreplanet_tpu.ops import bc as j_bc
    from dycoreplanet_tpu_torch.ops import bc as t_bc

    tgeo, jgeo = _geos("walls")

    def specs(bc):
        AS, NEU = bc.BC.ANTISYM, bc.BC.NEUMANN
        return [bc.BCSpec(AS, AS), bc.BCSpec(AS, NEU), bc.BCSpec(AS, NEU)]

    rng = np.random.default_rng(7)
    x_true = rng.standard_normal((3,) + tgeo.cell_shape)
    ts = specs(t_bc)
    vol = float(np.asarray(tgeo.vol).flat[0])
    b = torch.stack([vol * torch.as_tensor(x_true[k]) - c * st.weak_laplacian(
        tgeo, torch.as_tensor(x_true[k]), [ts[k], None, None])
        for k in range(3)])
    sol = t_helm.make_helmholtz_solver(tgeo, ts, dtype=np.float64)
    assert isinstance(sol, t_helm.CuboidHelmholtzDirect)
    x = sol.solve(b, c)
    xj = j_helm.CuboidHelmholtzDirect(jgeo, specs(j_bc),
                                      dtype=np.float64).solve(
        jnp.asarray(_np(b)), c)
    _close(x, xj, SOLVE_TOL, f"helmholtz c {c}")
    _close(x, x_true, SOLVE_TOL, f"helmholtz c {c}: exact inverse")


def test_helmholtz_direct_none_or_refused_as_in_jax():
    """No direct solver on the 2D slab (None, as in the JAX factory);
    the fully periodic box has no z wall rule (ValueError in both)."""
    slab_t, slab_j = _geos("slab")
    assert t_helm.make_helmholtz_solver(slab_t, [None]) is None
    assert j_helm.make_helmholtz_solver(slab_j, [None]) is None
    per_t, per_j = _geos("periodic")
    with pytest.raises(ValueError, match="wall axis"):
        t_helm.make_helmholtz_solver(per_t, [None])
    with pytest.raises(ValueError, match="wall axis"):
        j_helm.make_helmholtz_solver(per_j, [None])


# ------------------------------------------------------------ the model
STATIC = ("T_init", "gravity", "p_hydro", "T_lap_offset", "helm_diags",
          "T_diag")


@pytest.mark.parametrize("case", ["schur", "slab", "periodic"])
def test_static_fields_match_jax(jax_runs, case):
    """The IC (points in the reference's (x, y, z) order), the wall
    values, gravity, the hydrostatic pressure, rho_background and the
    diagonals, against the JAX model's."""
    jm, tm = jax_runs.model(case), _model(case)
    for name in STATIC:
        _close(getattr(tm, name), getattr(jm, name), OP_TOL, name)
    assert abs(tm.rho_background - jm.rho_background) <= 1e-15
    if case == "periodic":
        assert tm.T_wall is None and tm.T_specs == [None] * 3
    else:
        jw = jm.T_specs[0].lo_value
        _close(tm.T_specs[0].lo_value, jw, OP_TOL, "T_wall")
        # the IC peaks at the domain centre: not mirrored
        centre = tuple(n // 2 for n in tm.geo.cell_shape)
        assert np.unravel_index(np.argmax(tm.T_init), tm.geo.cell_shape) \
            in [tuple(c - o for c, o in zip(centre, off))
                for off in np.ndindex(*(2,) * tm.geo.dim)]


@pytest.mark.parametrize("case", STEP_CASES)
def test_three_steps_match_jax(jax_runs, case):
    """N steps from the initial state: the same iteration counts and
    verdict every step, u, p, T and the faces within 1e-12 of their
    scale, the residuals within RES_RTOL and RES_ATOL."""
    want = jax_runs.run(case)
    tm = _model(case)
    assert list(tm.kernels()) == ["tridiag"]
    s = tm.initial_state()
    for k, (js, jd) in enumerate(want):
        s, d = tm.step(s, tm.params.time_step)
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
    assert float(d.max_velocity) > 1e-6           # buoyancy spins up flow
    if not tm.geo.axes[0].periodic:
        # no flow through the bottom wall
        assert not s.u_faces[0][0].any()
    assert tm.kernels()["tridiag"].launches == 0


@pytest.mark.parametrize("case", ["direct", "slab"])
def test_multi_step_chunk_equals_steps(case):
    """A chunk of 4 (eager on the CPU) is the step loop, bitwise, with
    its rows, on the standard box with the direct solves and on the slab
    (whose gates pass; the default path's two temperature sweeps miss
    the prm's temperature tol of 1e-12, in the JAX model too, and a
    chunk would be redone with CG)."""
    tm = _model(case)
    dt = tm.params.time_step
    s0 = tm.initial_state()
    s, rows = s0, []
    for _ in range(4):
        s, d = tm.step(s, dt)
        rows.append(d._h())
    sc, packed, _ = tm.multi_step(s0, dt, 4)
    for a, b in zip((sc.u, sc.p, sc.T) + tuple(sc.u_faces),
                    (s.u, s.p, s.T) + tuple(s.u_faces)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(np.asarray(packed), np.stack(rows))
    assert sc.step_number == 4 and tm.escalations == 0


def test_feec_on_the_slab_raises_in_both():
    """The 2D slab has no curl_2d: the rotational (FEEC) forcing raises
    ValueError in the JAX model and the port alike."""
    for P, M, kw in ((JParameters, JModel, {}),
                     (Parameters, BoussinesqModel, {"device": "cpu"})):
        p = _params(P, "slab")
        p.use_FEEC_solver = True
        m = M(p, **kw)
        with pytest.raises(ValueError):
            m.step(m.initial_state(), p.time_step)


@pytest.mark.parametrize("case", ["slab", "periodic"])
def test_direct_helmholtz_refused_as_in_jax(case):
    """`helmholtz solver = direct` where the JAX package has no cuboid
    direct solver (the slab) or no z wall rule (the periodic box):
    ValueError in both."""
    for P, M, kw, fac in ((JParameters, JModel, {}, j_factory),
                          (Parameters, BoussinesqModel, {"device": "cpu"},
                           t_factory)):
        p = _params(P, case)
        p.numerics.helmholtz_solver = "direct"
        with pytest.raises(ValueError):
            M(p, geometry=_geometry(fac, case), **kw)


@pytest.mark.parametrize("case", ["schur", "slab"])
def test_state_carried_across_as_numpy(jax_runs, case):
    """A JAX cuboid state (3D and 2D) as numpy into the port and back,
    bitwise, and one port step from it as the JAX step."""
    js, _ = jax_runs.run(case)[0]
    tm = _model(case)
    arrays = (np.asarray(js.u), tuple(np.asarray(f) for f in js.u_faces),
              np.asarray(js.p), np.asarray(js.T))
    ts = state_from_numpy(tm, *arrays, time=float(js.time),
                          step_number=int(js.step_number))
    back = state_to_numpy(ts)
    for a, b in zip((back[0], *back[1], back[2], back[3]),
                    (arrays[0], *arrays[1], arrays[2], arrays[3])):
        assert a.tobytes() == b.tobytes()
    assert back[5] == 1
    ts2, _ = tm.step(ts, tm.params.time_step)
    js2, _ = jax_runs.run(case)[1]
    _close(ts2.u, js2.u, STEP_TOL, f"{case}: a step from the carried state")


def test_prepare_sharded_refuses_the_cuboid():
    """The cuboid's mesh once refused ``helmholtz solver = direct``; now
    the box's direct step runs on its ("y", "x") mesh (2 x 2): two steps
    against the port's one device, the sharded CuboidHelmholtzDirect
    (matrix products only, no K4) within 1e-12 of the scale, equal
    counts, max|div u| round-off."""
    one, tm = _model("direct"), _model("direct")
    mesh = Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("y", "x"))
    tm.prepare_sharded(mesh)
    assert type(tm._mesh.helmholtz).__name__ == \
        "ShardedCuboidHelmholtzDirect"
    s1 = one.initial_state()
    sm = shard_state(s1, tm.geo, mesh)
    dt = tm.params.time_step
    for _ in range(2):
        s1, d1 = one.step(s1, dt)
        sm, dm = tm.step(sm, dt)
        g = unshard_state(sm)
        for name in ("u", "T", "p"):
            _close(getattr(g, name), _np(getattr(s1, name)), 1e-12,
                   f"direct mesh {name}")
        assert (dm.poisson_iters, dm.temperature_iters) == \
            (d1.poisson_iters, d1.temperature_iters)
        assert dm.div_norm < 1e-9