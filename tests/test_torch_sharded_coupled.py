"""The coupled momentum solves and the rotational form on the port's mesh
(``prepare_sharded``) against the JAX package and the port's single
device, in f64 on the CPU, where the port's shards take their plain
PyTorch versions:

  * the one GMRES loop (solvers/gmres.py) on Sharded vectors, each shard
    holding its own columns of the Arnoldi basis and every product summed
    over the mesh in a fixed order, against the single-device loop and
    the JAX ``gmres`` on a nonsymmetric advection-diffusion operator,
    flexible and not: equal Arnoldi counts, the iterates to round-off;
  * the curl and the rotational forcing on the shards against one device
    on fields that cross the poles (the vorticity crosses with its
    tangential components sign-flipped, as the velocity does: padded with
    sign 1 the curl misses);
  * the FEEC 3x3 FGMRES, the 2x2 block FGMRES and the Schur GMRES mesh
    steps on (2, 4) from a seeded flow against the JAX steps jitted with
    shardings on its 8 virtual devices (GSPMD's plain path) and against
    the port's single device: u, T and the faces rtol 1e-8 / atol 1e-10,
    p 1e-7 / 1e-9, equal outer and temperature counts (the sums in three
    orders); run on the mesh with `adapt time step` as on one device.

The JAX models and their compiled steps are shared through a
module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import stencil as jst
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, shard_state as j_shard_state,
    state_sharding)
from dycoreplanet_tpu.solvers.gmres import gmres as j_gmres
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    sharded_state_from_numpy, state_from_numpy, state_to_numpy)
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.ops.forcing import Forcing
from dycoreplanet_tpu_torch.parallel.halo import pad_block
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, build, crop, shard_field, shard_state, unshard_field,
    unshard_state)
from dycoreplanet_tpu_torch.parallel.sharded_pallas import (
    ShardedPlainForcing)
from dycoreplanet_tpu_torch.solvers.gmres import gmres
from tests.test_torch_feec import _model
from tests.test_torch_sharded import SHAPE, _models, _np
from tests.test_torch_sharded_cg import _hold_state, _jstate, _tmesh

DT = 0.01
CASES = ["shell_feec", "shell_coupled", "shell_feec_schur"]


# ----------------------------------------------------------------------
K, C = 0.02, 0.2      # the operator's diffusion and advection


def _advection_diffusion(tm, ops):
    """vol x - K L x + C vol d/dlon x, nonsymmetric (an implicit
    advection-diffusion step), on one device and on the shards (``ops``:
    the mesh's plain stages)."""
    vol = tm._vol_t

    def one(x):
        return (vol * x - K * st.weak_laplacian(tm.geo, x, tm.T_specs_hom)
                + C * vol * st.centered_gradient(tm.geo, x, 2, None))

    def sharded(x):
        dlon = ops.gradient(x, tm.p_specs).map(lambda t: t[2])
        return (ops.vol * x - K * ops.weak_laplacian(x, tm.T_specs_hom)
                + C * ops.vol * dlon)

    return one, sharded


@pytest.mark.parametrize("flexible", [False, True],
                         ids=["gmres", "fgmres"])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2)])
def test_sharded_gmres_matches_single_device_and_jax(mesh_shape, flexible):
    """GMRES(8) with a Jacobi preconditioner on the nonsymmetric operator
    from a seeded right-hand side: the sharded loop (its basis cut over
    the shards, the CGS2 products and the norms summed over the mesh)
    takes the single-device loop's and the JAX loop's Arnoldi count; the
    two port iterates agree to 1e-12 of their scale and all three meet
    the tolerance against the true solution's scale."""
    jm, tm = _models()
    tm.prepare_sharded(_tmesh(*mesh_shape))
    ops = tm._mesh.ops
    one, sharded = _advection_diffusion(tm, ops)
    diag = tm._vol_t + K * tm._T_diag_t
    x_true = torch.as_tensor(np.random.default_rng(3).standard_normal(SHAPE))
    b = one(x_true)
    kw = dict(rtol=1e-10, restart=8, maxiter=200, flexible=flexible)
    r1 = gmres(one, b, preconditioner=lambda r: r / diag, **kw)
    d_sh = shard_field(diag, ops.mesh)
    rs = gmres(sharded, shard_field(b, ops.mesh),
               preconditioner=lambda r: r / d_sh, total=ops.total, **kw)
    vol_j, diag_j = jnp.asarray(_np(tm._vol_t)), jnp.asarray(_np(diag))

    def j_op(x):
        return (vol_j * x - K * jst.weak_laplacian(jm.geo, x, jm.T_specs_hom)
                + C * vol_j * jst.centered_gradient(jm.geo, x, 2, None))

    jr = j_gmres(j_op, jnp.asarray(_np(b)),
                 preconditioner=lambda r: r / diag_j, **kw)
    assert rs.iterations == r1.iterations == int(jr.iterations) > 8
    x_sh = _np(unshard_field(rs.x))
    scale = float(np.abs(_np(x_true)).max())
    assert np.abs(x_sh - _np(r1.x)).max() <= 1e-12 * scale
    for sol in (x_sh, _np(r1.x), np.asarray(jr.x)):
        np.testing.assert_allclose(sol, _np(x_true), rtol=0,
                                   atol=1e-7 * scale)
    assert bool(rs.converged) and bool(r1.converged)


def test_gmres_on_sharded_b_needs_the_total():
    _, tm = _models()
    tm.prepare_sharded(_tmesh(2, 2))
    b = shard_field(torch.ones(SHAPE, dtype=torch.float64),
                    tm._mesh.ops.mesh)
    with pytest.raises(ValueError, match="total"):
        gmres(lambda x: x, b)


# ----------------------------------------------------------------------
def _rotational(tm):
    """The model's forcing arguments in the rotational (FEEC) form."""
    f = tm._forcing
    return Forcing(tm.geo, beta=f.beta, T_ref=f.T_ref,
                   rho_background=f.rho_background, gravity=f.gravity,
                   one_over_Re=f.one_over_Re, omega_hat=0.7,
                   coriolis_mode="physical", buoyancy=f.buoyancy,
                   scheme=f.scheme, include_gradp=True, u_specs=f.u_specs,
                   p_specs=f.p_specs, T_specs=f.T_specs,
                   advection_form="rotational")


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (2, 3)])
def test_curl_and_rotational_forcing_on_the_shards(mesh_shape):
    """The curl and the rotational forcing (omega x u + grad |u|^2 / 2,
    the physical Coriolis, buoyancy, the viscous curvature, grad p) on
    the shards against one device, to 1e-12 of their scale, on seeded
    fields whose pole rows are as large as the rest; and the Eulerian
    transport beside them. The curl padded with sign 1 past the poles
    (no flip of the tangential components) misses by O(1)."""
    if mesh_shape == (2, 3):
        shape = (8, 8, 18)
    else:
        shape = SHAPE
    _, tm = _models()
    if shape != SHAPE:
        from tests.test_torch_kernels import _configure

        tm = BoussinesqModel(_configure(Parameters.from_text(""), "float64",
                                        shape), device="cpu")
    tm.prepare_sharded(_tmesh(*mesh_shape))
    ops = tm._mesh.ops
    mesh = ops.mesh
    rng = np.random.default_rng(9)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    u = t(rng.standard_normal((3,) + shape))
    faces = [t(rng.standard_normal(shape)) for _ in range(3)]
    pres, T = t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    s = lambda a: shard_field(a, mesh)  # noqa: E731

    def hold(got, want, what):
        got, want = _np(unshard_field(got)), _np(want)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), what

    want_curl = vec.curl_3d(tm.geo, u, tm.u_specs)
    hold(ops.curl(s(u), tm.u_specs), want_curl, "curl")
    up = pad_block(s(u), mesh, 1, sign=1.0)
    unflipped = build(mesh, lambda a, b: crop(vec.curl_3d(
        ops.geo_pad[a, b], up[a, b], tm.u_specs), 1))
    miss = np.abs(_np(unshard_field(unflipped)) - _np(want_curl)).max()
    assert miss > 1e-3 * np.abs(_np(want_curl)).max()
    rot = _rotational(tm)
    plain = ShardedPlainForcing(rot, tm.T_wall, mesh)
    hold(plain.explicit_forcing(s(u), [s(f) for f in faces], s(pres), s(T)),
         rot.explicit_forcing(u, faces, pres, T), "rotational forcing")
    T_adv = plain(s(u), [s(f) for f in faces], s(T), DT)
    assert plain.calls == 1
    hold(T_adv, rot.advected_temperature(faces, T, DT), "transport")


# ----------------------------------------------------------------------
def _seeded(tm, seed=4):
    """A seeded flow of the FEEC tests' shell: u, its faces, p, T."""
    rng = np.random.default_rng(seed)
    shape = tm.geo.cell_shape
    u = 0.1 * rng.standard_normal((3,) + shape)
    pres = 0.01 * rng.standard_normal(shape)
    s0 = state_from_numpy(tm, u, [np.zeros(shape)] * 3, pres, tm.T_init)
    return state_to_numpy(s0._replace(u_faces=tm.interp_to_faces(s0.u)))[:4]


class _JaxSteps:
    """Two JAX steps of each case from the seeded flow, jitted with
    shardings on the 8 virtual devices, made once a case."""

    def __init__(self):
        self.runs = {}

    def __call__(self, case, seeded):
        if case not in self.runs:
            jm = _model(JModel, case)
            jmesh = j_build_mesh(jm.geo)
            jm.prepare_sharded(jmesh, pallas=False)
            sh = state_sharding(jm.geo, jmesh)
            rep = NamedSharding(jmesh, P())
            js, rows = j_shard_state(_jstate(*seeded), jm.geo, jmesh), []
            # compiled once: called again on its own output, the jitted
            # function would compile a second time
            step = jax.jit(jm._step_impl, in_shardings=(sh, rep),
                           out_shardings=(sh, rep)).lower(
                               js, jnp.float64(DT)).compile()
            for _ in range(2):
                js, packed = step(js, jnp.float64(DT))
                rows.append((js, np.asarray(packed)))
            self.runs[case] = (rows, jm.sharded_kernels())
        return self.runs[case]


@pytest.fixture(scope="module")
def jax_steps():
    return _JaxSteps()


@pytest.mark.parametrize("case", CASES)
def test_coupled_mesh_steps_match_jax_and_one_device(case, jax_steps):
    """Two steps of each coupled path through prepare_sharded on (2, 4)
    from a seeded flow: the FEEC 3x3 (flexible FGMRES(16), the GMRES(3)
    shifted Schur complement, the curls and the rotational forcing on the
    shards), the 2x2 block FGMRES(30) and the Schur GMRES(30) around an
    inner CG. Against the JAX step jitted with shardings and the port's
    single device: the fields at the mesh tolerances, equal outer and
    temperature counts (three orders of the sums, the JAX mesh's, the
    port's mesh's and one device's, give one count), the same
    sharded_kernels() report, max|div u| as one device's."""
    tm = _model(BoussinesqModel, case, device="cpu")
    one = _model(BoussinesqModel, case, device="cpu")
    tm.prepare_sharded(_tmesh(2, 4))
    seeded = _seeded(one)
    rows, j_report = jax_steps(case, seeded)
    assert tm.sharded_kernels() == j_report
    s_m = sharded_state_from_numpy(tm, *seeded)
    s_1 = state_from_numpy(one, *seeded)
    for js, jpacked in rows:
        s_m, d_m = tm.step(s_m, DT)
        s_1, d_1 = one.step(s_1, DT)
        _hold_state(s_m, (js, s_1))
        for ref in (jpacked, _np(d_1.packed)):
            np.testing.assert_array_equal(_np(d_m.packed)[[5, 6, 10, 11]],
                                          np.asarray(ref)[[5, 6, 10, 11]])
        assert d_m.poisson_iters > 0 and d_m.solver_ok
        assert d_m.div_norm <= 2.0 * d_1.div_norm + 1e-12
    assert s_m.time == s_1.time


def test_feec_run_adapts_dt_on_the_mesh():
    """The FEEC shell with `adapt time step` = true through ``run`` on
    (2, 2): the dt sequence, the outer counts and the final state of the
    run on one device."""
    runs = []
    for mesh_shape in ((2, 2), None):
        m = _model(BoussinesqModel, "shell_feec", device="cpu")
        m.params.adapt_time_step = True
        if mesh_shape is not None:
            m.prepare_sharded(_tmesh(*mesh_shape))
        runs.append(m.run(max_steps=2))
    (s_m, h_m), (s_1, h_1) = runs
    assert [h["poisson_iters"] for h in h_m] == [
        h["poisson_iters"] for h in h_1]
    np.testing.assert_allclose([h["dt"] for h in h_m],
                               [h["dt"] for h in h_1], rtol=1e-12)
    assert h_1[1]["dt"] != h_1[0]["dt"]
    _hold_state(s_m, (s_1,))


@pytest.mark.parametrize("name", ["shell_feec", "shell_coupled_schur"])
def test_bf16_coupled_mesh_step(name):
    """One bfloat16 step of the FEEC 3x3 and of the Schur GMRES on (2, 2)
    (the whole step in float32 on the widened shards, the state rounded
    once, as on one device) from the single-device bfloat16 state: the
    fields bfloat16 and within 2^-7 of each field's scale of one
    device's step, equal outer counts; time float32."""
    from tests.test_torch_bf16 import TOL, _config

    p = _config(name)
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 16, 32
    one = BoussinesqModel(p, device="cpu")
    s0, _ = one.run(max_steps=2)
    mm = BoussinesqModel(p, device="cpu").prepare_sharded(_tmesh(2, 2))
    dt = float(p.time_step)
    got, d = mm.step(shard_state(s0, mm.geo, mm._mesh.mesh), dt)
    want, d1 = one.step(s0, dt)
    assert d.poisson_iters == d1.poisson_iters > 0 and d.solver_ok
    assert got.time == want.time == float(np.float32(got.time))
    g = unshard_state(got)
    for x, y in zip((g.u, g.p, g.T) + tuple(g.u_faces),
                    (want.u, want.p, want.T) + tuple(want.u_faces)):
        assert x.dtype == torch.bfloat16
        scale = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= TOL * scale


@pytest.mark.parametrize("case", ["shell_coupled", "shell_feec_projection"])
def test_mesh_named_by_an_unindexed_device(case):
    """A mesh whose shards name their device without an index ("cpu:0"
    here, as "cuda" names a card whose tensors report "cuda:0"), with
    `correct pressure to zero mean`: the sums over the mesh are keyed by
    the mesh's devices, so every per-device total is found; one step as
    on one device."""
    from tests.test_torch_feec import _params

    def model(device):
        p = _params(Parameters, case)
        p.correct_pressure_to_zero_mean = True
        return BoussinesqModel(p, device=device)

    tm, one = model("cpu:0"), model("cpu")
    mesh = Mesh(np.array([["cpu:0"] * 2] * 2, dtype=object), ("lat", "lon"))
    tm.prepare_sharded(mesh)
    s1 = one.initial_state()
    sm, dm = tm.step(shard_state(s1, tm.geo, mesh), DT)
    s1, d1 = one.step(s1, DT)
    _hold_state(sm, (s1,))
    assert dm.poisson_iters == d1.poisson_iters
