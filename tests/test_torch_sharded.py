"""The port's mesh step (``BoussinesqModel.prepare_sharded``) against the
JAX package's, on a shell of 8 x 8 x 16 in f64: the JAX side on its 8
virtual CPU devices with its kernels in interpret mode (as
tests/test_sharded_pallas.py runs them), the port's shards on the CPU,
where its wrappers take the kernels' plain versions.

  * K2o's plain version against ``ShellForcingPallas(halo_mode=
    "operands")`` with ``build_local_halos`` (three schemes, 1e-12), and
    ``ShardedShellForcing`` against the JAX one and the port's
    single-device forcing on meshes (2, 4), (4, 2), (1, 8), (2, 2);
  * K1o's tables against ``build_shard_metrics``, and
    ``ShardedShellRichardson`` against the JAX one on the same meshes
    (the tolerances of test_sharded_pallas.py:160-176);
  * ``ShardedShellPoissonFastDiag`` against the JAX one (1e-12);
  * three steps through ``prepare_sharded`` on (2, 4) against the JAX
    model's (rtol 1e-9, atol 1e-11) and against the port's single-device
    step; ``run`` and ``multi_step`` on the mesh;
  * ``sharded_kernels()`` equal to the JAX report, and the
    configurations once refused (the direct Helmholtz solves, the
    stretched shell's spectral CG) stepping as on one device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.models.boussinesq import State as JState
from dycoreplanet_tpu.ops.pallas_stencil import make_shell_forcing
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, shard_state as j_shard_state,
    state_sharding)
from dycoreplanet_tpu.parallel.sharded_pallas import (
    ShardedShellForcing as JShardedForcing)
from dycoreplanet_tpu.parallel.sharded_richardson import (
    make_sharded_richardson as j_make_sharded_richardson)
from dycoreplanet_tpu.solvers.spectral import (
    ShardedShellPoissonFastDiag as JShardedPoisson)
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.entry import dryrun_multichip
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    sharded_state_from_numpy, state_from_numpy, state_to_numpy)
from dycoreplanet_tpu_torch.ops.forcing import ShellForcing, halo_shapes
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.parallel.sharded_pallas import (
    ShardedShellForcing)
from dycoreplanet_tpu_torch.parallel.sharded_richardson import (
    make_sharded_richardson)
from dycoreplanet_tpu_torch.solvers.spectral import (
    ShardedShellPoissonFastDiag)
from tests.test_sharded_pallas import _operands_twin
from tests.test_torch_kernels import _configure

from jax.sharding import NamedSharding, PartitionSpec as P

SHAPE = (8, 8, 16)
MESHES = [(2, 4), (4, 2), (1, 8), (2, 2)]


def _models(scheme="muscl", iters=2, iters_u=0, **over):
    kw = dict(scheme=scheme, iters=iters, iters_u=iters_u)
    jp = _configure(JParameters.from_text(""), "float64", SHAPE, **kw)
    tp = _configure(Parameters.from_text(""), "float64", SHAPE, **kw)
    for k, v in over.items():
        for p in (jp, tp):
            obj = p
            *path, last = k.split(".")
            for name in path:
                obj = getattr(obj, name)
            setattr(obj, last, v)
    return JModel(jp), BoussinesqModel(tp, device="cpu")


def _meshes(A, B):
    jm = JMesh(np.asarray(jax.devices()[:A * B]).reshape(A, B),
               ("lat", "lon"))
    tm = Mesh(np.array([["cpu"] * B] * A, dtype=object), ("lat", "lon"))
    return jm, tm


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3,) + SHAPE),
            [rng.standard_normal(SHAPE) for _ in range(3)],
            rng.standard_normal(SHAPE))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _port_forcing(tm, **over):
    f = tm._forcing
    kw = dict(beta=f.beta, T_ref=f.T_ref, rho_background=f.rho_background,
              gravity=f.gravity, one_over_Re=f.one_over_Re,
              omega_hat=f.omega_hat, coriolis_mode=f.coriolis_mode,
              buoyancy=f.buoyancy, scheme=f.scheme,
              include_gradp=f.include_gradp, u_specs=f.u_specs,
              p_specs=f.p_specs, T_specs=f.T_specs, T_wall=f._T_wall,
              dt_T_factor=f.dt_T_factor)
    kw.update(over)
    return ShellForcing(tm.geo, **kw)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
def test_k2o_plain_matches_jax_operands_kernel(scheme):
    """K2o's plain version, the whole grid as one shard with the locally
    built ghosts, against the JAX operands-mode kernel (interpret mode)
    with its build_local_halos: the ghosts bitwise, rhs_u and T_adv to
    1e-12."""
    jm, tm = _models(scheme=scheme)
    loc = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    op = _operands_twin(jm, loc)
    u, faces, pres = _fields(1)
    T = tm.T_init + 0.1 * np.random.default_rng(2).standard_normal(SHAPE)
    dt = 0.01
    ju = jnp.asarray(u)
    jf = tuple(jnp.asarray(f) for f in faces)
    jT, jp = jnp.asarray(T), jnp.asarray(pres)
    jh = op.build_local_halos(ju, jf, jT, jp)
    want = op(ju, jf, jT, jp, dt, halos=jh)
    k = _port_forcing(tm, halo_mode="operands", local_shape=SHAPE)
    t = lambda a: torch.as_tensor(np.asarray(a))
    args = (t(u), tuple(t(f) for f in faces), t(T), t(pres))
    th = k.build_local_halos(*args)
    assert set(th) == set(halo_shapes(SHAPE)) == set(jh)
    for name, s in halo_shapes(SHAPE).items():
        assert tuple(th[name].shape) == s
        np.testing.assert_array_equal(_np(th[name]), np.asarray(jh[name]),
                                      err_msg=name)
    got = k.call_operands(*args, dt, th, (0, 0))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-12,
                               atol=1e-13)
    # and the port's single-device forcing
    single = tm._forcing(*args, dt)
    for g, w in zip(got, single):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_forcing_matches_jax_and_single_device(mesh_shape):
    """ShardedShellForcing (ghost exchange, pole half turn, K2o's plain
    version on every shard) against the JAX ShardedShellForcing and the
    port's single-device forcing, 1e-12."""
    jm, tm = _models()
    jmesh, tmesh = _meshes(*mesh_shape)
    loc = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    jsh = JShardedForcing(_operands_twin(jm, loc), jmesh, interpret=True)
    u, faces, pres = _fields(3)
    T = tm.T_init + 0.1 * np.random.default_rng(4).standard_normal(SHAPE)
    dt = 0.01
    want = jsh(jnp.asarray(u), tuple(jnp.asarray(f) for f in faces),
               jnp.asarray(T), jnp.asarray(pres), dt)
    tsh = ShardedShellForcing(tm._forcing, tmesh)
    t = lambda a: shard_field(torch.as_tensor(np.asarray(a)), tmesh)
    got = tsh(t(u), tuple(t(f) for f in faces), t(T), t(pres), dt)
    single = tm._forcing(torch.as_tensor(u),
                         tuple(torch.as_tensor(f) for f in faces),
                         torch.as_tensor(T), torch.as_tensor(pres), dt)
    for g, w, s, tol in zip(got, want, single, (1e-12, 1e-13)):
        g = _np(unshard_field(g))
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, atol=tol)
        np.testing.assert_allclose(g, _np(s), rtol=1e-12, atol=tol)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (1, 16)])
def test_too_thin_shard_rejected(mesh_shape):
    """1-row lat shards (and 1-column lon shards) cannot host width-2
    halos: ValueError, as in the JAX package."""
    _, tm = _models()
    A, B = mesh_shape
    tmesh = Mesh(np.array([["cpu"] * B] * A, dtype=object), ("lat", "lon"))
    with pytest.raises(ValueError, match="too thin"):
        ShardedShellForcing(tm._forcing, tmesh)


# ----------------------------------------------------------------------
def test_shard_metrics_match_jax():
    """K1o's per-shard tables hold the JAX build_shard_metrics channels:
    each radial block's rows of the JAX (A, nb, 15, ext_r, ext_lat) stack
    equal the port's (A, 17, nr, ext_lat) slabs' first 15 channels; the
    lat face areas past a pole are exactly 0."""
    jm, tm = _models()
    for A, B in [(2, 4), (2, 2)]:
        jmesh, tmesh = _meshes(A, B)
        jk = j_make_sharded_richardson(jm, jmesh, interpret=True).kern
        tk = make_sharded_richardson(tm, tmesh).kern
        want = jk.build_shard_metrics(A)
        got = tk.build_shard_metrics(A)
        H, blk = jk.H, jk.blk
        assert tk.GH == jk.GH == H
        for a in range(A):
            for i in range(jk.nb):
                np.testing.assert_allclose(
                    got[a, :15, i * blk:(i + 1) * blk],
                    want[a, i, :, H:H + blk], rtol=1e-14, atol=0)
        assert not got[0, 11, :, :H + 1].any()
        assert not got[-1, 11, :, -H:].any()


def _richardson_inputs(seed=17):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, *SHAPE), rng.randn(*SHAPE), rng.randn(*SHAPE))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_richardson_matches_jax(mesh_shape):
    """ShardedShellRichardson (stacked exchange, K1o's plain version, the
    fixed-order sum) against the JAX one at the tolerances of
    test_sharded_pallas.py:160-176, and against the port's single-device
    Richardson stage. Two sweeps a system (halo 3) where the shards hold
    it, else one (halo 2: the 2-row shards of (4, 2) and (1, 8))."""
    A, B = mesh_shape
    iters = 2 if (SHAPE[1] // A >= 3 and SHAPE[2] // B >= 3) else 1
    jm, tm = _models(iters=iters, iters_u=iters)
    jmesh, tmesh = _meshes(A, B)
    jrk = j_make_sharded_richardson(jm, jmesh, interpret=True)
    trk = make_sharded_richardson(tm, tmesh)
    assert jrk is not None and trk is not None
    ru, rT, T0 = _richardson_inputs()
    dt = 0.004
    want = jrk(jnp.asarray(ru), jnp.asarray(rT), jnp.asarray(T0), dt)
    s = lambda a: shard_field(torch.as_tensor(a), tmesh)
    got = trk(s(ru), s(rT), s(T0), dt)
    single = tm._richardson(torch.as_tensor(ru), torch.as_tensor(rT),
                            torch.as_tensor(T0), dt)
    for ref in (want, single):
        for i in range(2):
            np.testing.assert_allclose(_np(unshard_field(got[i])),
                                       _np(ref[i]), rtol=1e-11, atol=1e-12)
        for d in range(3):
            np.testing.assert_allclose(_np(unshard_field(got[2][d])),
                                       _np(ref[2][d]), rtol=1e-11,
                                       atol=1e-12, err_msg=f"f{d}")
        scale = float(np.abs(_np(ref[2][3])).max()) + 1e-30
        np.testing.assert_allclose(_np(unshard_field(got[2][3])),
                                   _np(ref[2][3]), rtol=1e-9,
                                   atol=1e-11 * scale)
        for k in range(4):
            np.testing.assert_allclose(float(got[3][k]), float(ref[3][k]),
                                       rtol=1e-6)
    assert trk.kern.launches == 0          # CPU: the plain version


def test_sharded_richardson_gates_match_jax():
    """Too-thin shards and CG-only configurations: the JAX factory returns
    None (its GSPMD plain path) and so does the port's."""
    jm, tm = _models()
    jmesh, tmesh = _meshes(1, 8)          # nlon_local = 2 < H = 3
    assert j_make_sharded_richardson(jm, jmesh, interpret=True) is None
    assert make_sharded_richardson(tm, tmesh) is None
    jm, tm = _models(iters=0)
    jmesh, tmesh = _meshes(2, 4)
    assert j_make_sharded_richardson(jm, jmesh, interpret=True) is None
    assert make_sharded_richardson(tm, tmesh) is None


# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_poisson_matches_jax(mesh_shape):
    """ShardedShellPoissonFastDiag (local contractions, one fixed-order sum,
    the eigen-space work once a device) against the JAX one, 1e-12."""
    jm, tm = _models()
    jmesh, tmesh = _meshes(*mesh_shape)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(SHAPE)
    b -= b.mean()
    want = np.asarray(JShardedPoisson(jm.poisson_spectral, jmesh)(
        jnp.asarray(b)))
    solver = ShardedShellPoissonFastDiag(tm.poisson_spectral, tmesh)
    got, iters = solver.solve(shard_field(torch.as_tensor(b), tmesh))
    assert iters == 0
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(unshard_field(got)), want, rtol=1e-12,
                               atol=1e-12 * scale)
    single = _np(tm.poisson_spectral(torch.as_tensor(b)))
    np.testing.assert_allclose(_np(unshard_field(got)), single, rtol=1e-12,
                               atol=1e-12 * scale)


# ----------------------------------------------------------------------
def _seed_state(tm, seed=5):
    rng = np.random.default_rng(seed)
    u = 0.1 * rng.standard_normal((3,) + SHAPE)
    pres = 0.01 * rng.standard_normal(SHAPE)
    st0 = state_from_numpy(tm, u, [np.zeros(SHAPE)] * 3, pres, tm.T_init)
    st0 = st0._replace(u_faces=tm.interp_to_faces(st0.u))
    return state_to_numpy(st0)


def test_full_step_matches_jax_prepare_sharded():
    """Three steps through prepare_sharded on (2, 4) from a seeded flow,
    against JAX prepare_sharded(mesh, interpret=True) stepping its
    sharded state, and against the port's single-device step: u, p, T
    and the faces rtol 1e-9, atol 1e-11; the packed diagnostics too."""
    jm, tm = _models()
    _, ts = _models()
    jmesh = j_build_mesh(jm.geo)              # 8 devices -> lat 2 x lon 4
    tmesh = Mesh(np.array([["cpu"] * 4] * 2, dtype=object), ("lat", "lon"))
    jm.prepare_sharded(jmesh, interpret=True)
    tm.prepare_sharded(tmesh)
    u, faces, pres, T, _, _ = _seed_state(tm)
    js = JState(u=jnp.asarray(u), u_faces=tuple(jnp.asarray(f)
                                                for f in faces),
                p=jnp.asarray(pres), T=jnp.asarray(T),
                time=jnp.asarray(0.0, jnp.float64),
                step_number=jnp.asarray(0))
    sh = state_sharding(jm.geo, jmesh)
    rep = NamedSharding(jmesh, P())
    js = j_shard_state(js, jm.geo, jmesh)
    jstep = jax.jit(jm._step_impl, in_shardings=(sh, rep),
                    out_shardings=(sh, rep))
    s_t = sharded_state_from_numpy(tm, u, faces, pres, T)
    s_1 = state_from_numpy(ts, u, faces, pres, T)
    dt = float(tm.params.time_step)
    for _ in range(3):
        js, jpacked = jstep(js, jnp.float64(dt))
        s_t, d_t = tm.step(s_t, dt)
        s_1, d_1 = ts.step(s_1, dt)
    got = unshard_state(s_t)
    assert s_t.step_number == 3 and isinstance(s_t.time, float)
    for name in ("u", "p", "T"):
        for ref in (np.asarray(getattr(js, name)),
                    _np(getattr(s_1, name))):
            np.testing.assert_allclose(_np(getattr(got, name)), ref,
                                       rtol=1e-9, atol=1e-11, err_msg=name)
    for d in range(3):
        for ref in (np.asarray(js.u_faces[d]), _np(s_1.u_faces[d])):
            np.testing.assert_allclose(_np(got.u_faces[d]), ref, rtol=1e-9,
                                       atol=1e-11, err_msg=f"faces{d}")
    # cfl, max|u|, T range; iteration counts; solver_ok
    for ref in (np.asarray(jpacked, np.float32), _np(d_1.packed)):
        np.testing.assert_allclose(_np(d_t.packed)[[0, 1, 2, 3]],
                                   ref[[0, 1, 2, 3]], rtol=1e-6)
        np.testing.assert_array_equal(_np(d_t.packed)[[5, 6, 10, 11, 12]],
                                      ref[[5, 6, 10, 11, 12]])
    assert d_t.div_norm <= 1e-9


def test_run_and_multi_step_on_the_mesh():
    """run (the gate read once a step) from the sharded initial state and
    multi_step on the mesh equal the single-device run and step loop
    (rtol 1e-9), with 0 escalations; the wrappers count no launch on the
    CPU."""
    _, tm = _models()
    _, ts = _models()
    tm.prepare_sharded(Mesh(np.array([["cpu"] * 4] * 2, dtype=object),
                            ("lat", "lon")))
    s_m, h_m = tm.run(max_steps=3)
    s_1, h_1 = ts.run(max_steps=3)
    assert tm.escalations == 0 and len(h_m) == 3
    for a, b in zip(h_m, h_1):
        for k in ("cfl", "max_velocity", "T_min", "T_max"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    g = unshard_state(s_m)
    for name in ("u", "p", "T"):
        np.testing.assert_allclose(_np(getattr(g, name)),
                                   _np(getattr(s_1, name)), rtol=1e-9,
                                   atol=1e-11)
    st0 = shard_state(ts.initial_state(), tm.geo, tm._mesh.mesh)
    dt = float(tm.params.time_step)
    s_c, rows, _ = tm.multi_step(st0, dt, 3)
    assert rows.shape[0] == 3
    for name in ("u", "p", "T"):
        np.testing.assert_allclose(_np(unshard_field(getattr(s_c, name))),
                                   _np(getattr(g, name)), rtol=1e-12,
                                   atol=1e-14)


# ----------------------------------------------------------------------
def test_sharded_kernels_report_matches_jax():
    """prepare_sharded reports the same implementation for each hot stage
    as the JAX package; with `residual check interval` = 4 the mesh runs
    per-step checks and says so, as the JAX report does."""
    for over in ({}, {"numerics.residual_check_interval": 4}):
        jm, tm = _models(**over)
        jm.prepare_sharded(j_build_mesh(jm.geo), interpret=True)
        with pytest.warns(RuntimeWarning) if over else _null():
            tm.prepare_sharded(Mesh(np.array([["cpu"] * 4] * 2,
                                             dtype=object), ("lat", "lon")))
        assert tm.sharded_kernels() == jm.sharded_kernels()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_interval_mode_runs_per_step_checks_on_the_mesh():
    """`residual check interval` = 4 on the mesh: every step's residuals
    are tracked (none is the -1 sentinel), the state as on one device."""
    _, tm = _models(**{"numerics.residual_check_interval": 4})
    _, ts = _models()
    with pytest.warns(RuntimeWarning, match="per-step"):
        tm.prepare_sharded(Mesh(np.array([["cpu"] * 4] * 2, dtype=object),
                                ("lat", "lon")))
    s = shard_state(ts.initial_state(), tm.geo, tm._mesh.mesh)
    s1 = ts.initial_state()
    dt = float(tm.params.time_step)
    for _ in range(2):
        s, d = tm.step(s, dt)
        s1, _ = ts.step(s1, dt)
        assert d.helmholtz_residual >= 0 and d.temperature_residual >= 0
    np.testing.assert_allclose(_np(unshard_field(s.u)), _np(s1.u),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("over", [
    {"space_dimension": 2, "numerics.helmholtz_solver": "direct"},
    {"numerics.helmholtz_solver": "direct"},
    {"stretched": True},
], ids=["annulus-direct", "shell-direct", "stretched"])
def test_refused_configurations_name_their_item(over):
    """The configurations prepare_sharded once refused (naming their
    ROADMAP.md item) run on the mesh now: the annulus and the shell with
    `helmholtz solver = direct` and the shell of non-uniform radial
    spacing (``stretched``, whose Poisson solve is the spectral CG; its
    `poisson tol` at 1e-12, where the CG count does not move with the
    order of the sums: tests/test_torch_sharded_direct.py). One step on
    build_mesh's mesh of 8 shards against the port's one device, the
    sharding bounds (1e-9 of u, T; 1e-7 of p), equal counts."""
    from dycoreplanet_tpu_torch.models.presets import stretched_shell
    from dycoreplanet_tpu_torch.parallel.mesh import build_mesh

    over = dict(over)
    stretched = over.pop("stretched", False)

    def make():
        tp = _configure(Parameters.from_text(""), "float64", SHAPE)
        for k, v in over.items():
            obj = tp
            *path, last = k.split(".")
            for name in path:
                obj = getattr(obj, name)
            setattr(obj, last, v)
        if stretched:
            tp.numerics.poisson_tol = 1e-12
        return BoussinesqModel(tp, device="cpu", geometry=(
            stretched_shell(SHAPE) if stretched else None))

    one, tm = make(), make()
    tm.prepare_sharded(build_mesh(tm.geo, ["cpu"] * 8))
    s1 = one.initial_state()
    sm = shard_state(s1, tm.geo, tm._mesh.mesh)
    dt = float(tm.params.time_step)
    s1, d1 = one.step(s1, dt)
    sm, dm = tm.step(sm, dt)
    g = unshard_state(sm)
    for name, tol in (("u", 1e-9), ("T", 1e-9), ("p", 1e-7)):
        np.testing.assert_allclose(_np(getattr(g, name)),
                                   _np(getattr(s1, name)), rtol=tol,
                                   atol=tol * 1e-2, err_msg=name)
    assert (dm.poisson_iters, dm.temperature_iters) == \
        (d1.poisson_iters, d1.temperature_iters)
    assert list(dm.helmholtz_iters) == list(d1.helmholtz_iters)


def test_gate_outside_the_sharded_stage_and_escalation_raise():
    """A mesh the sharded Richardson stage's gates refuse (1 x 8: shards
    of two lon columns, thinner than its ghost depth) runs the plain
    Richardson solves on the shards, as the JAX package's GSPMD plain
    path does, and reports them ("jnp"); on the mesh a gate miss
    escalates to the sharded CG through run and step_strong runs, both as
    on one device. (Before the sharded Krylov solves these raised naming
    the item.)"""
    _, tm = _models()
    _, ts = _models()
    tm.prepare_sharded(Mesh(np.array([["cpu"] * 8], dtype=object),
                            ("lat", "lon")))
    assert tm.sharded_kernels()["richardson"] == "jnp"
    s_m, _ = tm.run(max_steps=2)
    s_1, _ = ts.run(max_steps=2)
    np.testing.assert_allclose(_np(unshard_field(s_m.u)), _np(s_1.u),
                               rtol=1e-9, atol=1e-11)
    over = {"numerics.helmholtz_tol": 1e-300}
    (_, tm), (_, ts) = _models(**over), _models(**over)
    tm.prepare_sharded(Mesh(np.array([["cpu"] * 4] * 2, dtype=object),
                            ("lat", "lon")))
    s_m, h_m = tm.run(max_steps=2)
    s_1, h_1 = ts.run(max_steps=2)
    assert tm.escalations == ts.escalations == 1
    assert tm._strong_steps_left == ts._strong_steps_left == 7
    np.testing.assert_allclose(_np(unshard_field(s_m.u)), _np(s_1.u),
                               rtol=1e-9, atol=1e-11)
    s = shard_state(tm.initial_state(), tm.geo, tm._mesh.mesh)
    _, d = tm.step_strong(s, 0.01)
    _, d1 = ts.step_strong(ts.initial_state(), 0.01)
    assert d.helmholtz_iters[0] == d1.helmholtz_iters[0] > 0


def test_dryrun_multichip_on_the_cpu():
    """The JAX entry's counterpart, all three parts over 8 shards: (i) the
    kernel-free step (every stage "jnp"), (ii) the kernel path within
    1e-5 of (i) and of the single-device step, (iii) the mimetic model on
    the same mesh within 1e-5 of its single-device step; each finite,
    divergence-free to 1e-8."""
    rep = dryrun_multichip(8, device="cpu")
    parts = rep["parts"]
    assert rep["mesh"] == {"lat": 2, "lon": 4}
    assert rep["kernels"]["richardson"] == "pallas-sharded"
    assert rep["err"] < 1e-5
    assert parts["plain"]["kernels"] == {
        "forcing": "jnp", "richardson": "jnp",
        "poisson": "ShardedShellPoissonFastDiag"}
    assert parts["kernels"]["err_plain"] < 1e-5
    assert parts["mimetic"]["kernels"]["forcing"] == "jnp"
    assert parts["mimetic"]["err"] < 1e-5
    for part in parts.values():
        assert 0 < part["max_velocity"] < 1 and part["div_norm"] < 1e-8


@pytest.mark.parametrize("kernel,wrapper", [
    ("void <unnamed>::rich_fused<float, (int)0, (int)0, (int)0, (int)0, "
     "(bool)1, (bool)1>(Pass<float>)", "richardson_operands"),
    ("void <unnamed>::rich_fused<float, (int)8, (int)8, (int)32, (int)2, "
     "(bool)1, (bool)0>(Pass<float>)", "richardson"),
    ("void <unnamed>::rich_fused<double, (int)0, (int)0, (int)0, (int)0, "
     "(bool)0, (bool)0>(Pass<double>)", "richardson_free"),
    ("void (anonymous namespace)::forcing_kernel<float, true, true>"
     "(Args<float>)", "forcing_operands"),
    ("void <unnamed>::forcing_kernel<float, (bool)1, (bool)0>(Args<float>)",
     "forcing"),
    ("void <unnamed>::forcing_kernel<double, (bool)0, (bool)0>"
     "(Args<double>)", "forcing_momentum"),
])
def test_operands_kernel_names_map_to_wrappers(kernel, wrapper):
    """The profiler tells K1o and K2o (OPS true) from K1, K1u, K2 and K2m
    by their last template argument."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import wrapper_of
    assert wrapper_of(kernel) == wrapper


def test_odd_lon_shard_count_pole_closure():
    """With an odd number of lon shards (B = 3, a shell of 8 x 8 x 12) the
    half turn to lon + pi falls inside a shard: the port's sharded
    forcing equals its single-device forcing (1e-12). The JAX package's
    ShardedShellForcing does not (its _half_turn, sharded_pallas.py:94-107,
    rolls each shard's own row by nlon_local / 2): its pole rows miss the
    single-device oracle by far more than round-off (ROADMAP.md Queue 3)."""
    shape = (8, 8, 12)
    jp = _configure(JParameters.from_text(""), "float64", shape)
    tp = _configure(Parameters.from_text(""), "float64", shape)
    jm, tm = JModel(jp), BoussinesqModel(tp, device="cpu")
    rng = np.random.default_rng(3)
    u = rng.standard_normal((3,) + shape)
    faces = [rng.standard_normal(shape) for _ in range(3)]
    T = tm.T_init + 0.1 * rng.standard_normal(shape)
    pres = rng.standard_normal(shape)
    dt = 0.01
    tmesh = Mesh(np.array([["cpu"] * 3] * 2, dtype=object), ("lat", "lon"))
    t = lambda a: shard_field(torch.as_tensor(np.asarray(a)), tmesh)
    got = ShardedShellForcing(tm._forcing, tmesh)(
        t(u), tuple(t(f) for f in faces), t(T), t(pres), dt)
    single = tm._forcing(torch.as_tensor(u),
                         tuple(torch.as_tensor(f) for f in faces),
                         torch.as_tensor(T), torch.as_tensor(pres), dt)
    for g, w in zip(got, single):
        np.testing.assert_allclose(_np(unshard_field(g)), _np(w),
                                   rtol=1e-12, atol=1e-13)
    # the JAX package on the same mesh, against its own oracle
    jmesh = JMesh(np.asarray(jax.devices()[:6]).reshape(2, 3),
                  ("lat", "lon"))
    loc = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    ju = jnp.asarray(u)
    jf = tuple(jnp.asarray(f) for f in faces)
    want = np.asarray(ju + dt * jm._explicit_forcing(
        ju, jf, jnp.asarray(pres), jnp.asarray(T)))
    jgot = np.asarray(JShardedForcing(_operands_twin(jm, loc), jmesh,
                                      interpret=True)(
        ju, jf, jnp.asarray(T), jnp.asarray(pres), dt)[0])
    err = np.abs(jgot - want)
    np.testing.assert_allclose(_np(unshard_field(got[0])), want,
                               rtol=1e-12, atol=1e-12)
    assert err.max() > 1e-3
    assert sorted(set(np.nonzero(err > 1e-10)[2].tolist())) == [0, 1, 6, 7]
