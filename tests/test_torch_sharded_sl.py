"""The port's mesh step with the semi-Lagrangian temperature transport and
with temperature substeps (``NSE solver interval`` > 1) against the JAX
package's, on a shell of 8 x 8 x 16 in f64: the JAX side on its 8
virtual CPU devices with its kernels in interpret mode
(``prepare_sharded(mesh, interpret=True)``), the port's shards on the
CPU, where its wrappers take the kernels' plain versions.

  * K2mo (K2m in its operands mode) plain against ``ShellForcingPallas(
    halo_mode="operands", advect_T=False)`` (three schemes, 1e-12), and
    ``ShardedShellForcing`` without the transport against the JAX one and
    the port's single-device K2m on meshes (2, 4), (4, 2), (1, 8), (2, 2);
  * the sharded semi-Lagrangian transport against the port's
    single-device one, bitwise, on those meshes and on (2, 3) (an odd
    number of lon shards: the pole rows through ``half_turn``), and
    against the JAX ``semi_lagrangian_transport`` (1e-12 relative); the
    sharded Eulerian transport against the single-device one, bitwise,
    three schemes;
  * two NSE steps and two substeps through ``prepare_sharded`` on (2, 4)
    for SL at NSE = 1 and 2 and Eulerian at NSE = 2, against the JAX
    model's sharded steps (rtol 1e-9, atol 1e-11) and the port's
    single-device steps; ``run`` and ``multi_step`` on the mesh at NSE =
    2; ``sharded_kernels()`` equal to the JAX report; a substep's gate miss
    escalating to the sharded CG as on one device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.models.boussinesq import State as JState
from dycoreplanet_tpu.ops.pallas_stencil import make_shell_forcing
from dycoreplanet_tpu.ops.semi_lagrangian import (
    semi_lagrangian_transport as j_sl)
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, shard_state as j_shard_state,
    state_sharding)
from dycoreplanet_tpu.parallel.sharded_pallas import (
    ShardedShellForcing as JShardedForcing)
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    sharded_state_from_numpy, state_from_numpy)
from dycoreplanet_tpu_torch.ops.forcing import halo_shapes
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.parallel.sharded_pallas import (
    ShardedPlainForcing, ShardedShellForcing)
from dycoreplanet_tpu_torch.parallel.sharded_transport import (
    ShardedSemiLagrangian)
from tests.test_sharded_pallas import _operands_twin
from tests.test_torch_kernels import _configure
from tests.test_torch_semi_lagrangian import _random_flow
from tests.test_torch_sharded import (
    MESHES, SHAPE, _fields, _meshes, _np, _port_forcing, _seed_state)

SL = {"numerics.temperature_advection": "semi-lagrangian"}
NSE2 = {"NSE_solver_interval": 2}


def _models(shape=SHAPE, scheme="muscl", **over):
    jp = _configure(JParameters.from_text(""), "float64", shape,
                    scheme=scheme)
    tp = _configure(Parameters.from_text(""), "float64", shape,
                    scheme=scheme)
    for k, v in over.items():
        for p in (jp, tp):
            obj = p
            *path, last = k.split(".")
            for name in path:
                obj = getattr(obj, name)
            setattr(obj, last, v)
    return JModel(jp), BoussinesqModel(tp, device="cpu")


def _tmesh(A, B):
    return Mesh(np.array([["cpu"] * B] * A, dtype=object), ("lat", "lon"))


# ------------------------------------------------------------------ K2mo
@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
def test_k2mo_plain_matches_jax_operands_kernel(scheme):
    """K2mo's plain version, the whole grid as one shard with the locally
    built ghosts (six: no T ghost), against the JAX operands-mode kernel
    without the transport (interpret mode): the ghosts bitwise, rhs_u to
    1e-12, and against the port's single-device K2m."""
    jm, tm = _models(scheme=scheme, **SL)
    loc = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    assert not loc.advect_T
    op = _operands_twin(jm, loc)
    u, faces, pres = _fields(1)
    T = tm.T_init + 0.1 * np.random.default_rng(2).standard_normal(SHAPE)
    dt = 0.01
    ju = jnp.asarray(u)
    jf = tuple(jnp.asarray(f) for f in faces)
    jT, jp = jnp.asarray(T), jnp.asarray(pres)
    jh = op.build_local_halos(ju, jf, jT, jp)
    want = np.asarray(op(ju, jf, jT, jp, dt, halos=jh))
    k = _port_forcing(tm, halo_mode="operands", local_shape=SHAPE,
                      advect_T=False)
    t = lambda a: torch.as_tensor(np.asarray(a))
    args = (t(u), tuple(t(f) for f in faces), t(T), t(pres))
    th = k.build_local_halos(*args)
    shapes = halo_shapes(SHAPE, advect_T=False)
    assert set(th) == set(shapes) == set(jh) and len(shapes) == 6
    for name, s in shapes.items():
        assert tuple(th[name].shape) == s
        np.testing.assert_array_equal(_np(th[name]), np.asarray(jh[name]),
                                      err_msg=name)
    got = k.call_operands(*args, dt, th, (0, 0))
    assert torch.is_tensor(got)
    np.testing.assert_allclose(_np(got), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(got), _np(tm._forcing(*args, dt)),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_k2mo_matches_jax_and_single_device(mesh_shape):
    """ShardedShellForcing without the transport (no T ghost exchanged,
    rhs_u alone) against the JAX ShardedShellForcing of an SL model and
    the port's single-device K2m, 1e-12."""
    jm, tm = _models(**SL)
    jmesh, tmesh = _meshes(*mesh_shape)
    loc = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    jsh = JShardedForcing(_operands_twin(jm, loc), jmesh, interpret=True)
    u, faces, pres = _fields(3)
    T = tm.T_init + 0.1 * np.random.default_rng(4).standard_normal(SHAPE)
    dt = 0.01
    want = np.asarray(jsh(jnp.asarray(u), tuple(jnp.asarray(f)
                                                for f in faces),
                          jnp.asarray(T), jnp.asarray(pres), dt))
    tsh = ShardedShellForcing(tm._forcing, tmesh)
    assert not tsh.kern.advect_T
    t = lambda a: shard_field(torch.as_tensor(np.asarray(a)), tmesh)
    got = _np(unshard_field(tsh(t(u), tuple(t(f) for f in faces), t(T),
                                t(pres), dt)))
    single = _np(tm._forcing(torch.as_tensor(u),
                             tuple(torch.as_tensor(f) for f in faces),
                             torch.as_tensor(T), torch.as_tensor(pres), dt))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, single, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ transport
@pytest.mark.parametrize("mesh_shape", MESHES + [(2, 3)])
def test_sharded_sl_transport_bitwise(mesh_shape):
    """The sharded semi-Lagrangian transport (the mirror-order pole pad,
    the corners from the lon exchange of the lat-padded shards) equals the
    single-device transport bitwise, on a flow whose displacements clamp
    at +-2 cells in some cells and are fractional in most, next to both
    poles too; and the JAX function to 1e-12 of the field's scale. (2, 3)
    runs a shell of 8 x 8 x 12: its pole rows come from two shards."""
    shape = (8, 8, 12) if mesh_shape == (2, 3) else SHAPE
    jm, tm = _models(shape=shape, **SL)
    K = tm._semi_lagrangian.K
    u = _random_flow(jm.geo, K, seed=7)
    T = tm.T_init + 0.1 * np.random.default_rng(8).standard_normal(shape)
    h = np.stack([tm._semi_lagrangian._h64[d] for d in range(3)])
    s = np.abs(u / h)
    for rows in (slice(0, 2), slice(-2, None)):       # beside each pole
        assert (s[:, :, rows] >= K).any()
        assert ((s[:, :, rows] % 1) > 1e-3).mean() > 0.8
    single = tm._semi_lagrangian(torch.as_tensor(u), torch.as_tensor(T),
                                 1.0)
    tmesh = _tmesh(*mesh_shape)
    ssl = ShardedSemiLagrangian(tm._semi_lagrangian, tmesh)
    t = lambda a: shard_field(torch.as_tensor(a), tmesh)
    got = unshard_field(ssl(t(u), None, t(T), 1.0))
    assert ssl.calls == 1
    assert torch.equal(got, single)
    want = np.asarray(j_sl(jm.geo, jnp.asarray(u), jnp.asarray(T),
                           jm.T_specs, 1.0, ghost_width=K))
    assert float(np.abs(_np(got) - want).max()) <= 1e-12 * np.abs(want).max()


def test_sharded_sl_transport_rejects_thin_shards():
    """A shard of one lat row cannot give the width-2 pad."""
    _, tm = _models(**SL)
    with pytest.raises(ValueError, match="too thin"):
        ShardedSemiLagrangian(tm._semi_lagrangian, _tmesh(8, 1))


@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
def test_sharded_eulerian_transport_bitwise(scheme):
    """The Eulerian T - dt u . grad T on the shards of (2, 4) and (4, 2)
    (``ShardedPlainForcing``: the block padded by two cells, the pole ring
    repeated) equals the single-device transport bitwise."""
    _, tm = _models(scheme=scheme)
    u, faces, _ = _fields(5)
    T = tm.T_init + 0.1 * np.random.default_rng(6).standard_normal(SHAPE)
    dt_T = 0.01
    single = tm._advected_temperature(
        torch.as_tensor(u), tuple(torch.as_tensor(f) for f in faces),
        torch.as_tensor(T), dt_T)
    for mesh_shape in ((2, 4), (4, 2)):
        tmesh = _tmesh(*mesh_shape)
        tr = ShardedPlainForcing(tm._plain_forcing, tm.T_wall, tmesh)
        t = lambda a: shard_field(torch.as_tensor(np.asarray(a)), tmesh)
        got = unshard_field(tr(t(u), tuple(t(f) for f in faces), t(T),
                               dt_T))
        assert torch.equal(got, single), mesh_shape


# ----------------------------------------------------------------- steps
CASES = {"sl": SL, "sl_nse2": dict(SL, **NSE2), "eulerian_nse2": NSE2}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_steps_match_jax_prepare_sharded(case):
    """Two NSE steps (and, at NSE solver interval = 2, the two temperature
    substeps after them) through prepare_sharded on (2, 4) from a seeded
    flow, against JAX prepare_sharded(mesh, interpret=True) stepping its
    sharded state, and against the port's single-device steps: u, p, T
    and the faces rtol 1e-9, atol 1e-11; the packed diagnostics too. The
    SL model runs K2mo and the sharded transport."""
    over = CASES[case]
    jm, tm = _models(**over)
    _, ts = _models(**over)
    jmesh = j_build_mesh(jm.geo)              # 8 devices -> lat 2 x lon 4
    jm.prepare_sharded(jmesh, interpret=True)
    tm.prepare_sharded(_tmesh(2, 4))
    sl = "numerics.temperature_advection" in over
    assert jm._forcing_pallas.advect_T == tm._mesh.forcing.kern.advect_T \
        == (not sl)
    assert tm.sharded_kernels() == jm.sharded_kernels()
    u, faces, pres, T, _, _ = _seed_state(tm)
    js = JState(u=jnp.asarray(u), u_faces=tuple(jnp.asarray(f)
                                                for f in faces),
                p=jnp.asarray(pres), T=jnp.asarray(T),
                time=jnp.asarray(0.0, jnp.float64),
                step_number=jnp.asarray(0))
    sh = state_sharding(jm.geo, jmesh)
    rep = NamedSharding(jmesh, P())
    js = j_shard_state(js, jm.geo, jmesh)
    jit = lambda f: jax.jit(f, in_shardings=(sh, rep),
                            out_shardings=(sh, rep))
    jstep, jsub = jit(jm._step_impl), jit(jm._temperature_step_impl)
    s_t = sharded_state_from_numpy(tm, u, faces, pres, T)
    s_1 = state_from_numpy(ts, u, faces, pres, T)
    dt = float(tm.params.time_step)
    interval = tm.params.NSE_solver_interval
    for n in range(2 * interval):
        nse = n % interval == 0
        js, jpacked = (jstep if nse else jsub)(js, jnp.float64(dt))
        s_t, d_t = (tm.step if nse else tm.temperature_step)(s_t, dt)
        s_1, d_1 = (ts.step if nse else ts.temperature_step)(s_1, dt)
        for ref in (np.asarray(jpacked, np.float32), _np(d_1.packed)):
            np.testing.assert_allclose(_np(d_t.packed)[[0, 1, 2, 3]],
                                       ref[[0, 1, 2, 3]], rtol=1e-6)
            np.testing.assert_array_equal(
                _np(d_t.packed)[[5, 6, 10, 11, 12]], ref[[5, 6, 10, 11, 12]])
        assert d_t.solver_ok and d_t.div_norm <= 1e-9
    got = unshard_state(s_t)
    assert s_t.step_number == 2 * interval
    for name in ("u", "p", "T"):
        for ref in (np.asarray(getattr(js, name)),
                    _np(getattr(s_1, name))):
            np.testing.assert_allclose(_np(getattr(got, name)), ref,
                                       rtol=1e-9, atol=1e-11, err_msg=name)
    for d in range(3):
        for ref in (np.asarray(js.u_faces[d]), _np(s_1.u_faces[d])):
            np.testing.assert_allclose(_np(got.u_faces[d]), ref, rtol=1e-9,
                                       atol=1e-11, err_msg=f"faces{d}")
    if sl:
        assert tm._mesh.transport.calls == 2 * interval
        assert "forcing_momentum_operands" in tm.kernels()


@pytest.mark.parametrize("case", ["sl_nse2", "eulerian_nse2"])
def test_run_and_multi_step_on_the_mesh_nse2(case):
    """run from the sharded initial state and multi_step on the mesh at
    NSE solver interval = 2 (every other step a substep on the shards)
    equal the single-device run (rtol 1e-9), with 0 escalations."""
    _, tm = _models(**CASES[case])
    _, ts = _models(**CASES[case])
    tm.prepare_sharded(_tmesh(2, 4))
    s_m, h_m = tm.run(max_steps=4)
    s_1, h_1 = ts.run(max_steps=4)
    assert tm.escalations == 0 and len(h_m) == 4
    for a, b in zip(h_m, h_1):
        assert a["poisson_iters"] == b["poisson_iters"]
        for k in ("cfl", "max_velocity", "T_min", "T_max"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    g = unshard_state(s_m)
    for name in ("u", "p", "T"):
        np.testing.assert_allclose(_np(getattr(g, name)),
                                   _np(getattr(s_1, name)), rtol=1e-9,
                                   atol=1e-11)
    st0 = shard_state(ts.initial_state(), tm.geo, tm._mesh.mesh)
    s_c, rows, _ = tm.multi_step(st0, float(tm.params.time_step), 4)
    assert rows.shape[0] == 4 and (_np(rows)[1::2, 5] == 0).all()
    for name in ("u", "p", "T"):
        np.testing.assert_allclose(_np(unshard_field(getattr(s_c, name))),
                                   _np(getattr(g, name)), rtol=1e-12,
                                   atol=1e-14)


def test_substep_gate_miss_raises_mesh_cg():
    """A temperature substep on the mesh that misses its gate escalates to
    full CG on the shards, as on one device: run redoes the substep with
    the sharded Jacobi-CG temperature solve (the NSE step before it
    passed), with the escalation count, the window left and the state of
    the single-device run; temperature_step_strong runs on the mesh.
    (Before the sharded Krylov solves this raised naming the item.)"""
    _, tm = _models(**dict(SL, **NSE2))
    _, ts = _models(**dict(SL, **NSE2))
    tm.prepare_sharded(_tmesh(2, 4))
    seen = []

    def stiffen(model):
        def cb(state, rec):
            # after the NSE step: a diffusion two sweeps cannot converge
            seen.append(rec["step"])
            model.one_over_Pe *= 1e6
        return cb

    s_m, h_m = tm.run(max_steps=2, callback=stiffen(tm))
    s_1, h_1 = ts.run(max_steps=2, callback=stiffen(ts))
    assert seen == [0, 1, 0, 1]
    assert tm.escalations == ts.escalations == 1
    assert tm._strong_steps_left == ts._strong_steps_left
    assert h_m[1]["temperature_iters"] == h_1[1]["temperature_iters"] > 2
    np.testing.assert_allclose(_np(unshard_field(s_m.T)), _np(s_1.T),
                               rtol=1e-9, atol=1e-11)
    s = shard_state(ts.initial_state(), tm.geo, tm._mesh.mesh)
    _, d = tm.temperature_step(s, 0.01)
    assert not d.solver_ok and d.temperature_residual > 0
    s2, d2 = tm.temperature_step_strong(s, 0.01)
    _, d1 = ts.temperature_step_strong(ts.initial_state(), 0.01)
    assert d2.temperature_iters == d1.temperature_iters
    assert d2.solver_ok == d1.solver_ok


@pytest.mark.parametrize("kernel,wrapper", [
    ("void <unnamed>::forcing_kernel<float, (bool)0, (bool)1>(Args<float>)",
     "forcing_momentum_operands"),
    ("void (anonymous namespace)::forcing_kernel<double, false, true>"
     "(Args<double>)", "forcing_momentum_operands"),
])
def test_k2mo_kernel_name_maps_to_its_wrapper(kernel, wrapper):
    """The profiler tells K2mo (ADVECT_T false, OPS true) from K2o and
    K2m."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import wrapper_of
    assert wrapper_of(kernel) == wrapper
