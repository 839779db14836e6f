"""``poisson solver = mg`` on the port's mesh (``prepare_sharded``)
against the JAX package and the port's single device, in f64 on the CPU
(the port's shards there take the kernels' plain versions):

  * the sharded V-cycle (solvers/multigrid.py ``ShardedPoissonMultigrid``)
    on (2, 2) and (2, 4) against the port's single-device
    ``PoissonMultigrid(line_axes_allowed=(0,))`` and the JAX one on the
    same numpy residual, to round-off: its line solves one K4 call a shard
    on the shard's own columns, nothing copied, the restriction and the
    prolongation on each shard alone;
  * an MG-CG mesh step at 8 x 8 x 16 on (2, 4) from a seeded flow against
    the JAX model
    after ``prepare_sharded(build_mesh(geo, jax.devices()[:8]),
    pallas=False)``, its ``_step_impl`` jitted with shardings as
    tests/test_collectives.py holds it, and against the port's single
    device with the same radial-only rebuild: u, T rtol 1e-8 / atol 1e-10,
    p 1e-7 / 1e-9, equal CG counts;
  * a bfloat16 mesh MG step within the bfloat16 bound of one device's,
    every line solve K4's bfloat16-rhs form;
  * the ValueError of a hierarchy level the mesh does not divide.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.ops.bc import BC as JBC, BCSpec as JSpec
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, shard_state as j_shard_state,
    state_sharding)
from dycoreplanet_tpu.solvers.multigrid import PoissonMultigrid as JMG
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models.convert import (
    sharded_state_from_numpy, state_from_numpy)
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.parallel.mesh import (
    shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.solvers.multigrid import (
    PoissonMultigrid, ShardedPoissonMultigrid)
from tests.test_torch_multigrid import _p_specs
from tests.test_torch_sharded import _models, _np, _seed_state
from tests.test_torch_sharded_cg import _hold_state, _jstate, _tmesh

DT = 0.01
MG = {"numerics.poisson_solver": "mg"}
VSHAPE = (16, 32, 64)       # three levels: 16x32x64, 8x16x32, 4x8x16


class _Counting:
    """A K4 wrapper that records the rhs of every call."""

    def __init__(self, base):
        self.base = base
        self.rhs = []

    def __call__(self, lower, diag, upper, rhs):
        self.rhs.append(rhs)
        return self.base(lower, diag, upper, rhs)


def _radial(model):
    """The model's single-device yardstick: its V-cycle rebuilt with the
    line smoother on the radial axis alone."""
    model.poisson_precond = PoissonMultigrid(
        model.geo, model.p_specs, dtype=model.torch_dtype,
        device=model.device, tridiag=model._tridiag, line_axes_allowed=(0,))
    return model


@pytest.fixture(scope="module")
def vcycles():
    """The port's radial-only V-cycle of the shell at VSHAPE, a seeded
    residual and the JAX radial-only V-cycle of it (jitted)."""
    tgeo = t_factory.make_shell(*VSHAPE, 1.0, 2.0)
    jgeo = j_factory.make_shell(*VSHAPE, 1.0, 2.0)
    tm = PoissonMultigrid(tgeo, _p_specs(tgeo, BCSpec, BC), dtype=np.float64,
                          line_axes_allowed=(0,))
    jm = JMG(jgeo, _p_specs(jgeo, JSpec, JBC), dtype=np.float64,
             line_axes_allowed=(0,))
    r = np.random.default_rng(2).standard_normal(VSHAPE)
    assert tm.line_axes == [0] == list(jm.line_axes)
    return tm, np.asarray(jax.jit(jm.__call__)(jnp.asarray(r))), r


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_sharded_vcycle_matches_single_device_and_jax(mesh_shape, vcycles):
    """One V-cycle on the shards against the port's single device and the
    JAX V-cycle (both relaxing along r alone), within 1e-12 of the
    result's scale; 3 levels, 2 * 2 * 2 + 40 = 48 line solves a cycle,
    each an A * B of K4 calls on the shards' own (nr, nl, no) blocks:
    nothing copied (K4's description reads each operand as passed), the
    rhs the shard's residual itself."""
    tm, want_jax, r = vcycles
    assert len(tm.geos) == 3
    mesh = _tmesh(*mesh_shape)
    sm = ShardedPoissonMultigrid(tm, mesh)
    sm.tridiag = counting = _Counting(tm.tridiag)
    got = _np(unshard_field(sm(shard_field(torch.as_tensor(r), mesh))))
    want = _np(tm(torch.as_tensor(r)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.abs(got - want_jax).max() <= 1e-12 * scale
    A, B = mesh_shape
    assert sm.line_solves_per_cycle() == 48
    assert len(counting.rhs) == A * B * 48
    for level, op in enumerate(sm.ops):
        nr, nl, no = op.local
        for ab in op.offsets:
            x = torch.zeros((nr, nl, no), dtype=torch.float64)
            lay = k4.layout(*sm.shard_operands(level, ab, x))
            assert lay.copied == ()
            assert sm.shard_operands(level, ab, x)[3] is x
    shapes = {tuple(t.shape) for t in counting.rhs}
    assert shapes == {(g.cell_shape[0], g.cell_shape[1] // A,
                       g.cell_shape[2] // B) for g in tm.geos}


@pytest.fixture(scope="module")
def jax_mg_steps():
    """A JAX MG-CG step from the seeded state on its 8 virtual devices,
    prepare_sharded(mesh, pallas=False), jitted with shardings."""
    jm, tm = _models(**MG)
    seeded = _seed_state(tm)[:4]
    jmesh = j_build_mesh(jm.geo, jax.devices()[:8])
    jm.prepare_sharded(jmesh, pallas=False)
    assert list(jm.poisson_precond.line_axes) == [0]
    sh = state_sharding(jm.geo, jmesh)
    rep = NamedSharding(jmesh, P())
    step = jax.jit(jm._step_impl, in_shardings=(sh, rep),
                   out_shardings=(sh, rep))
    js, packed = step(j_shard_state(_jstate(*seeded), jm.geo, jmesh),
                      jnp.float64(DT))
    return seeded, [(js, np.asarray(packed))], jm.sharded_kernels()


def test_mg_mesh_step_matches_jax_and_one_device(jax_mg_steps):
    """A step of the MG-CG model through prepare_sharded on (2, 4)
    (K2o and K1o's plain versions, the Poisson CG preconditioned by the
    sharded radial V-cycle) against the JAX sharded step and the port's
    single device with the radial-only rebuild: the fields at the mesh
    tolerances, equal CG counts (> 0) and verdicts, the Poisson solve
    reported as the JAX mesh reports it; every shard's line solve a K4
    call, (CG iterations + 1) V-cycles a Poisson solve."""
    seeded, rows, j_report = jax_mg_steps
    _, tm = _models(**MG)
    _, ts = _models(**MG)
    tm.prepare_sharded(_tmesh(2, 4))
    _radial(ts)
    assert tm.sharded_kernels()["poisson"] == j_report["poisson"] == "mg-cg"
    mg = tm._mesh.multigrid
    mg.tridiag = counting = _Counting(mg.tridiag)
    s_m = sharded_state_from_numpy(tm, *seeded)
    s_1 = state_from_numpy(ts, *seeded)
    for js, jpacked in rows:
        n0 = len(counting.rhs)
        s_m, d_m = tm.step(s_m, DT)
        s_1, d_1 = ts.step(s_1, DT)
        _hold_state(s_m, (js, s_1))
        for ref in (jpacked, _np(d_1.packed)):
            np.testing.assert_array_equal(_np(d_m.packed)[[5, 6, 10, 11]],
                                          np.asarray(ref)[[5, 6, 10, 11]])
        assert d_m.poisson_iters > 0 and d_m.solver_ok
        assert len(counting.rhs) - n0 == (
            8 * mg.line_solves_per_cycle() * (d_m.poisson_iters + 1))


def test_bf16_mesh_mg_step():
    """One bfloat16 step of an MG model on (2, 2) (K2o, K1o and the Poisson
    CG on bfloat16 shards; every line solve K4's bfloat16-rhs form on the
    float32 tables) from the single-device bfloat16 state: the fields
    bfloat16 and within 2^-7 of each field's scale of the single-device
    step with the radial-only rebuild, equal CG counts."""
    from tests.test_torch_bf16 import TOL, _config
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    p = _config("shell_bench")
    p.numerics.poisson_solver = "mg"
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 16, 32
    one = BoussinesqModel(p, device="cpu")
    s0, _ = one.run(max_steps=2)
    _radial(one)
    mm = BoussinesqModel(p, device="cpu").prepare_sharded(_tmesh(2, 2))
    mg = mm._mesh.multigrid
    mg.tridiag = counting = _Counting(mg.tridiag)
    dt = float(p.time_step)
    got, d = mm.step(shard_state(s0, mm.geo, mm._mesh.mesh), dt)
    want, d1 = one.step(s0, dt)
    assert d.poisson_iters == d1.poisson_iters > 0 and d.solver_ok
    assert counting.rhs and {t.dtype for t in counting.rhs} == {
        torch.bfloat16}
    assert all(t.dtype == torch.float32 for lv in mg.shard_lines
               for ops in lv.values() for t in ops)
    g = unshard_state(got)
    for x, y in zip((g.u, g.p, g.T) + tuple(g.u_faces),
                    (want.u, want.p, want.T) + tuple(want.u_faces)):
        assert x.dtype == torch.bfloat16
        scale = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= TOL * scale


def test_level_the_mesh_does_not_divide_raises():
    """prepare_sharded on a mesh that divides the grid but not a coarser
    level of the hierarchy ((8, 1) on 8 x 8 x 16: level 1 has 4 lat rows)
    raises ValueError naming the level; so does the V-cycle alone, and a
    V-cycle that relaxes along lat."""
    _, tm = _models(**MG)
    with pytest.raises(ValueError, match="level 1"):
        tm.prepare_sharded(_tmesh(8, 1))
    with pytest.raises(ValueError, match="level 1"):
        ShardedPoissonMultigrid(_radial(tm).poisson_precond, _tmesh(8, 1))
    lat = PoissonMultigrid(tm.geo, tm.p_specs, dtype=np.float64,
                           line_axes_allowed=(1,))
    with pytest.raises(ValueError, match="radial lines alone"):
        ShardedPoissonMultigrid(lat, _tmesh(2, 2))
