"""The 3D box on the port's ("y", "x") mesh (``prepare_sharded``, 2 x 4
shards) against the JAX package's single device and the port's, in f64
on the CPU (the shards there take the plain versions):

  * 3 steps of tests/test_sharding.py's cube (the FEEC personality: the
    coupled 3 x 3 solve) and of the same box in the standard personality
    against the JAX single-device step at that test's bounds (u, T rtol
    1e-9, p 1e-7) and the port's one device, equal iteration (outer)
    counts; the escalated step (``step_strong``: every solve CG) and the
    fully periodic box against one device;
  * the mimetic box from tests/test_sharding.py's face field against the
    JAX single device; SL and one bfloat16 step against one device;
  * the sharded fast diagonalization (walled and fully periodic) against
    the JAX single-device solve; one V-cycle of the walled box's sharded
    multigrid (its smoother weighted Jacobi, as "auto" picks on the
    cuboid in both packages: no line solve, so no K4) against the JAX
    ``PoissonMultigrid(..., line_axes_allowed=(0,))``;
  * the sharded VTK pieces byte for byte the JAX ``write_vts_sharded``'s,
    and a sharded checkpoint as the JAX package writes it, restored
    bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.ops.bc import BC as JBC, BCSpec as JSpec
from dycoreplanet_tpu.solvers.multigrid import PoissonMultigrid as JMG
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.solvers.multigrid import (
    PoissonMultigrid, ShardedPoissonMultigrid)
from tests.test_torch_multigrid import _p_specs
from tests.test_torch_sharded_annulus import (
    DT, _np, check_against_jax_and_one_device, check_checkpoint,
    check_fast_diag, check_vtk_pieces, counts, hold, jax_model, jax_run,
    on_mesh, port_model, run_pair)


def test_cube_feec_mesh_matches_jax_single_device():
    """The cube's coupled 3 x 3 FGMRES on 2 x 4: every outer count equal
    to the JAX single device's and the port's one device's."""
    m = check_against_jax_and_one_device("cube")
    assert m._mesh.mesh.axis_names == ("y", "x")
    assert m._mesh.mesh.grid == (2, 4)
    assert m.momentum_solver == "coupled"
    assert m.sharded_kernels() == {
        "forcing": "jnp", "richardson": "jnp",
        "poisson": "ShardedCuboidPoissonFastDiag"}


def test_box_standard_mesh_matches_jax_single_device():
    check_against_jax_and_one_device("box")


def test_escalated_and_periodic_box_match_one_device():
    """``step_strong`` (every solve CG: the escalated step) on the walled
    box's mesh against one device's, equal CG counts; 2 steps of the
    fully periodic box (no wall anywhere) against one device."""
    one = port_model("box")
    m = on_mesh(port_model("box"), "box")
    s1 = one.initial_state()
    sm = shard_state(s1, m.geo, m._mesh.mesh)
    for _ in range(2):
        s1, d1 = one.step_strong(s1, DT)
        sm, dm = m.step_strong(sm, DT)
        hold(sm, s1)
        assert counts(dm) == counts(d1)
        assert d1.poisson_iters > 0
    ones, meshes, _ = run_pair("periodic", n_steps=2)
    for (s1, d1), (sm, dm) in zip(ones, meshes):
        hold(sm, s1)
        assert counts(dm) == counts(d1)


def _face_field(model):
    """tests/test_sharding.py's mimetic face field."""
    def fn(d, mesh_c):
        z, y, x = mesh_c
        if d == 0:
            return 0.1 * np.sin(2 * np.pi * x) * np.sin(np.pi * z)
        return 0.1 * np.cos(2 * np.pi * x)

    return model.state_from_faces(model.faces_from_velocity(fn))


def test_mimetic_box_mesh_matches_jax_single_device():
    """tests/test_sharding.py's mimetic single-vs-eight-devices case on the
    port's 2 x 4 mesh against the JAX single device, every step, and the
    port's one device."""
    kw = dict(feec_formulation="staggered")
    ones, meshes, m = run_pair("cube", state=_face_field, **kw)
    assert type(m).__name__ == "MimeticBoussinesqModel"
    jaxes = jax_run("cube", state=_face_field, **kw)
    for (s1, d1), (sm, dm), (sj, _) in zip(ones, meshes, jaxes):
        hold(sm, sj)
        hold(sm, s1)
        assert counts(dm) == counts(d1)
        assert dm.div_norm <= 1e-9


def test_sl_and_bf16_box_meshes_match_one_device():
    """The semi-Lagrangian transport on the box's mesh, 2 steps against
    one device; one bfloat16 step within a bfloat16 ulp (2^-7 of each
    field's scale) of one device's."""
    ones, meshes, _ = run_pair("box", n_steps=2,
                               temperature_advection="semi-lagrangian")
    for (s1, d1), (sm, dm) in zip(ones, meshes):
        hold(sm, s1)
        assert counts(dm) == counts(d1)
    ones, meshes, _ = run_pair("box", n_steps=1, dtype="bfloat16")
    g = unshard_state(meshes[0][0])
    for name in ("u", "p", "T"):
        a, b = getattr(g, name), getattr(ones[0][0], name)
        assert a.dtype == torch.bfloat16
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2.0 ** -7 * scale


@pytest.mark.parametrize("kind", ["box", "periodic"])
def test_sharded_fast_diag_matches_jax(kind):
    check_fast_diag(kind)


def test_sharded_vcycle_matches_jax_and_mg_step():
    """One V-cycle of the walled box's mesh (2 x 4, levels 8^3 and 4^3)
    against the JAX V-cycle rebuilt as its mesh rebuilds it, within 1e-12
    of its scale: the smoother Jacobi on both sides, so no line solve;
    then 2 `poisson solver = mg` steps of the mesh against one device
    with the same rebuild, equal CG counts."""
    tgeo = t_factory.make_cuboid(8, 8, 8)
    jgeo = j_factory.make_cuboid(8, 8, 8)
    tm = PoissonMultigrid(tgeo, _p_specs(tgeo, BCSpec, BC), dtype=np.float64,
                          line_axes_allowed=(0,))
    jm = JMG(jgeo, _p_specs(jgeo, JSpec, JBC), dtype=np.float64,
             line_axes_allowed=(0,))
    assert tm.smoother == jm.smoother == "jacobi" and len(tm.geos) == 2
    assert tm.line_solves_per_cycle() == 0
    r = np.random.default_rng(9).standard_normal(tgeo.cell_shape)
    # op by op: its compile takes ~19 s of CPU at 8^3, the cycle ~3
    want = np.asarray(jm(jnp.asarray(r)))
    mesh = build_mesh(tgeo, ["cpu"] * 8)
    got = _np(unshard_field(ShardedPoissonMultigrid(tm, mesh)(
        shard_field(torch.as_tensor(r), mesh))))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

    one = port_model("box", poisson_solver="mg")
    m = on_mesh(port_model("box", poisson_solver="mg"), "box")
    one.poisson_precond = PoissonMultigrid(
        one.geo, one.p_specs, dtype=one.torch_dtype, device="cpu",
        tridiag=one._tridiag, line_axes_allowed=(0,))
    s1 = one.initial_state()
    sm = shard_state(s1, m.geo, m._mesh.mesh)
    for _ in range(2):
        s1, d1 = one.step(s1, DT)
        sm, dm = m.step(sm, DT)
        hold(sm, s1, u_tol=dict(rtol=1e-8, atol=1e-10))
        assert dm.poisson_iters == d1.poisson_iters > 0
    assert m._mesh.multigrid.smoother == "jacobi"
    assert m._mesh.multigrid.line_solves_per_cycle() == 0


def test_sharded_vtk_pieces_equal_jax(tmp_path):
    check_vtk_pieces("box", tmp_path)


def test_sharded_checkpoint_round_trip(tmp_path):
    check_checkpoint("box", tmp_path)


def test_wrong_mesh_axes_raise():
    """A box given the shell's axis names, and the annulus a two-axis
    mesh, raise ValueError naming the layout."""
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh

    m = port_model("box")
    with pytest.raises(ValueError, match=r"\('y', 'x'\)"):
        m.prepare_sharded(Mesh(np.array([["cpu"] * 2] * 2, dtype=object),
                               ("lat", "lon")))
    a = port_model("annulus")
    with pytest.raises(ValueError, match=r"\('phi',\)"):
        a.prepare_sharded(Mesh(np.array([["cpu"] * 2] * 2, dtype=object),
                               ("y", "x")))
    assert jax_model("box").geo.cell_shape == m.geo.cell_shape
