"""The annulus and the 2D slab on the port's mesh (("phi",) and ("x",),
``prepare_sharded``) against the JAX package's single device and the
port's, in f64 on the CPU (the shards there take the plain versions):

  * 3 steps of the annulus of tests/test_sharding.py (8 x 48 on 8 phi
    shards) and of the slab (8 x 16 on 4 x shards) against the JAX
    single-device step at that test's bounds (u, T rtol 1e-9, p 1e-7) and
    against the port's one device, with equal iteration counts;
  * the annulus's coupled 2 x 2 solves (block FGMRES, Schur GMRES) with
    outer counts equal to one device's; the mimetic personality and the
    semi-Lagrangian transport on both meshes; one bfloat16 step;
  * the sharded fast diagonalizations against the JAX single-device
    solves; one V-cycle of the sharded multigrid (K4 once a shard a
    radial line solve, nothing copied) against the JAX
    ``PoissonMultigrid(..., line_axes_allowed=(0,))``;
  * the sharded VTK pieces byte for byte the JAX ``write_vts_sharded``'s
    on a mesh of the same shape, and a sharded checkpoint written as the
    JAX package writes it and restored bitwise.

tests/test_torch_sharded_cuboid.py does the same for the 3D box and
imports the helpers below.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.io import checkpoint as jck
from dycoreplanet_tpu.io import vtk as jvtk
from dycoreplanet_tpu.models import make_model as j_make_model
from dycoreplanet_tpu.ops.bc import BC as JBC, BCSpec as JSpec
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, cell_pspec, shard_state as j_shard_state)
from dycoreplanet_tpu.solvers import spectral as j_spectral
from dycoreplanet_tpu.solvers.multigrid import PoissonMultigrid as JMG
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.io import checkpoint as tck
from dycoreplanet_tpu_torch.io import vtk as tvtk
from dycoreplanet_tpu_torch.models import make_model
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.solvers import spectral as t_spectral
from dycoreplanet_tpu_torch.solvers.multigrid import (
    PoissonMultigrid, ShardedPoissonMultigrid)
from tests.test_torch_multigrid import _p_specs

DT = 0.01
N_STEPS = 3
# tests/test_sharding.py's bounds
U_TOL = dict(rtol=1e-9, atol=1e-11)
P_TOL = dict(rtol=1e-7, atol=1e-9)
# the shards of each case's mesh (build_mesh of that many devices)
SHARDS = {"annulus": 8, "slab": 4, "cube": 8, "box": 8, "periodic": 8}


def params(cls, kind, **numerics):
    """tests/test_sharding.py's ``_model`` parameters (f64) of ``kind``:
    "annulus" (8 x 48), "cube" (the FEEC 8^3 box), "box" (the same box in
    the standard personality), "slab" (8 x 16, tests/test_model.py's
    TestCuboid2D physics); ``numerics`` set on top (a key
    "use_schur_complement_solver" or "feec_formulation" on the
    parameters or numerics it belongs to)."""
    p = cls.from_text("")
    p.numerics.dtype = "float64"
    if kind in ("cube", "box", "slab"):
        p.space_dimension = 2 if kind == "slab" else 3
        p.cuboid_geometry = True
        p.use_FEEC_solver = kind == "cube"
        p.numerics.nx = 16 if kind == "slab" else 8
        p.numerics.ny = p.numerics.nz = 8
        p.physical_constants.expansion_coefficient = 0.2
        p.reference_quantities.temperature_ref = 3.0
    else:
        p.space_dimension = 2
        p.numerics.n_radial, p.numerics.n_lon = 8, 48
        p.physical_constants.R0 = 1.0
        p.physical_constants.atm_height = 2.0
        p.reference_quantities.temperature_ref = 2.0
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.physical_constants.__post_init__()
    p.reference_quantities.__post_init__()
    p.time_step = DT
    for k, v in numerics.items():
        setattr(p if hasattr(p, k) else p.numerics, k, v)
    return p


def geometry(factory, kind):
    """The fully periodic box ("periodic") is made by its factory call;
    every other case by the parameters."""
    if kind == "periodic":
        return factory.make_cuboid(8, 8, 8, periodic_z=True)
    return None


def port_model(kind, **numerics):
    return make_model(params(Parameters, "box" if kind == "periodic"
                             else kind, **numerics),
                      geometry=geometry(t_factory, kind), device="cpu")


def jax_model(kind, **numerics):
    return j_make_model(params(JParameters, "box" if kind == "periodic"
                               else kind, **numerics),
                        geometry=geometry(j_factory, kind))


def on_mesh(model, kind, n=None):
    """``model`` prepared for build_mesh's mesh of its case's shards."""
    return model.prepare_sharded(build_mesh(
        model.geo, ["cpu"] * (n or SHARDS[kind])))


def _np(x):
    return x.detach().cpu().double().numpy()


def hold(got, want, faces=True, u_tol=U_TOL, p_tol=P_TOL):
    """A sharded state against a global one (a JAX or a port State)."""
    g = unshard_state(got)
    for name, tol in (("u", u_tol), ("T", u_tol), ("p", p_tol)):
        np.testing.assert_allclose(_np(getattr(g, name)),
                                   np.asarray(getattr(want, name), float),
                                   err_msg=name, **tol)
    if faces:
        for d, (a, b) in enumerate(zip(g.u_faces, want.u_faces)):
            np.testing.assert_allclose(_np(a), np.asarray(b, float),
                                       err_msg=f"faces {d}", **u_tol)


def counts(d):
    """A step's iteration counts."""
    return (d.poisson_iters, d.temperature_iters,
            tuple(int(i) for i in d.helmholtz_iters))


def run_pair(kind, n_steps=N_STEPS, state=None, **numerics):
    """``n_steps`` steps of the port's one device and of its mesh from the
    same state (default: the initial one): (one-device states and
    diagnostics, mesh states and diagnostics, the mesh model)."""
    one = port_model(kind, **numerics)
    mesh_m = on_mesh(port_model(kind, **numerics), kind)
    s1 = one.initial_state() if state is None else state(one)
    sm = shard_state(s1, mesh_m.geo, mesh_m._mesh.mesh)
    ones, meshes = [], []
    for _ in range(n_steps):
        s1, d1 = one.step(s1, DT)
        sm, dm = mesh_m.step(sm, DT)
        ones.append((s1, d1))
        meshes.append((sm, dm))
    return ones, meshes, mesh_m


_JAX_RUNS = {}


def jax_run(kind, n_steps=N_STEPS, state=None, **numerics):
    """The JAX single-device states after each of ``n_steps`` steps (made
    once a case)."""
    key = (kind, n_steps, state, tuple(sorted(numerics.items())))
    if key not in _JAX_RUNS:
        jm = jax_model(kind, **numerics)
        s = jm.initial_state() if state is None else state(jm)
        out = []
        for _ in range(n_steps):
            s, d = jm.step(s, DT)
            out.append((s, d))
        _JAX_RUNS[key] = out
    return _JAX_RUNS[key]


def check_against_jax_and_one_device(kind, **numerics):
    """The mesh's steps against the JAX single device at every step and
    the port's one device, equal iteration counts."""
    ones, meshes, m = run_pair(kind, **numerics)
    jaxes = jax_run(kind, **numerics)
    for (s1, d1), (sm, dm), (sj, dj) in zip(ones, meshes, jaxes):
        hold(sm, sj)
        hold(sm, s1)
        assert counts(dm) == counts(d1) == counts(dj)
        assert dm.div_norm < 1e-6
    return m


# ------------------------------------------------------------- the steps
@pytest.mark.parametrize("kind", ["annulus", "slab"])
def test_mesh_steps_match_jax_single_device(kind):
    m = check_against_jax_and_one_device(kind)
    assert m._mesh.mesh.axis_names == {"annulus": ("phi",),
                                       "slab": ("x",)}[kind]
    assert m.sharded_kernels()["poisson"] == {
        "annulus": "ShardedAnnulusPoissonFastDiag",
        "slab": "ShardedCuboid2DPoissonFastDiag"}[kind]


@pytest.mark.parametrize("kw", [
    dict(momentum_solver="coupled", use_schur_complement_solver=False),
    dict(momentum_solver="coupled", use_schur_complement_solver=True),
    dict(use_FEEC_solver=True)], ids=["fgmres", "schur", "feec"])
def test_annulus_coupled_mesh_matches_one_device(kw):
    """The annulus's 2 x 2 block FGMRES, its Schur GMRES and the FEEC
    personality (the 2 x 2 solve beside the rotational forcing, its 2D
    curl on the shards) on 8 phi shards: each outer count equal to one
    device's, the states within the sharding bounds."""
    ones, meshes, _ = run_pair("annulus", n_steps=2, **kw)
    for (s1, d1), (sm, dm) in zip(ones, meshes):
        hold(sm, s1)
        assert dm.poisson_iters == d1.poisson_iters > 0
        assert dm.solver_ok == d1.solver_ok


@pytest.mark.parametrize("kind", ["annulus", "slab"])
def test_mimetic_and_sl_meshes_match_one_device(kind):
    """The mimetic personality (annulus only: the slab has no curl, in
    both packages) and the semi-Lagrangian transport on the mesh against
    one device; the sharded SL transport bitwise the single-device one."""
    sl = dict(temperature_advection="semi-lagrangian")
    ones, meshes, m = run_pair(kind, n_steps=2, **sl)
    for (s1, d1), (sm, dm) in zip(ones, meshes):
        hold(sm, s1)
        assert counts(dm) == counts(d1)
    one = port_model(kind, **sl)
    s = ones[0][0]
    want = one._semi_lagrangian(s.u, s.T, DT)
    ss = shard_state(s, m.geo, m._mesh.mesh)
    got = unshard_field(m._mesh.transport(ss.u, ss.u_faces, ss.T, DT))
    assert torch.equal(got, want)
    if kind == "annulus":
        ones, meshes, m = run_pair(kind, n_steps=2, use_FEEC_solver=True,
                                   feec_formulation="staggered")
        assert type(m).__name__ == "MimeticBoussinesqModel"
        for (s1, d1), (sm, dm) in zip(ones, meshes):
            hold(sm, s1)
            assert counts(dm) == counts(d1)
            assert dm.div_norm <= 1e-9


def test_annulus_run_and_bf16_on_the_mesh():
    """``run`` on the mesh as on one device (its gate, the histories'
    counts), and one bfloat16 step of the mesh within a bfloat16 ulp
    (2^-7 of the field's scale) of one device's."""
    one = port_model("annulus")
    m = on_mesh(port_model("annulus"), "annulus")
    s1, h1 = one.run(max_steps=2)
    sm, hm = m.run(max_steps=2)
    hold(sm, s1)
    assert [h["poisson_iters"] for h in hm] == \
        [h["poisson_iters"] for h in h1]
    assert m.escalations == one.escalations
    ones, meshes, _ = run_pair("annulus", n_steps=1, dtype="bfloat16")
    g = unshard_state(meshes[0][0])
    for name in ("u", "p", "T"):
        a, b = getattr(g, name), getattr(ones[0][0], name)
        assert a.dtype == torch.bfloat16
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 2.0 ** -7 * scale


# ------------------------------------------------------------- the solves
def fast_diag_pair(kind):
    """(JAX single-device fast solve, port sharded one, its mesh)."""
    jgeo = jax_model(kind).geo
    tm = port_model(kind)
    mesh = build_mesh(tm.geo, ["cpu"] * SHARDS[kind])
    return (j_spectral.make_poisson_solver(jgeo, dtype=np.float64),
            t_spectral.make_sharded_poisson_solver(tm.poisson_spectral,
                                                   mesh), mesh)


def check_fast_diag(kind, seed=4):
    """The sharded fast diagonalization against the JAX single-device
    solve of the same mean-free rhs: within 1e-12 of the solution's
    scale."""
    jsolve, tsolve, mesh = fast_diag_pair(kind)
    b = np.random.default_rng(seed).standard_normal(tsolve.geo.cell_shape)
    b -= b.mean()
    want = np.asarray(jsolve(jnp.asarray(b)))
    got, iters = tsolve.solve(shard_field(torch.as_tensor(b), mesh))
    assert iters == 0
    got = _np(unshard_field(got))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["annulus", "slab"])
def test_sharded_fast_diag_matches_jax(kind):
    check_fast_diag(kind)


def test_sharded_vcycle_matches_jax_radial():
    """One V-cycle of the annulus's mesh (8 phi shards, 2 levels: 8 x 48
    and 4 x 24) against the JAX radial-only V-cycle on the same residual,
    within 1e-12 of its scale: K4 once a shard a radial line solve, on
    the shard's own (nr, no) columns, nothing copied."""
    tgeo = t_factory.make_annulus(8, 48, 1.0, 3.0)
    jgeo = j_factory.make_annulus(8, 48, 1.0, 3.0)
    tm = PoissonMultigrid(tgeo, _p_specs(tgeo, BCSpec, BC), dtype=np.float64,
                          line_axes_allowed=(0,))
    jm = JMG(jgeo, _p_specs(jgeo, JSpec, JBC), dtype=np.float64,
             line_axes_allowed=(0,))
    assert tm.line_axes == [0] == list(jm.line_axes) and len(tm.geos) == 2
    r = np.random.default_rng(7).standard_normal(tgeo.cell_shape)
    want = np.asarray(jax.jit(jm.__call__)(jnp.asarray(r)))
    mesh = build_mesh(tgeo, ["cpu"] * 8)
    sm = ShardedPoissonMultigrid(tm, mesh)
    calls = []
    base = sm.tridiag
    sm.tridiag = lambda *ops: calls.append(ops) or base(*ops)
    got = _np(unshard_field(sm(shard_field(torch.as_tensor(r), mesh))))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert len(calls) == 8 * sm.line_solves_per_cycle() == 8 * (2 * 2 + 40)
    assert all(k4.layout(*ops).copied == () for ops in calls)
    for level, op in enumerate(sm.ops):
        for ab in op.offsets:
            x = torch.zeros(op.local, dtype=torch.float64)
            assert sm.shard_operands(level, ab, x)[3] is x


def test_mg_annulus_mesh_step_matches_one_device():
    """`poisson solver = mg` on the annulus's mesh against one device with
    the same radial-only rebuild: equal CG counts, the sharding bounds."""
    one = port_model("annulus", poisson_solver="mg")
    m = on_mesh(port_model("annulus", poisson_solver="mg"), "annulus")
    assert m.poisson_precond.line_axes == [0]
    one.poisson_precond = m.poisson_precond.__class__(
        one.geo, one.p_specs, dtype=one.torch_dtype, device="cpu",
        tridiag=one._tridiag, line_axes_allowed=(0,))
    s1 = one.initial_state()
    sm = shard_state(s1, m.geo, m._mesh.mesh)
    for _ in range(2):
        s1, d1 = one.step(s1, DT)
        sm, dm = m.step(sm, DT)
        hold(sm, s1, u_tol=dict(rtol=1e-8, atol=1e-10))
        assert dm.poisson_iters == d1.poisson_iters > 0


# ---------------------------------------------------------- output, state
def check_vtk_pieces(kind, tmp_path):
    """The .pvts master and every piece of the case's mesh, from each
    package's sharded fields (JAX: its 8 virtual devices)."""
    jgeo, tgeo = jax_model(kind).geo, port_model(kind).geo
    n = SHARDS[kind]
    rng = np.random.RandomState(3)
    T, p = rng.rand(*jgeo.cell_shape), rng.randn(*jgeo.cell_shape)
    u = rng.randn(jgeo.dim, *jgeo.cell_shape)
    jmesh = j_build_mesh(jgeo, jax.devices()[:n])
    cell = NamedSharding(jmesh, cell_pspec(jgeo, jmesh))
    vec = NamedSharding(jmesh, P(None, *cell_pspec(jgeo, jmesh)))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jvtk.write_vts_sharded(
        str(jdir / "out.vts"), jgeo,
        scalars={"temperature": jax.device_put(T, cell),
                 "pressure": jax.device_put(p, cell)},
        vectors={"velocity": jax.device_put(u, vec)})
    mesh = build_mesh(tgeo, ["cpu"] * n)
    sf = lambda x: shard_field(torch.as_tensor(x), mesh)  # noqa: E731
    tvtk.write_vts_sharded(
        str(tdir / "out.vts"), tgeo,
        scalars={"temperature": sf(T), "pressure": sf(p)},
        vectors={"velocity": sf(u)})
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == n + 1
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), \
            name


def check_checkpoint(kind, tmp_path):
    """A sharded checkpoint of a stepped state: the port's files as the
    JAX package writes them (the .json equal, every shard's arrays
    bitwise), and restored onto the mesh bitwise."""
    ones, meshes, m = run_pair(kind, n_steps=1)
    sm = meshes[0][0]
    mesh = m._mesh.mesh
    tck.save_checkpoint_sharded(str(tmp_path / "port" / "ck"), sm,
                                {"note": kind})
    back, meta = tck.load_checkpoint_sharded(str(tmp_path / "port" / "ck"),
                                             geo=m.geo, mesh=mesh)
    assert meta["n_shards"] == SHARDS[kind]
    for name in ("u", "p", "T"):
        for ab, t in getattr(sm, name).items():
            assert torch.equal(getattr(back, name)[ab], t), name
    for a, b in zip(back.u_faces, sm.u_faces):
        for ab, t in b.items():
            assert torch.equal(a[ab], t)
    assert back.time == sm.time and back.step_number == sm.step_number
    jm = jax_model(kind)
    g = unshard_state(sm)
    js = jm.initial_state()._replace(
        u=jnp.asarray(_np(g.u)), u_faces=tuple(jnp.asarray(_np(f))
                                               for f in g.u_faces),
        p=jnp.asarray(_np(g.p)), T=jnp.asarray(_np(g.T)),
        time=jnp.asarray(sm.time, jnp.float64),
        step_number=jnp.asarray(sm.step_number, jnp.int32))
    jmesh = j_build_mesh(jm.geo, jax.devices()[:SHARDS[kind]])
    jck.save_checkpoint_sharded(str(tmp_path / "jax" / "ck"),
                                j_shard_state(js, jm.geo, jmesh),
                                {"note": kind})
    assert (tmp_path / "jax" / "ck.json").read_bytes() == \
        (tmp_path / "port" / "ck.json").read_bytes()
    for k in range(SHARDS[kind]):
        with np.load(tmp_path / "jax" / f"ck.shard{k:03d}.npz") as ja, \
                np.load(tmp_path / "port" / f"ck.shard{k:03d}.npz") as tb:
            assert sorted(ja.files) == sorted(tb.files)
            for name in ja.files:
                assert ja[name].tobytes() == tb[name].tobytes(), (k, name)


@pytest.mark.parametrize("kind", ["annulus", "slab"])
def test_sharded_vtk_pieces_equal_jax(kind, tmp_path):
    check_vtk_pieces(kind, tmp_path)


@pytest.mark.parametrize("kind", ["annulus", "slab"])
def test_sharded_checkpoint_round_trip(kind, tmp_path):
    check_checkpoint(kind, tmp_path)
