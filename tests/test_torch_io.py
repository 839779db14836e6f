"""The port's VTK writers, checkpoints and solver residual trails against
the JAX package's (dycoreplanet_tpu/io/, solvers/cg.py,
solvers/fixed.py), on the CPU at small sizes (shell 4x8x16, annulus
16x192).

The writers get the same numpy arrays, made from a seed, as the JAX
writers, and their files must be equal byte for byte. Checkpoints
written by either package load in the other bitwise, single-device and
sharded (a 2 x 4 mesh: the JAX side on the conftest's 8 virtual CPU
devices, the port's 8 shards on the CPU). The trails of ``record_history``
match the JAX trails within 1e-12 relative in f64, NaN in the same
places.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycoreplanet_tpu.grid import make_annulus as j_make_annulus
from dycoreplanet_tpu.grid import make_shell as j_make_shell
from dycoreplanet_tpu.io import checkpoint as jck
from dycoreplanet_tpu.io import vtk as jvtk
from dycoreplanet_tpu.models.boussinesq import State as JState
from dycoreplanet_tpu_torch.grid import make_annulus, make_shell
from dycoreplanet_tpu_torch.io import checkpoint as tck
from dycoreplanet_tpu_torch.io import vtk as tvtk
from dycoreplanet_tpu_torch.models.boussinesq import State
from dycoreplanet_tpu_torch.parallel.mesh import Mesh, shard_state

GEOS = {
    "shell": (lambda: j_make_shell(4, 8, 16, 1.0, 3.0),
              lambda: make_shell(4, 8, 16, 1.0, 3.0)),
    "annulus": (lambda: j_make_annulus(16, 192, 1.0, 3.0),
                lambda: make_annulus(16, 192, 1.0, 3.0)),
}
PIECES = {"shell": (slice(None), slice(2, 6), slice(4, 12)),
          "annulus": (slice(None), slice(48, 96))}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _fields(shape, dim, seed):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape), rng.randn(*shape), rng.randn(dim, *shape)


# -------------------------------------------------------------- writers
@pytest.mark.parametrize("piece", [False, True], ids=["whole", "piece"])
@pytest.mark.parametrize("kind", ["shell", "annulus"])
def test_write_vts_bytes_equal_jax(tmp_path, kind, piece):
    jgeo, tgeo = GEOS[kind][0](), GEOS[kind][1]()
    sl = PIECES[kind] if piece else None
    shape = (jgeo.cell_shape if sl is None else
             tuple(len(range(*s.indices(n)))
                   for s, n in zip(sl, jgeo.cell_shape)))
    T, p, u = _fields(shape, jgeo.dim, 11)
    kw = dict(scalars={"temperature": T, "pressure": p},
              vectors={"velocity": u}, sl=sl)
    a = jvtk.write_vts(str(tmp_path / "jax.vts"), jgeo, **kw)
    b = tvtk.write_vts(str(tmp_path / "port.vts"), tgeo, **kw)
    assert _bytes(a) == _bytes(b)


def test_write_pvd_bytes_equal_jax(tmp_path):
    entries = [{"time": 0.0, "file": "b_000000.vts"},
               {"time": 0.1, "file": "b_000001.vts"},
               {"time": 1.6282000000000003, "file": "b_000002.vts"}]
    a = jvtk.write_pvd(str(tmp_path / "jax.pvd"), entries)
    b = tvtk.write_pvd(str(tmp_path / "port.pvd"), entries)
    assert _bytes(a) == _bytes(b)


@pytest.mark.parametrize("kind,shards", [
    ("shell", None), ("shell", (1, 2, 4)), ("annulus", None),
    ("annulus", (1, 8))])
def test_write_mesh_vts_bytes_equal_jax(tmp_path, kind, shards):
    jgeo, tgeo = GEOS[kind][0](), GEOS[kind][1]()
    a = jvtk.write_mesh_vts(str(tmp_path / "jax.vts"), jgeo, shards)
    b = tvtk.write_mesh_vts(str(tmp_path / "port.vts"), tgeo, shards)
    assert _bytes(a) == _bytes(b)


def _port_mesh():
    return Mesh(np.array([["cpu"] * 4] * 2, dtype=object), ("lat", "lon"))


def _jax_mesh(geo):
    from dycoreplanet_tpu.parallel import build_mesh

    mesh = build_mesh(geo)
    assert dict(mesh.shape) == {"lat": 2, "lon": 4}
    return mesh


def test_write_vts_sharded_bytes_equal_jax(tmp_path):
    """The .pvts master and all 8 pieces of a 2 x 4 mesh, from each
    package's sharded fields."""
    import jax

    from dycoreplanet_tpu.parallel.mesh import NamedSharding, cell_pspec

    jgeo, tgeo = GEOS["shell"][0](), GEOS["shell"][1]()
    T, p, u = _fields(jgeo.cell_shape, 3, 12)
    jmesh = _jax_mesh(jgeo)
    cell = NamedSharding(jmesh, cell_pspec(jgeo, jmesh))
    vec = NamedSharding(jmesh, jax.sharding.PartitionSpec(
        None, *cell_pspec(jgeo, jmesh)))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    a = jvtk.write_vts_sharded(
        str(jdir / "out.vts"), jgeo,
        scalars={"temperature": jax.device_put(T, cell),
                 "pressure": jax.device_put(p, cell)},
        vectors={"velocity": jax.device_put(u, vec)})
    from dycoreplanet_tpu_torch.parallel.mesh import shard_field

    mesh = _port_mesh()
    sf = lambda x: shard_field(torch.as_tensor(x), mesh)
    b = tvtk.write_vts_sharded(
        str(tdir / "out.vts"), tgeo,
        scalars={"temperature": sf(T), "pressure": sf(p)},
        vectors={"velocity": sf(u)})
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert len(names) == 9
    assert os.path.basename(a) == os.path.basename(b) == "out.pvts"
    for name in names:
        assert _bytes(jdir / name) == _bytes(tdir / name), name


# ---------------------------------------------------------- checkpoints
def _np_state(dtype, seed=2, shape=(4, 8, 16)):
    rng = np.random.RandomState(seed)
    return dict(u=rng.randn(3, *shape).astype(dtype),
                u_faces=tuple(rng.randn(*shape).astype(dtype)
                              for _ in range(3)),
                p=rng.randn(*shape).astype(dtype),
                T=rng.rand(*shape).astype(dtype),
                time=dtype(1.25) + dtype(1e-3), step_number=7)


def _jax_state(s, dtype):
    return JState(u=jnp.asarray(s["u"]),
                  u_faces=tuple(jnp.asarray(f) for f in s["u_faces"]),
                  p=jnp.asarray(s["p"]), T=jnp.asarray(s["T"]),
                  time=jnp.asarray(s["time"], dtype),
                  step_number=jnp.asarray(s["step_number"], jnp.int32))


def _port_state(s):
    t = torch.as_tensor
    return State(u=t(s["u"]), u_faces=tuple(t(f) for f in s["u_faces"]),
                 p=t(s["p"]), T=t(s["T"]), time=float(s["time"]),
                 step_number=int(s["step_number"]))


def _leaves(state):
    """(name, numpy) of every leaf, time and step_number as 0-d arrays at
    their stored dtype."""
    h = (lambda x: x.detach().cpu().numpy()) if torch.is_tensor(state.u) \
        else np.asarray
    out = [("u", h(state.u)), ("p", h(state.p)), ("T", h(state.T))]
    out += [(f"u_face_{d}", h(f)) for d, f in enumerate(state.u_faces)]
    return out


DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_checkpoint_files_equal_jax(tmp_path, dtype):
    """The same state saved by both packages: the same keys, dtypes and
    shapes, bitwise equal arrays, and equal .json files."""
    s = _np_state(dtype)
    meta = {"time_index": 0.30000000000000004, "dt": 0.1}
    a = jck.save_checkpoint(str(tmp_path / "jax"), _jax_state(s, dtype), meta)
    b = tck.save_checkpoint(str(tmp_path / "port"), _port_state(s), meta)
    assert a.endswith(".npz") and b.endswith(".npz")
    with np.load(a) as ja, np.load(b) as tb:
        assert sorted(ja.files) == sorted(tb.files)
        assert len(ja.files) == 8
        for k in ja.files:
            assert ja[k].dtype == tb[k].dtype, k
            assert ja[k].shape == tb[k].shape, k
            assert ja[k].tobytes() == tb[k].tobytes(), k
        assert tb["time"].dtype == dtype and tb["time"].shape == ()
        assert tb["step_number"].dtype == np.int32
    assert _bytes(a + ".json") == _bytes(b + ".json")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_checkpoint_cross_loads_bitwise(tmp_path, dtype):
    """The port loads a JAX-written checkpoint, and the JAX package a
    port-written one, bitwise; a port round trip likewise."""
    from dycoreplanet_tpu_torch.models.convert import state_to_numpy

    s = _np_state(dtype)
    js, ts = _jax_state(s, dtype), _port_state(s)
    a = jck.save_checkpoint(str(tmp_path / "jax"), js, {"dt": 0.25})
    b = tck.save_checkpoint(str(tmp_path / "port"), ts, {"dt": 0.25})

    got, meta = tck.load_checkpoint(a, "cpu")
    assert meta == {"dt": 0.25, "n_face_arrays": 3}
    u, faces, p, T, time, step = state_to_numpy(got)
    for (name, want), have in zip(_leaves(js), (u, p, T) + faces):
        assert have.dtype == want.dtype and have.tobytes() == \
            want.tobytes(), name
    assert isinstance(got.time, float) and isinstance(got.step_number, int)
    assert dtype(time) == np.asarray(js.time) and step == 7

    jgot, meta = jck.load_checkpoint(b)
    assert meta["n_face_arrays"] == 3
    for (name, want), (_, have) in zip(_leaves(ts), _leaves(jgot)):
        assert have.dtype == want.dtype and have.tobytes() == \
            want.tobytes(), name
    assert np.asarray(jgot.time).dtype == dtype
    assert np.asarray(jgot.time) == np.asarray(js.time)
    assert int(jgot.step_number) == 7

    back, _ = tck.load_checkpoint(b[:-4], "cpu")     # path without .npz
    for (name, want), (_, have) in zip(_leaves(ts), _leaves(back)):
        assert have.tobytes() == want.tobytes(), name
    assert back.time == ts.time and back.step_number == 7


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_mimetic_checkpoint_cross_loads_bitwise(tmp_path, dtype):
    """A mimetic state, whose u_faces are the prognostic field: two port
    steps of the FEEC prm's staggered realization from a seeded flow,
    saved by the port, load in the JAX package bitwise, and a JAX-written
    one in the port; the next step from the loaded state agrees across
    the packages (within 1e-12 of max|u| in f64, 1e-5 in f32)."""
    from dycoreplanet_tpu.base.params import Parameters as JParameters
    from dycoreplanet_tpu.models import make_model as j_make_model
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import make_model
    from dycoreplanet_tpu_torch.models.convert import state_from_numpy

    prm = os.path.join(os.path.dirname(__file__), "..", "data",
                       "aqua_planet_shell_test_3d-feec.prm")
    models = []
    for P, make, kw in ((Parameters, make_model, {"device": "cpu"}),
                        (JParameters, j_make_model, {})):
        p = P.from_file(prm)
        p.numerics.feec_formulation = "staggered"
        p.numerics.dtype = np.dtype(dtype).name
        p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 8, 16
        models.append(make(p, **kw))
    tm, jm = models
    dt = 0.01
    rng = np.random.default_rng(4)
    u = (0.05 * rng.standard_normal((3,) + tm.geo.cell_shape)).astype(dtype)
    faces = [f.numpy() for f in tm.interp_to_faces(torch.as_tensor(u))]
    ts = state_from_numpy(tm, u, faces, np.zeros_like(u[0]), tm.T_init)
    for _ in range(2):
        ts, _ = tm.step(ts, dt)
    b = tck.save_checkpoint(str(tmp_path / "port"), ts, {"dt": dt})
    js, _ = jck.load_checkpoint(b)
    for (name, want), (_, have) in zip(_leaves(ts), _leaves(js)):
        assert have.dtype == want.dtype and have.tobytes() == \
            want.tobytes(), name
    js2, _ = jm.step(js, dt)
    a = jck.save_checkpoint(str(tmp_path / "jax"), js2, {"dt": dt})
    back, _ = tck.load_checkpoint(a, "cpu")
    for (name, want), (_, have) in zip(_leaves(js2), _leaves(back)):
        assert have.tobytes() == want.tobytes(), name
    ts2, _ = tm.step(ts, dt)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    scale = float(np.abs(np.asarray(js2.u)).max())
    for (name, want), (_, have) in zip(_leaves(js2), _leaves(ts2)):
        assert np.abs(have - want).max() <= tol * max(
            scale, float(np.abs(want).max())), name


def test_sharded_checkpoint_cross_reads_jax(tmp_path):
    """2 x 4 mesh, f64: the port's sharded files match the JAX package's
    (the .json equal, every shard's arrays bitwise); each package reads
    the other's, into one device or back onto its mesh, bitwise."""
    from dycoreplanet_tpu.parallel import shard_state as j_shard_state
    from dycoreplanet_tpu.parallel import state_sharding

    tgeo, jgeo = GEOS["shell"][1](), GEOS["shell"][0]()
    s = _np_state(np.float64, seed=5)
    js, ts = _jax_state(s, np.float64), _port_state(s)
    jmesh, mesh = _jax_mesh(jgeo), _port_mesh()
    jsh = j_shard_state(js, jgeo, jmesh)
    tsh = shard_state(ts, tgeo, mesh)
    meta = {"note": "test"}
    jck.save_checkpoint_sharded(str(tmp_path / "jax" / "ck"), jsh, meta)
    tck.save_checkpoint_sharded(str(tmp_path / "port" / "ck"), tsh, meta)
    assert sorted(os.listdir(tmp_path / "jax")) == \
        sorted(os.listdir(tmp_path / "port"))
    assert _bytes(tmp_path / "jax" / "ck.json") == \
        _bytes(tmp_path / "port" / "ck.json")
    for k in range(8):
        with np.load(tmp_path / "jax" / f"ck.shard{k:03d}.npz") as ja, \
                np.load(tmp_path / "port" / f"ck.shard{k:03d}.npz") as tb:
            assert sorted(ja.files) == sorted(tb.files)
            for name in ja.files:
                assert ja[name].dtype == tb[name].dtype
                assert ja[name].tobytes() == tb[name].tobytes(), (k, name)

    # the port reads the JAX files: on one device, and onto its mesh
    got, meta = tck.load_checkpoint_sharded(str(tmp_path / "jax" / "ck"),
                                            "cpu")
    assert meta["note"] == "test" and meta["n_shards"] == 8
    for (name, want), (_, have) in zip(_leaves(ts), _leaves(got)):
        assert have.tobytes() == want.tobytes(), name
    assert got.time == ts.time and got.step_number == 7
    on_mesh, _ = tck.load_checkpoint_sharded(
        str(tmp_path / "jax" / "ck"), geo=tgeo, mesh=mesh)
    for (a, b), t in on_mesh.T.items():
        assert torch.equal(t, tsh.T[a, b])
        assert torch.equal(on_mesh.u[a, b], tsh.u[a, b])

    # the JAX package reads the port's, on one device and sharded
    jgot, _ = jck.load_checkpoint_sharded(str(tmp_path / "port" / "ck"))
    for (name, want), (_, have) in zip(_leaves(ts), _leaves(jgot)):
        assert have.tobytes() == want.tobytes(), name
    jgot2, _ = jck.load_checkpoint_sharded(
        str(tmp_path / "port" / "ck"),
        sharding=state_sharding(jgeo, jmesh))
    assert np.asarray(jgot2.p).tobytes() == s["p"].tobytes()
    assert int(jgot2.step_number) == 7


def test_checkpoint_refuses_the_wrong_layout(tmp_path):
    s = _port_state(_np_state(np.float64))
    tsh = shard_state(s, GEOS["shell"][1](), _port_mesh())
    with pytest.raises(ValueError, match="save_checkpoint_sharded"):
        tck.save_checkpoint(str(tmp_path / "a"), tsh)
    with pytest.raises(ValueError, match="sharded state"):
        tck.save_checkpoint_sharded(str(tmp_path / "b"), s)
    path = tck.save_checkpoint_sharded(str(tmp_path / "c"), tsh)
    with pytest.raises(ValueError, match="device or mesh"):
        tck.load_checkpoint_sharded(path)
    with pytest.raises(ValueError, match="geo"):
        tck.load_checkpoint_sharded(path, mesh=_port_mesh())


# ------------------------------------------------------- record_history
def _spd_1d(n, seed, xp):
    """A 1D Helmholtz operator (mass + k * Dirichlet Laplacian), its
    diagonal and a right-hand side, in numpy for both packages."""
    rng = np.random.RandomState(seed)
    mass = 1.0 + rng.rand(n)
    k = 0.3
    b = rng.randn(n)

    def op(x):
        lap = -2.0 * x
        lap = lap + xp.concatenate([x[1:], x[:1] * 0])
        lap = lap + xp.concatenate([x[:1] * 0, x[:-1]])
        return mass_x(x) - k * lap

    if xp is torch:
        m = torch.as_tensor(mass)
        mass_x = lambda x: m * x
        return op, m + 2 * k, torch.as_tensor(b)
    m = jnp.asarray(mass)
    mass_x = lambda x: m * x
    return op, m + 2 * k, jnp.asarray(b)


def _same_trail(got, want):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)


@pytest.mark.parametrize("solver,cap", [
    ("cg", 48), ("cg", 3), ("richardson", 48), ("richardson", 2)])
def test_record_history_matches_jax(solver, cap):
    """The same operator and seed in f64: the port's trail is the JAX
    trail (cap above the iterations: NaN-padded; below: CG's last slot
    overwritten, Richardson's cut); without record_history, None."""
    from dycoreplanet_tpu.solvers.cg import cg as jcg
    from dycoreplanet_tpu.solvers.fixed import richardson_solve as jrich
    from dycoreplanet_tpu_torch.solvers.cg import cg as tcg
    from dycoreplanet_tpu_torch.solvers.fixed import richardson_solve as trich

    n = 40
    jop, jdiag, jb = _spd_1d(n, 7, jnp)
    top, tdiag, tb = _spd_1d(n, 7, torch)
    if solver == "cg":
        kw = dict(rtol=1e-12, maxiter=200)
        want = jcg(jop, jb, preconditioner=lambda r: r / jdiag,
                   record_history=cap, **kw)
        got = tcg(top, tb, preconditioner=lambda r: r / tdiag,
                  record_history=cap, **kw)
        plain = tcg(top, tb, preconditioner=lambda r: r / tdiag, **kw)
        assert int(want.iterations) == got.iterations > 3
    else:
        kw = dict(iters=5, rtol=1e-8)
        want = jrich(jop, jb, jb, diag=jdiag, record_history=cap, **kw)
        got = trich(top, tb, tb, diag=tdiag, record_history=cap, **kw)
        plain = trich(top, tb, tb, diag=tdiag, **kw)
    _same_trail(got.history, want.history)
    assert plain.history is None
    assert torch.equal(plain.x, got.x)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-12, atol=1e-14)
