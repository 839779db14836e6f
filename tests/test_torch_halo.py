"""The port's mesh and halo layer (dycoreplanet_tpu_torch/parallel/mesh.py
and halo.py) against the JAX package's (parallel/mesh.py, halo.py, on
its 8 virtual CPU devices) and against torch.roll on global arrays: the
mesh shapes, the ring permutations, the ghost exchange and padding
(zeros on the non-periodic edges, as ppermute gives), the pole closure
(the half-turn ring at lon + pi, for even and odd lon shard counts),
fixed-order sums, the shard geometry, and state sharding round trips."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.parallel import halo as j_halo
from dycoreplanet_tpu.parallel import mesh as j_mesh
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import (
    sharded_state_from_numpy, state_to_numpy)
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec, pad_axis
from dycoreplanet_tpu_torch.parallel import halo, mesh as t_mesh
from tests.test_torch_kernels import _configure

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map


def _mesh(A, B):
    return t_mesh.Mesh(np.array([["cpu"] * B] * A, dtype=object),
                       ("lat", "lon"))


def _global(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


@pytest.mark.parametrize("n", range(1, 17))
def test_factor2_matches_jax(n):
    assert t_mesh._factor2(n) == j_mesh._factor2(n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_build_mesh_and_mesh_shape_for_match_jax(n):
    """Same mesh shapes and axis names as the JAX functions, for the shell
    and the annulus."""
    for jg, tg in ((j_factory.make_shell(4, 8, 16, 1.0, 3.0),
                    t_factory.make_shell(4, 8, 16, 1.0, 3.0)),
                   (j_factory.make_annulus(8, 16, 1.0, 3.0),
                    t_factory.make_annulus(8, 16, 1.0, 3.0))):
        jm = j_mesh.build_mesh(jg, jax.devices()[:n])
        tm = t_mesh.build_mesh(tg, ["cpu"] * n)
        assert tm.axis_names == jm.axis_names
        assert tm.devices.shape == jm.devices.shape
        assert dict(tm.shape) == dict(jm.shape)
        assert t_mesh.mesh_shape_for(tg, n) == j_mesh.mesh_shape_for(jg, n)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("periodic", [True, False])
def test_ring_perms_match_jax(n, periodic):
    assert halo.ring_perms(n, periodic) == j_halo.ring_perms(n, periodic)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (2, 2)])
@pytest.mark.parametrize("width", [1, 2])
def test_halo_pad_matches_roll_and_jax(mesh_shape, width):
    """halo_pad along lon (periodic) equals the global array rolled; along
    lat (non-periodic) the ends get zeros; both equal the JAX halo_pad
    under shard_map on the same mesh."""
    A, B = mesh_shape
    x = _global((3, 8, 16))
    mesh = _mesh(A, B)
    sx = t_mesh.shard_field(x, mesh)
    nl, no = 8 // A, 16 // B
    lon = halo.halo_pad(sx, mesh, "lon", 2, width=width, periodic=True)
    lat = halo.halo_pad(sx, mesh, "lat", 1, width=width, periodic=False)
    xz = torch.nn.functional.pad(x, (0, 0, width, width))
    for (a, b), t in lon.items():
        cols = torch.arange(b * no - width, (b + 1) * no + width) % 16
        want = x[:, a * nl:(a + 1) * nl][:, :, cols]
        assert torch.equal(t, want)
        want = xz[:, a * nl:(a + 1) * nl + 2 * width, b * no:(b + 1) * no]
        assert torch.equal(lat[a, b], want)
    # the JAX function on the same mesh
    jm = JMesh(np.asarray(jax.devices()[:A * B]).reshape(A, B),
               ("lat", "lon"))
    spec = P(None, "lat", "lon")
    for name, ax, per, got in (("lon", 2, True, lon), ("lat", 1, False, lat)):
        f = shard_map(lambda v: j_halo.halo_pad(v, name, ax, width=width,
                                                periodic=per),
                      mesh=jm, in_specs=spec, out_specs=spec,
                      check_vma=False)
        want = np.asarray(f(jnp.asarray(x.numpy())))
        np.testing.assert_array_equal(
            t_mesh.unshard_field(got).numpy(), want)


@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_half_turn_is_the_global_roll(B):
    """The half-turn ring of each lon shard equals the global ring rolled
    by nlon / 2, also for odd B, where the half turn falls inside a shard
    (nlon = 12, so that B = 3 has 4 columns a shard)."""
    x = _global((2, 1, 12), seed=3)
    mesh = _mesh(2, B)
    rows = t_mesh.Sharded([[x[..., b * (12 // B):(b + 1) * (12 // B)]
                            for b in range(B)] for _ in range(2)])
    got = t_mesh.unshard_field(halo.half_turn(rows, mesh))
    want = torch.roll(x, 6, dims=-1)
    assert torch.equal(got[..., :1, :], want)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (2, 3), (2, 2)])
def test_pad_block_equals_the_global_ghost_rules(mesh_shape):
    """pad_block by one cell with the POLE sign equals the single-device
    ghost rules of ops/bc.py (POLE along lat, periodic lon) on every
    shard, corners excepted (no axis-wise stencil reads them)."""
    A, B = mesh_shape
    x = _global((4, 8, 12), seed=5)
    mesh = _mesh(A, B)
    got = halo.pad_block(t_mesh.shard_field(x, mesh), mesh, 1, sign=1.0)
    g = pad_axis(pad_axis(x, 1, BCSpec(BC.POLE, BC.POLE), False), 2, None,
                 True)
    nl, no = 8 // A, 12 // B
    for (a, b), t in got.items():
        want = g[:, a * nl:(a + 1) * nl + 2, b * no:(b + 1) * no + 2]
        assert torch.equal(t[:, 1:-1, :], want[:, 1:-1, :])
        assert torch.equal(t[:, :, 1:-1], want[:, :, 1:-1])


def test_psum_is_fixed_order_and_pmax():
    """psum adds the shards in shard order (a major, b minor), bitwise the
    same every call; pmax is the elementwise max."""
    mesh = _mesh(2, 4)
    vals = t_mesh.build(mesh, lambda a, b: _global((5,), seed=10 * a + b))
    want = None
    for _, t in vals.items():
        want = t if want is None else want + t
    got = halo.psum(vals, mesh)[torch.device("cpu")]
    assert torch.equal(got, want)
    assert torch.equal(halo.psum(vals, mesh)[torch.device("cpu")], got)
    mx = torch.stack([t for _, t in vals.items()]).max(dim=0).values
    assert torch.equal(halo.pmax(vals, mesh), mx)


@pytest.mark.parametrize("pad", [0, 1, 2])
def test_shard_geometry_is_the_global_metric(pad):
    """A shard's (padded) geometry holds the global metric at its cells and
    faces; past a pole the rows repeat the pole's and the faces have zero
    area; the plain divergence on the padded block equals the global one
    on the owned cells."""
    geo = t_factory.make_shell(4, 8, 16, 1.0, 3.0)
    A, B = 2, 4
    nl, no = 4, 4
    x = [_global((4, 8, 16), seed=s) for s in range(3)]
    div = st.divergence(geo, x)
    mesh = _mesh(A, B)
    fp = [halo.pad_block(t_mesh.shard_field(f, mesh), mesh, max(pad, 1))
          for f in x]
    w = max(pad, 1)
    for a in range(A):
        for b in range(B):
            g = t_mesh.shard_geometry(geo, a * nl, nl, b * no, no, pad=pad)
            rows = np.clip(np.arange(a * nl - pad, (a + 1) * nl + pad), 0, 7)
            np.testing.assert_array_equal(g.vol, geo.vol[:, rows])
            faces = np.clip(np.arange(a * nl - pad, (a + 1) * nl + pad + 1),
                            0, 8)
            np.testing.assert_array_equal(g.face_area[1],
                                          geo.face_area[1][:, faces])
            if a == 0 and pad:
                assert not g.face_area[1][:, :pad + 1].any()
            gw = t_mesh.shard_geometry(geo, a * nl, nl, b * no, no, pad=w)
            d = t_mesh.crop(st.divergence(gw, [f[a, b] for f in fp]), w)
            assert torch.equal(d, div[:, a * nl:(a + 1) * nl,
                                      b * no:(b + 1) * no])


def test_shard_state_round_trip_is_bitwise():
    """shard_state then unshard_state gives the state back bitwise; time
    and step number stay host numbers; the numpy converters carry a
    sharded state both ways."""
    p = _configure(Parameters.from_text(""), "float64", (4, 8, 16))
    model = BoussinesqModel(p, device="cpu")
    mesh = _mesh(2, 4)
    model.prepare_sharded(mesh)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 4, 8, 16))
    faces = [rng.standard_normal((4, 8, 16)) for _ in range(3)]
    pres, T = rng.standard_normal((4, 8, 16)), model.T_init
    s = sharded_state_from_numpy(model, u, faces, pres, T, 0.5, 3)
    assert s.u[1, 2].shape == (3, 4, 4, 4) and s.time == 0.5
    back = t_mesh.unshard_state(s)
    assert torch.equal(back.u, torch.as_tensor(u))
    assert torch.equal(back.T, torch.as_tensor(T))
    s2 = t_mesh.shard_state(back, model.geo, mesh)
    for (ab, t) in s.p.items():
        assert torch.equal(t, s2.p[ab])
    hu, hf, hp, hT, time, n = state_to_numpy(s)
    np.testing.assert_array_equal(hu, u)
    np.testing.assert_array_equal(hf[1], faces[1])
    assert (time, n) == (0.5, 3)
