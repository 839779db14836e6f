"""K1o and K2o, the Richardson and forcing kernels in their operands halo
mode, and K2mo, the forcing without the temperature transport in that
mode, on a CUDA card: on every shard of a mesh whose shards all lie on
the card, each against its plain version on the same operands, and the
shards' outputs stitched together against the single-device kernels K1,
K2 and K2m; K2o and K2mo also on edge shards and misaligned operands,
and under their launch plan against one radial chunk; K1o on edge
shards, misaligned operands and an odd lon count, and under its launch
plan (its tile from the shard and the card) against a (8, 8, 32) tile.
Imports neither JAX nor the JAX package, so that it runs on a machine
with a card and no JAX; it skips without a card."""

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.presets import (
    bench_params, seed_developed_flow)
from dycoreplanet_tpu_torch.parallel.halo import halo_pad
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, build, shard_state, unshard_field)
from dycoreplanet_tpu_torch.parallel.sharded_pallas import forcing_halos


def _close(got, want, rtol, atol, what):
    err = float((got - want).abs().max())
    lim = float((atol + rtol * want.abs()).min())
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all()), (
        f"{what}: max |diff| {err:.3e} (rtol {rtol}, atol {atol:.3e}, "
        f"tightest limit {lim:.3e})")


def kernel_checks(shape, mesh_shape, dtype, iters=(1, 1)):
    """K2o and K1o against their plain versions on every shard of a mesh
    on the card, and stitched against K2 and K1; returns the max abs
    errors (K2o, K1o)."""
    p = bench_params(shape, dtype)
    p.numerics.momentum_fixed_iters, p.numerics.fixed_solver_iters = iters
    dev = torch.device("cuda")
    model = BoussinesqModel(p, device=dev)
    A, B = mesh_shape
    mesh = Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon"))
    model.prepare_sharded(mesh)
    f32 = model.torch_dtype == torch.float32
    s0 = seed_developed_flow(model)
    dt = model._scalar(2e-3)
    sh = shard_state(s0, model.geo, mesh)
    forcing, rich = model._mesh.forcing, model._mesh.richardson
    kf, kr = forcing.kern, rich.kern
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh)
    _, nl, no = kf.local_shape

    # K2o: every shard, kernel against plain
    out2 = {}
    err2 = 0.0
    for (a, b), u in sh.u.items():
        args = (u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b],
                sh.p[a, b], dt, halos[a, b], (a * nl, b * no))
        got = kf.call_operands(*args)
        want = kf.plain_operands(*args)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("rhs_u", "T_adv")):
            sc = float(w.abs().max())
            tol = (1e-5 if f32 else 1e-12) * sc
            _close(g, w, 0.0, tol, f"K2o {name} shard {(a, b)}")
            err2 = max(err2, float((g - w).abs().max()))
        out2[a, b] = got
    # stitched against the single-device kernel K2
    k2 = model._forcing(s0.u, s0.u_faces, s0.T, s0.p, dt)
    for i, name in enumerate(("rhs_u", "T_adv")):
        st_ = unshard_field(build(mesh, lambda a, b: out2[a, b][i]))
        sc = float(k2[i].abs().max())
        _close(st_, k2[i], 0.0, (1e-5 if f32 else 1e-12) * sc,
               f"K2o stitched vs K2 {name}")

    # K1o on K2's outputs, as the step runs it
    rhs_u = build(mesh, lambda a, b: out2[a, b][0])
    rhs_T = build(mesh, lambda a, b: out2[a, b][1])
    GH = kr.GH
    st5 = rhs_u.map(lambda u, r, t: torch.cat([u, r[None], t[None]]),
                    rhs_T, sh.T)
    st5 = halo_pad(st5, mesh, "lon", 3, width=GH, periodic=True)
    st5 = halo_pad(st5, mesh, "lat", 2, width=GH, periodic=False)
    tol = 2e-6 if f32 else 1e-12
    err1 = 0.0
    outs = {}
    for (a, b), e in st5.items():
        args = (e[:3], e[3], e[4], dt, (a * nl, b * no))
        got = kr.call_operands(*args)
        want = kr.plain_operands(*args)
        torch.cuda.synchronize()
        for g, w, name in zip(got[:5], want[:5],
                              ("u_star", "T_new", "f0", "f1", "f2")):
            _close(g, w, tol, tol, f"K1o {name} shard {(a, b)}")
            err1 = max(err1, float((g - w).abs().max()))
        sc = float(want[5].abs().max()) + 1e-30
        _close(got[5], want[5], 1e-4 if f32 else 1e-11,
               (2e-5 if f32 else 1e-11) * sc, f"K1o rhs_raw shard {(a, b)}")
        gs, ws = got[6].double().cpu(), want[6].double().cpu()
        eps = float(torch.finfo(model.torch_dtype).eps)
        for k in (1, 3):            # |b|^2: plain sums
            assert abs(gs[k] - ws[k]) <= (1e-5 if f32 else 1e-12) * ws[k]
        for r, bb in ((0, 1), (2, 3)):  # |r|: 0.1 rn + 4 eps |b|
            rg, rw = float(gs[r]) ** 0.5, float(ws[r]) ** 0.5
            assert abs(rg - rw) <= 0.1 * rw + 4 * eps * float(ws[bb]) ** 0.5
        assert abs(gs[4] - ws[4]) <= (1e-4 if f32 else 1e-11) * float(
            want[5].abs().sum())
        outs[a, b] = got
    # stitched against the single-device kernel K1 (same rhs): u*, T and
    # the faces; rhs_raw through rhs_phi's compatibility shift
    k1 = model._richardson(unshard_field(rhs_u), unshard_field(rhs_T),
                           s0.T, dt)
    for i, w in enumerate((k1[0], k1[1]) + tuple(k1[2][:3])):
        g = unshard_field(build(mesh, lambda a, b: outs[a, b][i]))
        _close(g, w, tol, tol, f"K1o stitched vs K1 output {i}")
    assert kf.launches == A * B and kr.launches == A * B, "launches"
    return err2, err1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_k1o_k2o_match_plain_versions(dtype):
    """On a card: K2o and K1o on meshes of 2 x 4 and 2 x 2 shards, at a
    small shell, at one whose shards no tile divides, and with two sweeps
    (halo 3), each shard against its plain version, and the stitched
    outputs against K2 and K1 (f32: K2o 1e-5 x scale, K1o rtol = atol =
    2e-6; f64: 1e-12)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for shape, mesh_shape, iters in (((8, 16, 32), (2, 4), (1, 1)),
                                     ((6, 20, 36), (2, 2), (1, 1)),
                                     ((8, 16, 32), (2, 2), (2, 2)),
                                     ((4, 8, 16), (2, 4), (1, 1))):
        kernel_checks(shape, mesh_shape, dtype, iters)


def k2mo_checks(shape, mesh_shape, dtype):
    """K2mo against its plain version on every shard of a mesh on the card
    (a semi-Lagrangian model: six ghost operands, rhs_u alone), and the
    stitched shards against K2m; returns the max abs error."""
    p = bench_params(shape, dtype)
    p.numerics.temperature_advection = "semi-lagrangian"
    dev = torch.device("cuda")
    model = BoussinesqModel(p, device=dev)
    A, B = mesh_shape
    mesh = Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon"))
    model.prepare_sharded(mesh)
    f32 = model.torch_dtype == torch.float32
    s0 = seed_developed_flow(model)
    dt = model._scalar(2e-3)
    sh = shard_state(s0, model.geo, mesh)
    kf = model._mesh.forcing.kern
    assert not kf.advect_T
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh, advect_T=False)
    _, nl, no = kf.local_shape
    out, err = {}, 0.0
    for (a, b), u in sh.u.items():
        args = (u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b],
                sh.p[a, b], dt, halos[a, b], (a * nl, b * no))
        got = kf.call_operands(*args)
        want = kf.plain_operands(*args)
        torch.cuda.synchronize()
        assert torch.is_tensor(got)
        tol = (1e-5 if f32 else 1e-12) * float(want.abs().max())
        _close(got, want, 0.0, tol, f"K2mo shard {(a, b)}")
        err = max(err, float((got - want).abs().max()))
        out[a, b] = got
    k2m = model._forcing(s0.u, s0.u_faces, s0.T, s0.p, dt)
    _close(unshard_field(build(mesh, lambda a, b: out[a, b])), k2m, 0.0,
           (1e-5 if f32 else 1e-12) * float(k2m.abs().max()),
           "K2mo stitched vs K2m")
    assert kf.launches == A * B, "launches"
    return err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_k2mo_matches_plain_version(dtype):
    """On a card: K2mo on meshes of 2 x 4 and 2 x 2 shards, at a small
    shell and at one whose shards no tile divides, each shard against its
    plain version and the stitched outputs against K2m (f32 1e-5 x scale,
    f64 1e-12 x scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for shape in ((8, 16, 32), (6, 20, 36)):
        for mesh_shape in ((2, 4), (2, 2)):
            k2mo_checks(shape, mesh_shape, dtype)


def shard_operands(shape, mesh_shape, dtype, sl):
    """A model of ``shape`` prepared for a mesh of A x B shards on the card
    (with ``sl`` the semi-Lagrangian model, whose forcing is K2mo), and
    the operands of its forcing kernel on every shard of the seeded
    developed flow: (kernel wrapper, {(a, b): call_operands arguments})."""
    p = bench_params(shape, dtype)
    if sl:
        p.numerics.temperature_advection = "semi-lagrangian"
    dev = torch.device("cuda")
    model = BoussinesqModel(p, device=dev)
    A, B = mesh_shape
    mesh = Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon"))
    model.prepare_sharded(mesh)
    s0 = seed_developed_flow(model)
    dt = model._scalar(2e-3)
    sh = shard_state(s0, model.geo, mesh)
    kf = model._mesh.forcing.kern
    assert kf.advect_T == (not sl)
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh,
                          advect_T=kf.advect_T)
    _, nl, no = kf.local_shape
    return kf, {(a, b): (u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b],
                         sh.p[a, b], dt, halos[a, b], (a * nl, b * no))
                for (a, b), u in sh.u.items()}


def _outputs(out):
    return tuple(out) if isinstance(out, tuple) else (out,)


def _misaligned(x):
    """x's values in a contiguous tensor whose first value lies one value
    (4 bytes in f32, 8 in f64) past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def check_k2o_shards(kf, args, dtype, what):
    """Every shard's kernel output against its plain version (f32 1e-5 x
    scale, f64 1e-12 x scale); returns the outputs by shard."""
    tol = 1e-5 if dtype == "float32" else 1e-12
    outs = {}
    for ab, a in args.items():
        got = _outputs(kf.call_operands(*a))
        want = _outputs(kf.plain_operands(*a))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _close(g, w, 0.0, tol * float(w.abs().max()),
                   f"{what} shard {ab}")
        outs[ab] = got
    return outs


def ragged_depth(mesh_shape, dtype, nlat=128, nlon=256):
    """The least depth nr whose shard (nr, nlat / A, nlon / B) the
    operands plan cuts into radial chunks of which the last is short, on
    this card."""
    from dycoreplanet_tpu_torch.ops import forcing as k2

    dev = torch.device("cuda")
    probe = BoussinesqModel(bench_params((4, nlat, nlon), dtype),
                            device=dev)
    A, B = mesh_shape
    probe.prepare_sharded(Mesh(np.array([[dev] * B] * A, dtype=object),
                               ("lat", "lon")))
    kf = probe._mesh.forcing.kern
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = kf.occupancy(getattr(torch, dtype))
    for nr in range(8, 65):
        rs = k2.plan_operands((nr, nlat // A, nlon // B), sms, per_sm)[0]
        if nr % rs:
            return nr
    raise AssertionError("the operands plan cuts no depth of 8-64 into a "
                         "short last chunk on this card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("sl", [False, True], ids=["K2o", "K2mo"])
def test_cuda_k2o_k2mo_edge_shards(dtype, sl):
    """On a card: K2o and K2mo on every shard against their plain versions
    where the plan's last radial chunk is short (a 2 x 2 mesh of 128 x
    256 at the least such depth), where nlon is not a multiple of 16
    bytes' values (rows value by value: shards 10 x 18 in f32, 10 x 9),
    where a shard is narrower than a tile and its rows end inside the tile
    (8 x 36: 16-byte copies, then the ghosts at the ragged end), and with
    every operand one value off a 16-byte boundary, which must give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    what = "K2mo" if sl else "K2o"
    nr = ragged_depth((2, 2), dtype)
    for shape, mesh_shape in (((nr, 128, 256), (2, 2)),
                              ((6, 20, 36), (2, 2)), ((6, 20, 36), (2, 4)),
                              ((8, 16, 72), (2, 2))):
        kf, args = shard_operands(shape, mesh_shape, dtype, sl)
        outs = check_k2o_shards(kf, args, dtype, f"{what} {shape} "
                                f"{mesh_shape}")
        a = args[0, 0]
        off = (_misaligned(a[0]), tuple(_misaligned(f) for f in a[1]),
               _misaligned(a[2]), _misaligned(a[3]), a[4],
               {k: _misaligned(h) for k, h in a[5].items()}, a[6])
        got = _outputs(kf.call_operands(*off))
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, outs[0, 0])), (
            f"{what} {shape}: misaligned operands change the result")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("sl", [False, True], ids=["K2o", "K2mo"])
def test_cuda_k2o_plan_matches_one_chunk(dtype, sl, monkeypatch, capsys):
    """On a card, at the bench's shards (32 x 128 x 256 on 2 x 2 and 2 x
    4): the operands plan's radial chunks against one chunk of all nr
    planes a block (the launch plan before the shard chose it), within
    K2o's tolerance (f32 1e-5 x scale, f64 1e-12 x scale); says whether
    they agree to the last bit (a chunk's lower face flux is formed from
    M_AR_LO where the plane below carries it from M_AR_HI)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from dycoreplanet_tpu_torch.ops import forcing as k2

    what = "K2mo" if sl else "K2o"
    tol = 1e-5 if dtype == "float32" else 1e-12
    for mesh_shape in ((2, 2), (2, 4)):
        kf, args = shard_operands((32, 128, 256), mesh_shape, dtype, sl)
        rs = kf.operands_plan(torch.device("cuda"), getattr(torch, dtype))[0]
        planned = {ab: _outputs(kf.call_operands(*a))
                   for ab, a in args.items()}
        with monkeypatch.context() as mp:
            mp.setattr(k2, "plan_operands",
                       lambda shape, sms, per_sm: (shape[0], None))
            whole = {ab: _outputs(kf.call_operands(*a))
                     for ab, a in args.items()}
        torch.cuda.synchronize()
        bitwise = True
        for ab in args:
            for g, w in zip(planned[ab], whole[ab]):
                _close(g, w, 0.0, tol * float(w.abs().max()),
                       f"{what} {mesh_shape} shard {ab}: RS {rs} vs 32")
                bitwise = bitwise and torch.equal(g, w)
        with capsys.disabled():
            print(f"\n{what} {dtype} {mesh_shape}: RS {rs} vs RS 32 "
                  f"{'bitwise equal' if bitwise else 'not bitwise equal'}")


def k1o_operands(shape, mesh_shape, dtype):
    """A model of ``shape`` prepared for a mesh of A x B shards on the card
    and the operands of K1o on every shard, as the step forms them from
    K2o's outputs on the seeded developed flow: (kernel wrapper, {(a, b):
    call_operands arguments})."""
    p = bench_params(shape, dtype)
    dev = torch.device("cuda")
    model = BoussinesqModel(p, device=dev)
    A, B = mesh_shape
    mesh = Mesh(np.array([[dev] * B] * A, dtype=object), ("lat", "lon"))
    model.prepare_sharded(mesh)
    s0 = seed_developed_flow(model)
    dt = model._scalar(2e-3)
    sh = shard_state(s0, model.geo, mesh)
    kf, kr = model._mesh.forcing.kern, model._mesh.richardson.kern
    halos = forcing_halos(sh.u, sh.u_faces, sh.T, sh.p, mesh)
    _, nl, no = kr.local_shape
    out2 = {(a, b): kf.call_operands(
        u, tuple(f[a, b] for f in sh.u_faces), sh.T[a, b], sh.p[a, b], dt,
        halos[a, b], (a * nl, b * no)) for (a, b), u in sh.u.items()}
    st5 = build(mesh, lambda a, b: torch.cat(
        [out2[a, b][0], out2[a, b][1][None], sh.T[a, b][None]]))
    st5 = halo_pad(st5, mesh, "lon", 3, width=kr.GH, periodic=True)
    st5 = halo_pad(st5, mesh, "lat", 2, width=kr.GH, periodic=False)
    return kr, {(a, b): (e[:3], e[3], e[4], dt, (a * nl, b * no))
                for (a, b), e in st5.items()}


def check_k1o_shards(kr, args, dtype, what):
    """Every shard's K1o against its plain version with phase 6c's K1o
    tolerances (iterates and faces rtol = atol = 2e-6, f64 1e-12;
    rhs_raw rtol 1e-4 and atol 2e-5 x scale, f64 1e-11); returns the
    outputs by shard."""
    f32 = dtype == "float32"
    tol = 2e-6 if f32 else 1e-12
    outs = {}
    for ab, a in args.items():
        got = kr.call_operands(*a)
        want = kr.plain_operands(*a)
        torch.cuda.synchronize()
        for g, w, name in zip(got[:5], want[:5],
                              ("u_star", "T_new", "f0", "f1", "f2")):
            _close(g, w, tol, tol, f"{what} {name} shard {ab}")
        sc = float(want[5].abs().max()) + 1e-30
        _close(got[5], want[5], 1e-4 if f32 else 1e-11,
               (2e-5 if f32 else 1e-11) * sc, f"{what} rhs_raw shard {ab}")
        outs[ab] = got
    return outs


def check_k1o_sums(got, want, dtype, rhs):
    """K1o's five sums against another launch's (or the plain version's)
    with phase 6c's tolerances: |b|^2 rtol 1e-5 (f64 1e-12), |r| within
    0.1 |r| + 4 eps |b|, sum(rhs) within 1e-4 (f64 1e-11) of sum|rhs|."""
    f32 = dtype == "float32"
    eps = float(torch.finfo(getattr(torch, dtype)).eps)
    g, w = got.double().cpu(), want.double().cpu()
    for k in (1, 3):
        assert abs(g[k] - w[k]) <= (1e-5 if f32 else 1e-12) * w[k]
    for r, bb in ((0, 1), (2, 3)):
        rg, rw = float(g[r]) ** 0.5, float(w[r]) ** 0.5
        assert abs(rg - rw) <= 0.1 * rw + 4 * eps * float(w[bb]) ** 0.5
    assert abs(g[4] - w[4]) <= (1e-4 if f32 else 1e-11) * float(
        rhs.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_k1o_edge_shards(dtype):
    """On a card: K1o on every shard against its plain version where the
    extended rows cannot go as 16-byte copies (shards 10 x 18: rows of
    22 values, value by value in f32; 10 x 9: rows of 13, value by value
    in f32 and f64), where a shard is narrower than the plan's tile, at
    the bench's 2 x 4 shard, and with every operand one value off a
    16-byte boundary (value by value into the same layout), which must
    give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for shape, mesh_shape in (((6, 20, 36), (2, 2)), ((6, 20, 36), (2, 4)),
                              ((8, 16, 72), (2, 2)),
                              ((32, 128, 256), (2, 4))):
        kr, args = k1o_operands(shape, mesh_shape, dtype)
        what = f"K1o {shape} {mesh_shape}"
        outs = check_k1o_shards(kr, args, dtype, what)
        a = args[0, 0]
        got = kr.call_operands(_misaligned(a[0]), _misaligned(a[1]),
                               _misaligned(a[2]), a[3], a[4])
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got[:6], outs[0, 0])), (
            f"{what}: misaligned operands change the result")
        check_k1o_sums(got[6], outs[0, 0][6], dtype, outs[0, 0][5])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_k1o_odd_lon_mesh(dtype):
    """On a card: K2o and K1o on a mesh of 2 x 3 shards (an odd lon
    count) at 8 x 16 x 48, each shard against its plain version and the
    stitched shards against K2 and K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    kernel_checks((8, 16, 48), (2, 3), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_k1o_plan_matches_k1_tile(dtype, monkeypatch, capsys):
    """On a card, at the bench's shards (32 x 128 x 256 on 2 x 2 and 2 x
    4): K1o under its launch plan (its tile from the shard and the card)
    against a (8, 8, 32) tile, the launch before the shard chose it: u*,
    T_new, the three faces and rhs_raw bitwise equal (every cell has the
    same arithmetic whatever its tile), the five sums, whose per-block
    partials go in another order, within K1o's tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from dycoreplanet_tpu_torch.ops import richardson as k1

    def k1_tile(shape, sms, per_sm, itemsize, iters_u, iters_T):
        tile, halo = (8, 8, 32), max(iters_u, iters_T) + 1
        return k1.PassPlan(iters_u, iters_T, halo, tile, tuple(
            -(-n // t) for n, t in zip(shape, tile)), k1.shared_bytes(
                tile, halo, itemsize, operands=True))

    for mesh_shape in ((2, 2), (2, 4)):
        kr, args = k1o_operands((32, 128, 256), mesh_shape, dtype)
        ps = kr.operands_plan(torch.device("cuda"), getattr(torch, dtype))[0]
        planned = {ab: kr.call_operands(*a) for ab, a in args.items()}
        with monkeypatch.context() as mp:
            mp.setattr(k1, "plan_operands", k1_tile)
            kr._card.clear()
            one = {ab: kr.call_operands(*a) for ab, a in args.items()}
        kr._card.clear()
        torch.cuda.synchronize()
        for ab in args:
            for i, name in enumerate(("u_star", "T_new", "f0", "f1", "f2",
                                      "rhs_raw")):
                assert torch.equal(planned[ab][i], one[ab][i]), (
                    f"K1o {mesh_shape} shard {ab} {name}: plan {ps.tile} "
                    f"vs (8, 8, 32): max |diff| "
                    f"{float((planned[ab][i] - one[ab][i]).abs().max()):.3e}")
            check_k1o_sums(planned[ab][6], one[ab][6], dtype, one[ab][5])
        with capsys.disabled():
            print(f"\nK1o {dtype} {mesh_shape}: plan {ps.tile} "
                  f"({ps.n_blocks} blocks) vs (8, 8, 32): bitwise equal")
