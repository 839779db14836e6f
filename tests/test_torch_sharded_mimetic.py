"""The mimetic (staggered C-grid) personality on the port's mesh
(``MimeticBoussinesqModel.prepare_sharded``) against the JAX mimetic
model and the port's single device, on a shell of 8 x 8 x 16 in f64; the
shards on the CPU:

  * the staggered operators on the shards' windows
    (parallel/sharded_mimetic.py: the face tendency, C^T M C, the cell
    velocity, the flux-form transport) against one device's, to 1e-12 of
    their scale on the meshes (2, 4), (4, 2), (1, 8), (2, 2) and (8, 1)
    (shards of one lat row, thinner than the window's reach);
  * mimetic steps through ``prepare_sharded`` on (2, 4) against the JAX
    model's steps (its plain path: the mesh changes only the sums' order)
    and the port's single-device steps: the fields within 1e-10 of their
    scale (p 1e-9), equal CG iterations, max|div u| <= 1e-9 (the face
    ownership at the shard seams); both coriolis modes and `poisson
    solver = cg`; the JAX ``prepare_sharded(mesh, pallas=False)`` step on
    its 8 virtual devices, as ``__graft_entry__.dryrun_multichip`` runs
    it;
  * ``run`` with a momentum CG miss escalating on the mesh as on one
    device, a ``multi_step`` chunk equal to its steps, and a bfloat16
    mesh step against one device's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.models import make_model as j_make_model
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, shard_state as j_shard_state,
    state_sharding)
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import make_model
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, shard_field, shard_state, unshard_field, unshard_state)
from tests.test_torch_mimetic import _compare_packed, _np, _params, _seeded

SHAPE = (8, 8, 16)
MESHES = [(2, 4), (4, 2), (1, 8), (2, 2), (8, 1)]
TOL, P_TOL = 1e-10, 1e-9
DT = 0.005


def _shell(f):
    return f.make_shell(*SHAPE, 1.0, 2.0)


def _models(**num):
    """(port model on the CPU, JAX model) of the mimetic shell."""
    kw = dict(cuboid=False)
    tm = make_model(_params(Parameters, **kw, **num), _shell(t_factory),
                    device="cpu")
    jm = j_make_model(_params(JParameters, **kw, **num), _shell(j_factory))
    return tm, jm


def _port(**num):
    return make_model(_params(Parameters, cuboid=False, **num),
                      _shell(t_factory), device="cpu")


def _tmesh(A, B):
    return Mesh(np.array([["cpu"] * B] * A, dtype=object), ("lat", "lon"))


def _close(got, want, tol, what):
    want, got = np.asarray(want), _np(got)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _hold(got, wants, what):
    """A sharded state against global ones (JAX State or port State)."""
    g = unshard_state(got)
    for want in wants:
        for f in ("u", "p", "T"):
            _close(getattr(g, f), getattr(want, f),
                   P_TOL if f == "p" else TOL, f"{what} {f}")
        for d in range(3):
            _close(g.u_faces[d], want.u_faces[d], TOL, f"{what} face {d}")


# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_staggered_operators_match_one_device(mesh_shape):
    """Each operator the mimetic mesh step runs on the shards' windows,
    against the single-device operator on the same random fields, to
    1e-12 of its scale: the viscous solve's right-hand side U + dt x the
    face tendency (vorticity, cross product, kinetic energy, buoyancy,
    grad p; the physical Coriolis), C^T M C, the cell velocity of the faces and the MUSCL
    flux-form transport."""
    tm = _port(coriolis_mode="physical")
    tm.prepare_sharded(_tmesh(*mesh_shape))
    stag = tm._mesh.staggered
    sg = tm.stag
    rng = np.random.default_rng(3)
    faces = [tm._apply_wall_face_values(torch.as_tensor(
        rng.standard_normal(SHAPE)), d) for d in range(3)]
    x = torch.stack(faces)
    pres = torch.as_tensor(rng.standard_normal(SHAPE))
    T = torch.as_tensor(tm.T_init + 0.1 * rng.standard_normal(SHAPE))
    t = lambda a: shard_field(a, tm._mesh.mesh)  # noqa: E731

    def hold(got, want, what):
        got, want = _np(unshard_field(got)), _np(want)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), what

    def rhs(w, f0, f1, f2, pw, Tw):
        return tm._face_rhs((f0, f1, f2), pw, Tw, DT,
                            w.constants(Tw.dtype)[0])

    U = sg.expand(faces)
    hold(stag.apply(rhs, *map(t, faces), t(pres), t(T)),
         tm._face_rhs(faces, pres, T, DT), "face rhs")
    hold(stag.curlcurl(t(x)),
         torch.stack(sg.contract(sg.curlcurl_weighted(U))), "curlcurl")
    hold(stag.cell_velocity([t(f) for f in faces]),
         torch.stack([sg.avg_f2c(U[c], c) for c in range(3)]), "cell u")
    hold(stag.transport(None, [t(f) for f in faces], t(T), 0.01),
         T - 0.01 * st.advect_scalar(tm.geo, faces, T, tm.T_specs,
                                     scheme=tm.advection_scheme,
                                     form="flux"), "transport")


# ----------------------------------------------------------------------
CASES = {"reference": {}, "physical": dict(coriolis_mode="physical"),
         "poisson_cg": dict(poisson_solver="cg")}


@pytest.mark.parametrize("case", list(CASES))
def test_mimetic_mesh_steps_match_jax(case):
    """Two mimetic steps on the (2, 4) mesh from the seeded flow against
    the JAX mimetic model's steps and the port's single-device steps:
    the fields within 1e-10 of their scale (p 1e-9), the packed
    diagnostics slot for slot as tests/test_torch_mimetic.py holds them
    (equal CG iterations), max|div u| <= 1e-9."""
    tm, jm = _models(**CASES[case])
    one = _port(**CASES[case])
    tm.prepare_sharded(_tmesh(2, 4))
    s1, js = _seeded(one, jm)
    sm = shard_state(s1, tm.geo, tm._mesh.mesh)
    for k in range(2):
        sm, dm = tm.step(sm, DT)
        s1, d1 = one.step(s1, DT)
        js, jd = jm.step(js, DT)
        _hold(sm, (js, s1), f"{case} step {k}")
        for ref in (jd.packed, d1.packed.numpy()):
            _compare_packed(_np(dm.packed), ref, f"{case} step {k}")
        assert dm.div_norm <= (1e-6 if case == "poisson_cg" else 1e-9)
        assert dm.helmholtz_iters[0] > 0


def test_mimetic_mesh_matches_jax_sharded_plain_path():
    """The JAX mimetic model prepared as dryrun_multichip's third part
    (``prepare_sharded(mesh, pallas=False)``, its step jitted over the 2 x
    4 mesh of its 8 virtual devices) against the port's mesh step: the
    same report ("jnp" for each stage, the sharded Poisson solve), the
    fields within 1e-10 (p 1e-9) after one step."""
    tm, jm = _models()
    one = _port()
    jmesh = j_build_mesh(jm.geo)
    jm.prepare_sharded(jmesh, pallas=False)
    tm.prepare_sharded(_tmesh(2, 4))
    assert tm.sharded_kernels() == jm.sharded_kernels()
    s1, js = _seeded(one, jm)
    sh = state_sharding(jm.geo, jmesh)
    rep = NamedSharding(jmesh, P())
    jstep = jax.jit(jm._step_impl, in_shardings=(sh, rep),
                    out_shardings=(sh, rep))
    js, _ = jstep(j_shard_state(js, jm.geo, jmesh), jnp.float64(DT))
    sm, _ = tm.step(shard_state(s1, tm.geo, tm._mesh.mesh), DT)
    _hold(sm, (js,), "sharded JAX")


def test_mimetic_mesh_run_escalation_and_chunk():
    """With 1/Re = 1 and `max cg iters` = 2 the momentum CG misses (as in
    tests/test_torch_mimetic.py): run on the mesh escalates as on one
    device (one escalation, the same window left, the state); a
    multi_step chunk of 2 on the mesh equals its steps bitwise."""
    tm, ts = _port(max_cg_iters=2), _port(max_cg_iters=2)
    tm.one_over_Re = ts.one_over_Re = 1.0
    tm.prepare_sharded(_tmesh(2, 4))
    tm._fixed_gate_on = True
    s1, _ = _seeded(ts, _models()[1])
    sm = shard_state(s1, tm.geo, tm._mesh.mesh)
    _, d = tm.step(sm, DT)
    assert not d.solver_ok and list(d.helmholtz_iters) == [2, 2, 2]
    out_m, h_m = tm.run(max_steps=3, state=sm)
    out_1, h_1 = ts.run(max_steps=3, state=s1)
    assert tm.escalations == ts.escalations
    assert tm._strong_steps_left == ts._strong_steps_left
    assert [h["poisson_iters"] for h in h_m] == [h["poisson_iters"]
                                                 for h in h_1]
    _hold(out_m, (out_1,), "run")
    tc = _port()
    tc.prepare_sharded(_tmesh(2, 4))
    s = shard_state(_seeded(tc, _models()[1])[0], tc.geo, tc._mesh.mesh)
    a = s
    for _ in range(2):
        a, _ = tc.step(a, DT)
    b, rows, _ = tc.multi_step(s, DT, 2)
    assert rows.shape[0] == 2
    for x, y in zip((a.u, a.p, a.T) + a.u_faces, (b.u, b.p, b.T) + b.u_faces):
        assert torch.equal(unshard_field(x), unshard_field(y))


def test_mimetic_mesh_bf16_matches_one_device():
    """A bfloat16 mimetic step on the 2 x 2 mesh (float32 on the widened
    shards, the state rounded once, as one device's ``_in_float32``)
    against the single-device bfloat16 step: bfloat16 fields within 2^-7
    of each field's scale, equal CG iterations, time float32."""
    tm, ts = _port(dtype="bfloat16"), _port(dtype="bfloat16")
    tm.prepare_sharded(_tmesh(2, 2))
    s1, _ = _seeded(ts, _models()[1])
    sm, dm = tm.step(shard_state(s1, tm.geo, tm._mesh.mesh), DT)
    s1, d1 = ts.step(s1, DT)
    g = unshard_state(sm)
    assert sm.time == float(np.float32(sm.time))
    np.testing.assert_array_equal(_np(dm.packed)[[5, 6, 11]],
                                  _np(d1.packed)[[5, 6, 11]])
    for x, y in zip((g.u, g.p, g.T) + tuple(g.u_faces),
                    (s1.u, s1.p, s1.T) + tuple(s1.u_faces)):
        assert x.dtype == torch.bfloat16
        scale = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= 2 ** -7 * scale
