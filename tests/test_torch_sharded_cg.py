"""The Krylov solves, the escalation and the plain path on the port's
mesh (``prepare_sharded``) against the JAX package and the port's single
device, on a shell of 8 x 8 x 16 in f64; the port's shards on the CPU,
where its wrappers take the kernels' plain versions:

  * the one CG loop (solvers/cg.py) on Sharded vectors with the mesh's
    fixed-order inner product, against the single-device CG and the JAX
    ``solvers/cg.py`` on the Poisson operator: equal iteration counts on a
    right-hand side whose JAX count does not move when its sums are
    reordered, the iterates to round-off and to the exact solution; the
    sharded momentum (the pole-flipped components), temperature and
    Poisson operators and K3's plain version against one device's;
  * ``step_strong`` and ``temperature_step_strong`` on (2, 4) against the
    JAX model's and the port's single-device ones (u, T rtol 1e-8 / atol
    1e-10, p 1e-7 / 1e-9, equal CG counts); the escalation in ``run`` and
    ``multi_step``'s chunk redo with the escalation count, the window left
    and the state of one device; ``step_verbose``'s trails;
  * the all-CG configuration, Richardson momentum beside CG temperature
    and `poisson solver = cg` against JAX; ``kernels=False`` against the
    JAX ``prepare_sharded(mesh, pallas=False)`` step on its 8 virtual
    devices; a bfloat16 escalated mesh step within the bfloat16 bound.

The JAX models and their compiled steps are shared through a
module-scoped fixture.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dycoreplanet_tpu.models.boussinesq import State as JState
from dycoreplanet_tpu.ops import stencil as jst
from dycoreplanet_tpu.parallel.mesh import (
    build_mesh as j_build_mesh, shard_state as j_shard_state,
    state_sharding)
from dycoreplanet_tpu_torch.models.convert import (
    sharded_state_from_numpy, state_from_numpy)
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.projection import faces_div_plain
from dycoreplanet_tpu_torch.parallel.mesh import (
    Mesh, shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.solvers.cg import cg
from tests.test_torch_sharded import MESHES, SHAPE, _models, _np, _seed_state

J_CG = importlib.import_module("dycoreplanet_tpu.solvers.cg")

U_TOL = dict(rtol=1e-8, atol=1e-10)
P_TOL = dict(rtol=1e-7, atol=1e-9)
DT = 0.01

CONFIGS = {
    "default": {},
    "all_cg": {"numerics.fixed_solver_iters": 0},
    "rich_u_cg_T": {"numerics.fixed_solver_iters": 0,
                    "numerics.momentum_fixed_iters": 2},
    "poisson_cg": {"numerics.poisson_solver": "cg"},
}


def _sharded(model, state):
    """A global state cut onto the model's mesh."""
    return shard_state(state, model.geo, model._mesh.mesh)


def _tmesh(A, B):
    return Mesh(np.array([["cpu"] * B] * A, dtype=object), ("lat", "lon"))


def _close(got, want, what, tol=U_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), err_msg=what,
                               **tol)


def _hold_state(got, wants):
    """A sharded state against global ones (JAX State or port State)."""
    g = unshard_state(got)
    for want in wants:
        _close(g.u, want.u, "u")
        _close(g.T, want.T, "T")
        _close(g.p, want.p, "p", P_TOL)
        for d in range(3):
            _close(g.u_faces[d], want.u_faces[d], f"faces{d}")


@pytest.fixture(scope="module")
def seeded():
    """The seeded state of tests/test_torch_sharded.py as numpy."""
    _, tm = _models()
    return _seed_state(tm)[:4]


def _jstate(u, faces, pres, T):
    return JState(u=jnp.asarray(u), u_faces=tuple(jnp.asarray(f)
                                                  for f in faces),
                  p=jnp.asarray(pres), T=jnp.asarray(T),
                  time=jnp.asarray(0.0, jnp.float64),
                  step_number=jnp.asarray(0))


# ----------------------------------------------------------------------
def _reversed_dot(a, b):
    """The JAX CG's dot product with its terms summed in reverse order."""
    acc = jnp.promote_types(a.dtype, jnp.float32)
    return jnp.sum(jnp.flip((a.astype(acc) * b.astype(acc)).reshape(-1)))


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_cg_matches_single_device_and_jax(mesh_shape, monkeypatch):
    """Jacobi-CG on the Poisson operator -L (the `poisson solver = cg`
    solve) from a seeded mean-free x_true: the sharded CG (one loop, the
    mesh's inner product) and the single-device CG take the iteration
    count of the JAX cg, which is the same with its dot products summed
    in either order; the two port iterates agree to 1e-12 of their scale
    and all three solutions are within 1e-6 of x_true (rtol 1e-8 on an
    operator of condition ~1e3)."""
    jm, tm = _models()
    tm.prepare_sharded(_tmesh(*mesh_shape))
    ops = tm._mesh.ops
    x_true = np.random.default_rng(7).standard_normal(SHAPE)
    x_true -= x_true.mean()
    b = -st.weak_laplacian(tm.geo, torch.as_tensor(x_true), tm.p_specs)
    kw = dict(rtol=1e-8, maxiter=500)
    one = cg(lambda x: -st.weak_laplacian(tm.geo, x, tm.p_specs), b,
             preconditioner=lambda r: r / tm._poisson_diag_t, **kw)
    bs = shard_field(b, ops.mesh)
    sh = cg(lambda x: -ops.weak_laplacian(x, tm.p_specs), bs,
            preconditioner=lambda r: r / ops.poisson_diag, dot=ops.dot,
            **kw)
    counts = set()
    jb = jnp.asarray(_np(b))
    for dot in (None, _reversed_dot):
        with monkeypatch.context() as mp:
            if dot is not None:
                mp.setattr(J_CG, "_dot", dot)
            jres = J_CG.cg(
                lambda x: -jst.weak_laplacian(jm.geo, x, jm.p_specs), jb,
                preconditioner=lambda r: r / jm.poisson_diag, **kw)
        counts.add(int(jres.iterations))
    assert len(counts) == 1, ("JAX counts by order", counts)
    assert sh.iterations == one.iterations == counts.pop() > 10
    x_sh = _np(unshard_field(sh.x))
    scale = np.abs(_np(one.x)).max()
    assert np.abs(x_sh - _np(one.x)).max() <= 1e-12 * scale
    for sol in (x_sh, _np(one.x), np.asarray(jres.x)):
        sol = sol - sol.mean()
        np.testing.assert_allclose(sol, x_true, rtol=0, atol=1e-6)
    assert bool(sh.converged) and bool(one.converged)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_operators_match_one_device(mesh_shape):
    """The plain solves' operators on the shards against one device's, to
    1e-12 of their scale: the momentum weak Laplacian of each component
    (the tangential components cross the pole sign-flipped: padded with
    sign 1 the lat component would miss here), the temperature and
    Poisson weak Laplacians, and K3's plain version (the faces, the pole
    face 0, and the Poisson right-hand side less its mean)."""
    _, tm = _models()
    tm.prepare_sharded(_tmesh(*mesh_shape))
    ops = tm._mesh.ops
    rng = np.random.default_rng(11)
    u = torch.as_tensor(rng.standard_normal((3,) + SHAPE))
    x = torch.as_tensor(rng.standard_normal(SHAPE))
    t = lambda a: shard_field(a, ops.mesh)  # noqa: E731

    def hold(got, want, what):
        got, want = _np(unshard_field(got)), _np(want)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), what

    hold(ops.vector_laplacian(t(u), tm.u_specs),
         tm._grid_ops.vector_laplacian(u, tm.u_specs), "momentum")
    for name, specs in (("T", tm.T_specs_hom), ("p", tm.p_specs)):
        hold(ops.weak_laplacian(t(x), specs),
             st.weak_laplacian(tm.geo, x, specs), name)
    faces, rhs = ops.faces_div(tm.u_specs, t(u), DT)
    *want_faces, rhs_raw, total = faces_div_plain(tm.geo, tm.u_specs, u, DT)
    for d in range(3):
        hold(faces[d], want_faces[d], f"faces{d}")
    assert float(unshard_field(faces[1])[:, 0].abs().max()) == 0.0
    hold(rhs, rhs_raw - total / tm.geo.n_cells, "rhs_phi")


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_strong(seeded):
    """Two JAX step_strong steps and a temperature_step_strong from the
    seeded state (default configuration)."""
    jm, _ = _models()
    js = _jstate(*seeded)
    out = []
    for _ in range(2):
        js, jd = jm.step_strong(js, DT)
        out.append((js, np.asarray(jd.packed)))
    jt, jtd = jm.temperature_step_strong(_jstate(*seeded), DT)
    return out, (jt, np.asarray(jtd.packed))


def test_step_strong_on_the_mesh_matches_jax_and_one_device(seeded,
                                                            jax_strong):
    """Two step_strong steps on (2, 4) (K2o, then momentum Jacobi-CG, K3's
    plain version, the Poisson CG preconditioned by the sharded fast
    solve, temperature Jacobi-CG on the shards) against the JAX model's
    step_strong and the port's single-device one: u, T, the faces rtol
    1e-8 / atol 1e-10, p 1e-7 / 1e-9, equal CG counts, cfl, max|u| and
    the T range within 1e-6 (a converged CG's residual is round-off, not
    compared). Then temperature_step_strong the same way."""
    _, tm = _models()
    _, ts = _models()
    tm.prepare_sharded(_tmesh(2, 4))
    s_m = sharded_state_from_numpy(tm, *seeded)
    s_1 = state_from_numpy(ts, *seeded)
    steps, (jt, jtd) = jax_strong
    for js, jpacked in steps:
        s_m, d_m = tm.step_strong(s_m, DT)
        s_1, d_1 = ts.step_strong(s_1, DT)
        _hold_state(s_m, (js, s_1))
        for ref in (jpacked, _np(d_1.packed)):
            np.testing.assert_array_equal(_np(d_m.packed)[[5, 6, 10, 11]],
                                          np.asarray(ref)[[5, 6, 10, 11]])
            np.testing.assert_allclose(_np(d_m.packed)[[0, 1, 2, 3]],
                                       np.asarray(ref)[[0, 1, 2, 3]],
                                       rtol=1e-6)
        assert d_m.poisson_iters > 0 and d_m.helmholtz_iters[0] > 0
        assert d_m.solver_ok and d_m.div_norm <= 1e-9
    t_m, dt_m = tm.temperature_step_strong(
        sharded_state_from_numpy(tm, *seeded), DT)
    t_1, dt_1 = ts.temperature_step_strong(state_from_numpy(ts, *seeded),
                                           DT)
    for want in (jt.T, t_1.T):
        _close(unshard_field(t_m.T), want, "T")
    assert dt_m.temperature_iters == dt_1.temperature_iters == int(jtd[6])


def test_escalation_in_run_and_multi_step_on_the_mesh():
    """With `helmholtz tol` beyond the Richardson sweeps' reach every fast
    step misses: run on the mesh escalates (the redo, the window counting
    down), and so does a multi_step chunk (redone with full CG from its
    first state), each with the escalation count, the window left and the
    state of the same calls on one device."""
    over = {"numerics.helmholtz_tol": 1e-300}
    (_, tm), (_, ts) = _models(**over), _models(**over)
    tm.prepare_sharded(_tmesh(2, 4))
    s_m, h_m = tm.run(max_steps=3)
    s_1, h_1 = ts.run(max_steps=3)
    assert tm.escalations == ts.escalations == 1
    assert tm._strong_steps_left == ts._strong_steps_left == 6
    for a, b in zip(h_m, h_1):
        assert a["poisson_iters"] == b["poisson_iters"] > 0
    _hold_state(s_m, (s_1,))
    (_, tm), (_, ts) = _models(**over), _models(**over)
    tm.prepare_sharded(_tmesh(2, 4))
    s0, dt = ts.initial_state(), float(ts.params.time_step)
    with pytest.warns(RuntimeWarning, match="retrying chunk"):
        c_m, rows_m, _ = tm.multi_step(_sharded(tm, s0), dt, 2)
    with pytest.warns(RuntimeWarning, match="retrying chunk"):
        c_1, rows_1, _ = ts.multi_step(s0, dt, 2)
    assert tm.escalations == ts.escalations == 1
    assert tm._strong_steps_left == ts._strong_steps_left == 6
    np.testing.assert_array_equal(_np(rows_m)[:, [5, 6, 10, 11]],
                                  _np(rows_1)[:, [5, 6, 10, 11]])
    _hold_state(c_m, (c_1,))


def test_step_verbose_trails_on_the_mesh(seeded):
    """step_verbose on the mesh takes the unfused branch (the Richardson
    sweeps on the shards, K2o still) and returns the trails of one device:
    the same solvers, each trail within 1e-8 (NaN where one device's
    is)."""
    _, tm = _models()
    _, ts = _models()
    tm.prepare_sharded(_tmesh(2, 4))
    s_m, d_m, h_m = tm.step_verbose(sharded_state_from_numpy(tm, *seeded),
                                    DT)
    s_1, d_1, h_1 = ts.step_verbose(state_from_numpy(ts, *seeded), DT)
    assert set(h_m) == set(h_1) == {"helmholtz richardson",
                                    "temperature richardson"}
    for name in h_1:
        np.testing.assert_allclose(h_m[name], h_1[name], rtol=1e-8,
                                   atol=1e-20, err_msg=name)
    _hold_state(s_m, (s_1,))
    assert tm.kernels()["forcing_operands"].launches == 0   # the CPU


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_steps(seeded):
    """Two JAX steps of each configuration from the seeded state."""
    out = {}
    for name in ("all_cg", "rich_u_cg_T", "poisson_cg"):
        jm, _ = _models(**CONFIGS[name])
        js = _jstate(*seeded)
        rows = []
        for _ in range(2):
            js, jd = jm.step(js, DT)
            rows.append((js, np.asarray(jd.packed)))
        out[name] = rows
    return out


@pytest.mark.parametrize("name", ["all_cg", "rich_u_cg_T", "poisson_cg"])
def test_plain_configurations_match_jax(name, seeded, jax_steps):
    """The configurations K1o does not run on the mesh (2, 4): `fixed
    solver iters` = 0 (momentum and temperature Jacobi-CG), Richardson
    momentum beside CG temperature, and `poisson solver = cg` (the
    Jacobi-CG Poisson solve, K1o beside it): two steps against the JAX
    model's, equal iteration counts, the fields as in step_strong's
    test."""
    _, tm = _models(**CONFIGS[name])
    tm.prepare_sharded(_tmesh(2, 4))
    report = tm.sharded_kernels()
    assert report["richardson"] == ("pallas-sharded" if name == "poisson_cg"
                                    else "jnp")
    assert report["poisson"] == ("jacobi-cg" if name == "poisson_cg"
                                 else "ShardedShellPoissonFastDiag")
    s_m = sharded_state_from_numpy(tm, *seeded)
    for js, jpacked in jax_steps[name]:
        s_m, d_m = tm.step(s_m, DT)
        _hold_state(s_m, (js,))
        np.testing.assert_array_equal(_np(d_m.packed)[[5, 6, 10, 11]],
                                      jpacked[[5, 6, 10, 11]])
        # the Jacobi-CG Poisson solve stops at `poisson tol`
        assert d_m.solver_ok and d_m.div_norm <= (
            1e-6 if name == "poisson_cg" else 1e-9)


def test_kernels_false_matches_jax_pallas_false(seeded):
    """prepare_sharded(mesh, kernels=False) against the JAX
    prepare_sharded(mesh, pallas=False) step on the same 2 x 4 mesh (its
    8 virtual devices, GSPMD's plain path), as tests/test_collectives.py
    holds that step: two steps, the fields as in step_strong's test, the
    report every stage "jnp" as the JAX report; the same state as the
    kernel path's to round-off."""
    jm, tm = _models()
    _, tk = _models()
    jmesh = j_build_mesh(jm.geo)
    jm.prepare_sharded(jmesh, pallas=False)
    tm.prepare_sharded(_tmesh(2, 4), kernels=False)
    tk.prepare_sharded(_tmesh(2, 4))
    assert tm.sharded_kernels() == jm.sharded_kernels() == {
        "forcing": "jnp", "richardson": "jnp",
        "poisson": "ShardedShellPoissonFastDiag"}
    sh = state_sharding(jm.geo, jmesh)
    rep = NamedSharding(jmesh, P())
    jstep = jax.jit(jm._step_impl, in_shardings=(sh, rep),
                    out_shardings=(sh, rep))
    js = j_shard_state(_jstate(*seeded), jm.geo, jmesh)
    s_m = sharded_state_from_numpy(tm, *seeded)
    s_k = sharded_state_from_numpy(tk, *seeded)
    for _ in range(2):
        js, jpacked = jstep(js, jnp.float64(DT))
        s_m, d_m = tm.step(s_m, DT)
        s_k, _ = tk.step(s_k, DT)
        _hold_state(s_m, (js, unshard_state(s_k)))
        np.testing.assert_array_equal(_np(d_m.packed)[[5, 6, 10, 11]],
                                      np.asarray(jpacked)[[5, 6, 10, 11]])


def test_bf16_escalated_mesh_step():
    """One bfloat16 step_strong on a 2 x 2 mesh (the plain stages in
    float32 on the widened shards, the state rounded once, the solves at
    the bfloat16 clamp) from the single-device bfloat16 state: the
    fields bfloat16 and within the bound of
    tests/test_torch_bf16.py's mesh test (2^-7 of each field's scale) of
    the single-device bfloat16 step_strong, equal CG counts; time
    float32."""
    from tests.test_torch_bf16 import TOL, _config
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    p = _config("shell_bench")
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 16, 32
    one = BoussinesqModel(p, device="cpu")
    mm = BoussinesqModel(p, device="cpu").prepare_sharded(_tmesh(2, 2))
    s0, _ = one.run(max_steps=2)
    dt = float(p.time_step)
    got, d = mm.step_strong(_sharded(mm, s0), dt)
    want, d1 = one.step_strong(s0, dt)
    g = unshard_state(got)
    assert got.time == float(np.float32(got.time))
    assert d.poisson_iters == d1.poisson_iters > 0 and d.solver_ok
    assert d.temperature_iters == d1.temperature_iters
    for x, y in zip((g.u, g.p, g.T) + tuple(g.u_faces),
                    (want.u, want.p, want.T) + tuple(want.u_faces)):
        assert x.dtype == torch.bfloat16
        scale = float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= TOL * scale
