"""The direct Helmholtz solves and the stretched shell's spectral CG on the
port's mesh (``prepare_sharded``), in f64 on the CPU (the shards take
the plain versions there):

  * each sharded Helmholtz solver (solvers/helmholtz.py) and the sharded
    spectral CG (solvers/spectral.py ``ShardedShellPoissonSpectral``)
    against its one-device solver and the JAX solver on one seeded
    right-hand side, within 1e-12 of the solution's scale, the CG with
    the count of both; K4 once a solve (once an iteration and once more
    for the CG), on one device's layout, nothing copied;
  * 3 direct mesh steps of the shell (2 x 2), the annulus (8 phi shards)
    and the box (2 x 2), and 2 steps of the stretched shell (2 x 2),
    against the JAX single-device step at tests/test_sharding.py's
    bounds (u, T rtol 1e-9; p 1e-7) and the port's one device, with
    equal counts and K4 launches a step;
  * the direct temperature solve on the shards beside the coupled and
    the mimetic momentum, in temperature substeps, under escalation; one
    bfloat16 direct step on the annulus mesh.

The stretched shell's CG count moves by one with the order of the sums
(of the lon DFT, of the inner products) on many right-hand sides
(ROADMAP.md Queue 3, the knife edge): at the model's default `poisson
tol` 1e-8 its second step takes 39 iterations on one device and 38 on
the 2 x 2 mesh, and of `poisson tol` 1e-9, 3e-10, 2e-10, 5e-11, 3e-11,
2e-11 and 1e-12 only the last two give the JAX single device, the
port's one device and its 2 x 2 and 2 x 4 meshes one count at both
steps. Its tests run at 1e-12; the solver test takes
tests/test_torch_spectral_direct.py's order-free right-hand side.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.grid import geometry as j_geometry
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel, make_model
from dycoreplanet_tpu_torch.models.presets import stretched_shell
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, shard_field, shard_state, unshard_field, unshard_state)
from dycoreplanet_tpu_torch.solvers import spectral as t_spectral
from dycoreplanet_tpu_torch.solvers.helmholtz import (
    make_sharded_helmholtz_solver)
from tests.test_torch_kernels import _configure
from tests.test_torch_sharded_annulus import (
    DT, N_STEPS, counts, hold, jax_model, port_model)

SHELL = (8, 8, 16)
STRETCHED = (8, 16, 32)
# shards of each case's mesh (build_mesh of that many devices)
SHARDS = {"shell": 4, "annulus": 8, "box": 4, "stretched": 4}
STEPS = {"shell": N_STEPS, "annulus": N_STEPS, "box": N_STEPS,
         "stretched": 2}
# the stretched shell's `poisson tol`: no count of its two steps moves
# with the order of the sums (the module docstring)
STRETCHED_TOL = 1e-12
SOLVE_TOL = 1e-12


def _shell_params(cls, **numerics):
    p = _configure(cls.from_text(""), "float64", SHELL)
    for k, v in numerics.items():
        setattr(p if hasattr(p, k) else p.numerics, k, v)
    return p


def _stretched_params(cls):
    p = cls.from_text("")
    p.space_dimension = 3
    p.numerics.dtype = "float64"
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = STRETCHED
    p.numerics.poisson_tol = STRETCHED_TOL
    p.time_step = DT
    return p


def make(kind, jax=False, **numerics):
    """The case's model: the JAX single device, or the port's on the
    CPU."""
    if kind == "stretched":
        if jax:
            return JModel(_stretched_params(JParameters),
                          geometry=stretched_shell(
                              STRETCHED, factory=j_factory,
                              geometry=j_geometry))
        return BoussinesqModel(_stretched_params(Parameters),
                               geometry=stretched_shell(STRETCHED),
                               device="cpu")
    numerics = dict(numerics, helmholtz_solver="direct")
    if kind == "shell":
        if jax:
            return JModel(_shell_params(JParameters, **numerics))
        return make_model(_shell_params(Parameters, **numerics),
                          device="cpu")
    return (jax_model if jax else port_model)(kind, **numerics)


def on_mesh(model, kind):
    return model.prepare_sharded(build_mesh(model.geo,
                                            ["cpu"] * SHARDS[kind]))


def spy_k4(model):
    """The operands of every K4 call of the model's wrapper."""
    calls = []
    tk = model._tridiag
    tk.plain = lambda *ops: calls.append(ops) or k4.thomas_solve(*ops)
    return calls


_RUNS = {}


def runs(kind):
    """The case's steps from its initial state: the JAX single device's,
    the port's one device's and its mesh's (each a list of (state,
    diagnostics)), K4 calls a step on one device and on the mesh, and the
    two port models (made once a case)."""
    if kind not in _RUNS:
        jm = make(kind, jax=True)
        one, m = make(kind), on_mesh(make(kind), kind)
        calls1, callsm = spy_k4(one), spy_k4(m)
        sj, s1 = jm.initial_state(), one.initial_state()
        sm = shard_state(s1, m.geo, m._mesh.mesh)
        out = dict(jax=[], one=[], mesh=[], k4_one=[], k4_mesh=[], m=m,
                   one_model=one, jm=jm)
        for _ in range(STEPS[kind]):
            sj, dj = jm.step(sj, DT)
            n1, nm = len(calls1), len(callsm)
            s1, d1 = one.step(s1, DT)
            sm, dm = m.step(sm, DT)
            out["jax"].append((sj, dj))
            out["one"].append((s1, d1))
            out["mesh"].append((sm, dm))
            out["k4_one"].append(len(calls1) - n1)
            out["k4_mesh"].append(len(callsm) - nm)
        out["copied"] = [k4.layout(*ops).copied for ops in callsm]
        _RUNS[kind] = out
    return _RUNS[kind]


# ------------------------------------------------------------- the steps
@pytest.mark.parametrize("kind", ["shell", "annulus", "box", "stretched"])
def test_direct_mesh_steps_match_jax_and_one_device(kind):
    """The mesh's steps against the JAX single device at every step and
    the port's one device: the states within the sharding bounds, the
    counts equal, max|div u| round-off; K4 a step as on one device (2:
    momentum and temperature on the shell and the annulus; 0 on the box,
    whose direct solves are matrix products; the spectral CG's
    iterations + 1 on the stretched shell), on one device's layout,
    nothing copied."""
    r = runs(kind)
    for (sm, dm), (s1, d1), (sj, dj) in zip(r["mesh"], r["one"], r["jax"]):
        hold(sm, sj)
        hold(sm, s1)
        assert counts(dm) == counts(d1) == counts(dj)
        assert dm.div_norm < 1e-6
    assert r["k4_mesh"] == r["k4_one"]
    want = {"shell": 2, "annulus": 2, "box": 0}.get(kind)
    if want is None:
        want = [d.poisson_iters + 1 for _, d in r["mesh"]]
        assert min(want) > 1
    else:
        want = [want] * STEPS[kind]
    assert r["k4_mesh"] == want
    assert all(c == () for c in r["copied"])
    m = r["m"]
    assert m.sharded_kernels()["poisson"] == {
        "shell": "ShardedShellPoissonFastDiag",
        "annulus": "ShardedAnnulusPoissonFastDiag",
        "box": "ShardedCuboidPoissonFastDiag",
        "stretched": "ShardedShellPoissonSpectral"}[kind]
    if kind == "stretched":
        assert m._mesh.helmholtz is None and m._mesh.poisson.iterative
    else:
        name = {"shell": "Shell", "annulus": "Annulus", "box": "Cuboid"}
        assert type(m._mesh.helmholtz).__name__ == \
            type(m._mesh.temperature).__name__ == \
            f"Sharded{name[kind]}HelmholtzDirect"


# ------------------------------------------------------------- the solves
def _solvers(kind, which):
    """(the port's one-device solver, its sharded form, the JAX solver,
    the mesh)."""
    r = runs(kind)
    one, m, jm = r["one_model"], r["m"], r["jm"]
    attr = {"u": "helmholtz_direct", "T": "temperature_direct",
            "p": "poisson_spectral"}[which]
    mesh = m._mesh.mesh
    base = getattr(one, attr)
    if which == "p":
        return (base, t_spectral.make_sharded_poisson_solver(base, mesh),
                getattr(jm, attr), mesh)
    return (base, make_sharded_helmholtz_solver(base, mesh),
            getattr(jm, attr), mesh)


def _close(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= SOLVE_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("kind,which", [
    ("shell", "u"), ("shell", "T"), ("annulus", "u"), ("annulus", "T"),
    ("box", "u"), ("box", "T")])
def test_sharded_helmholtz_matches_one_device_and_jax(kind, which):
    """A sharded direct Helmholtz solve of a seeded stack of right-hand
    sides (the solver's fields: 3 or 2 velocity components, or T) at the
    step's coefficient against the port's one-device solve and the JAX
    solve: within 1e-12 of the solution's scale; K4 once (none on the
    box), nothing copied."""
    one, sharded, jsolve, mesh = _solvers(kind, which)
    n_c = {"u": one.geo.dim, "T": 1}[which]
    b = np.random.default_rng(11).standard_normal(
        (n_c,) + one.geo.cell_shape)
    c = 0.37
    calls = []
    if kind != "box":
        sharded.tridiag = (lambda *ops: calls.append(ops)
                           or k4.thomas_solve(*ops))
    got = unshard_field(sharded.solve(shard_field(torch.as_tensor(b), mesh),
                                      c)).numpy()
    _close(got, one.solve(torch.as_tensor(b), c).numpy(), "one device")
    _close(got, np.asarray(jsolve.solve(jnp.asarray(b), c)), "JAX")
    assert len(calls) == (0 if kind == "box" else 1)
    assert all(k4.layout(*ops).copied == () for ops in calls)


def test_sharded_spectral_cg_matches_one_device_and_jax():
    """The sharded spectral CG on tests/test_torch_spectral_direct.py's
    order-free right-hand side (the CPU generator's seed 19, rtol 1e-11):
    the count of the port's one device and of JAX, the solution within
    1e-12 of theirs (mean-free); K4 the iterations + 1, on the base's
    layout, nothing copied; ``iterative``, ``rtol``, ``maxiter`` and
    ``precision`` the base's; as a preconditioner its solution."""
    geo = stretched_shell(STRETCHED)
    jgeo = stretched_shell(STRETCHED, factory=j_factory,
                           geometry=j_geometry)
    from dycoreplanet_tpu.solvers import spectral as j_spectral
    one = t_spectral.ShellPoissonSpectral(geo, dtype=np.float64,
                                          rtol=1e-11, maxiter=300)
    js = j_spectral.ShellPoissonSpectral(jgeo, dtype=jnp.float64,
                                         rtol=1e-11, maxiter=300)
    mesh = build_mesh(geo, ["cpu"] * 4)
    sharded = t_spectral.make_sharded_poisson_solver(one, mesh)
    assert (sharded.iterative, sharded.rtol, sharded.maxiter,
            sharded.precision) == (True, 1e-11, 300, "highest")
    gen = torch.Generator().manual_seed(19)
    b = torch.randn(geo.cell_shape, generator=gen, dtype=torch.float64)
    b = b - b.mean()
    calls = []
    one.tridiag.plain = (lambda *ops: calls.append(ops)
                         or k4.thomas_solve(*ops))
    bs = shard_field(b, mesh)
    x, its = sharded.solve(bs)
    x = unshard_field(x).numpy()
    x1, its1 = one.solve(b)
    xj, itj = js.solve(jnp.asarray(b.numpy()))
    assert its == its1 == int(itj) > 0
    mf = lambda a: np.asarray(a) - np.asarray(a).mean()  # noqa: E731
    _close(mf(x), mf(x1.numpy()), "one device")
    _close(mf(x), mf(xj), "JAX")
    n_mesh = len(calls) - (its1 + 1)
    assert n_mesh == its + 1
    assert all(k4.layout(*ops).copied == () for ops in calls)
    np.testing.assert_array_equal(unshard_field(sharded(bs)).numpy(), x)


# ------------------------------------------------- the rest of the paths
def _pair(make_one, n_shards, n_steps, dt=DT, strong=False):
    """``n_steps`` steps (``step_strong`` with ``strong``) of the port's
    one device and of its mesh from the same initial state, held to each
    other at the sharding bounds with equal counts."""
    one, m = make_one(), make_one()
    m.prepare_sharded(build_mesh(m.geo, ["cpu"] * n_shards))
    s1 = one.initial_state()
    sm = shard_state(s1, m.geo, m._mesh.mesh)
    for _ in range(n_steps):
        s1, d1 = (one.step_strong if strong else one.step)(s1, dt)
        sm, dm = (m.step_strong if strong else m.step)(sm, dt)
        hold(sm, s1)
        assert counts(dm) == counts(d1)
        assert dm.solver_ok == d1.solver_ok
    return m, dm


@pytest.mark.parametrize("case", ["coupled", "mimetic", "nse2"])
def test_direct_temperature_on_the_mesh(case):
    """The sharded direct temperature solve beside the coupled 2 x 2
    FGMRES momentum, beside the mimetic model's CG momentum, and in the
    temperature substeps of `NSE solver interval` = 2 (a step and a
    substep), on the shell's 2 x 2 mesh against one device."""
    numerics = {"coupled": dict(momentum_solver="coupled",
                                use_schur_complement_solver=False),
                "mimetic": dict(use_FEEC_solver=True,
                                feec_formulation="staggered"),
                "nse2": dict(NSE_solver_interval=2)}[case]
    m, d = _pair(lambda: make("shell", **numerics), 4, 2)
    assert d.temperature_iters == -1
    assert type(m._mesh.temperature).__name__ == \
        "ShardedShellHelmholtzDirect"
    if case == "mimetic":
        assert type(m).__name__ == "MimeticBoussinesqModel"


@pytest.mark.parametrize("kind", ["shell", "stretched"])
def test_escalated_steps_on_the_mesh(kind):
    """step_strong on the mesh as on one device: with `helmholtz solver =
    direct` the direct solves are kept (helmholtz and temperature counts
    -1) and the Poisson CG is preconditioned by the sharded fast solve;
    on the stretched shell the Poisson CG is preconditioned by the
    sharded spectral CG (its __call__)."""
    _, d = _pair(lambda: make(kind), SHARDS[kind], 1, strong=True)
    assert d.poisson_iters > 0
    if kind == "shell":
        assert d.temperature_iters == -1
        assert list(d.helmholtz_iters) == [-1] * 3


def test_bf16_direct_annulus_mesh_step():
    """One bfloat16 direct step of the annulus mesh (8 phi shards) within
    a bfloat16 ulp (2^-7 of the field's scale) of one device's: the step
    runs no hand kernel but K4, so both compute in float32 and round
    once."""
    one = make("annulus", dtype="bfloat16")
    m = on_mesh(make("annulus", dtype="bfloat16"), "annulus")
    s1 = one.initial_state()
    sm, _ = m.step(shard_state(s1, m.geo, m._mesh.mesh), DT)
    s1, _ = one.step(s1, DT)
    g = unshard_state(sm)
    for name in ("u", "p", "T"):
        a, b = getattr(g, name), getattr(s1, name)
        assert a.dtype == torch.bfloat16
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= \
            2.0 ** -7 * scale, name
