"""``poisson solver = mg | cg`` in the PyTorch port against the JAX
package, on the CPU in float64, from the same numpy-seeded inputs:

  * ``PoissonMultigrid``: the hierarchy's shapes, the smoother and the
    chosen line axes, and one V-cycle on a seeded residual (the shell at
    8 x 16 x 32, also relaxing along the pole-closed lat axis alone, the
    annulus at 16 x 96, the box at 16^3: line smoother with the periodic
    Sherman-Morrison line, and Jacobi), within 1e-12;
    each level's line solve on both kinds of axis; the V-cycle symmetric
    (a CG preconditioner); its line solves counted by K4's wrapper (0
    launches on the CPU: the plain ``thomas_solve``) and K4's description
    of the line operands (nothing copied, the residual read through its
    moved-axis view, the Sherman-Morrison pair as a batch axis);
  * the model with ``poisson solver = cg`` and ``= mg``: three steps of
    the standard personality on the shell, the annulus and the box, and
    of the mimetic one on the shell, against the JAX model: fields within
    1e-12 of their scale (p 1e-11), equal Poisson iteration counts; the
    coupled solve's Poisson inverse by CG; no CUDA graph for these
    chunks; the 2D slab refusing mg as the JAX package fails on it."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.models import make_model as j_make_model
from dycoreplanet_tpu.ops.bc import BC as JBC, BCSpec as JSpec
from dycoreplanet_tpu.solvers.multigrid import PoissonMultigrid as JMG
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import make_model
from dycoreplanet_tpu_torch.models.convert import state_from_numpy
from dycoreplanet_tpu_torch.ops import tridiag as k4
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.solvers.multigrid import PoissonMultigrid

OP_TOL = 1e-12
STEP_TOL = 1e-12
P_TOL = 1e-11      # as tests/test_torch_mimetic.py: p's zero-mean round-off
DT = 0.005

_SHELL = lambda f: f.make_shell(8, 16, 32, 1.0, 2.0)   # noqa: E731
# (geometry, PoissonMultigrid options): "shell_lat" relaxes along the
# pole-closed lat axis only, whose residual K4 reads through a moved view
MG_GEOS = {
    "shell": (_SHELL, {}),
    "shell_lat": (_SHELL, dict(line_axes_allowed=(1,))),
    "annulus": (lambda f: f.make_annulus(16, 96, 1.0, 2.0), {}),
    "box": (lambda f: f.make_cuboid(16, 16, 16), {}),
}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol, what):
    want, got = np.asarray(want), _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _p_specs(geo, spec, bc):
    """The pressure rules: Neumann walls, the poles' half-turn, periodic
    elsewhere (the models' p_specs)."""
    out = [spec(bc.NEUMANN, bc.NEUMANN)] + [None] * (geo.dim - 1)
    if geo.kind == "shell":
        out[1] = spec(bc.POLE, bc.POLE)
    return out


_MG = {}


def _mg_pair(name):
    if name not in _MG:
        mk, kw = MG_GEOS[name]
        tgeo, jgeo = mk(t_factory), mk(j_factory)
        tm = PoissonMultigrid(tgeo, _p_specs(tgeo, BCSpec, BC),
                              dtype=np.float64, **kw)
        jm = JMG(jgeo, _p_specs(jgeo, JSpec, JBC), dtype=np.float64, **kw)
        _MG[name] = (tm, jm)
    return _MG[name]


@pytest.mark.parametrize("name", list(MG_GEOS))
def test_hierarchy_matches_jax(name):
    tm, jm = _mg_pair(name)
    assert [g.cell_shape for g in tm.geos] == [g.cell_shape for g in jm.geos]
    assert len(tm.geos) >= 2
    assert tm.smoother == jm.smoother
    assert tm.line_axes == list(getattr(jm, "line_axes", []))
    for a, b in zip(tm.diags, jm.diags):
        _close(a, b, OP_TOL, "diag")
    for lt, lj in zip(tm.lines, getattr(jm, "lines", [])):
        for axis in lt:
            for x, y in zip(lt[axis], lj[axis]):
                assert (x is None) == (y is None)
                if x is not None:
                    _close(x, y, OP_TOL, f"line coefficients {axis}")


@pytest.mark.parametrize("name", list(MG_GEOS))
def test_vcycle_matches_jax(name):
    """One V-cycle on a seeded residual, against the JAX V-cycle (jitted
    as the JAX package's CG runs it)."""
    tm, jm = _mg_pair(name)
    r = np.random.default_rng(0).standard_normal(tm.geos[0].cell_shape)
    want = jax.jit(lambda x: jm(x))(jnp.asarray(r))
    got = tm(torch.as_tensor(r))
    _close(got, want, OP_TOL, f"{name} V-cycle")
    # the CPU runs K4's plain version: nothing launched
    assert tm.tridiag.launches == 0


@pytest.mark.parametrize("name", ["shell", "shell_lat", "annulus"])
def test_line_solves_match_jax(name):
    """Every level's line solve along each line axis (the annulus's
    periodic phi with the Sherman-Morrison 2-rhs form) against the JAX
    function, and an exact inverse of its tridiagonal block."""
    tm, jm = _mg_pair(name)
    rng = np.random.default_rng(1)
    for level, g in enumerate(tm.geos):
        r = rng.standard_normal(g.cell_shape)
        for axis in tm.line_axes:
            got = tm._line_solve(level, axis, torch.as_tensor(r))
            want = jm._line_solve(level, axis, jnp.asarray(r))
            _close(got, want, OP_TOL, f"{name} level {level} axis {axis}")


@pytest.mark.parametrize("name", list(MG_GEOS))
def test_vcycle_symmetric(name):
    """<y, M x> = <x, M y> to round-off: the palindromic smoothing keeps
    the V-cycle a symmetric (CG-admissible) preconditioner."""
    tm, _ = _mg_pair(name)
    rng = np.random.default_rng(2)
    x, y = (torch.as_tensor(rng.standard_normal(tm.geos[0].cell_shape))
            for _ in range(2))
    a, b = float(torch.sum(y * tm(x))), float(torch.sum(x * tm(y)))
    assert abs(a - b) <= 1e-12 * abs(a), (a, b)
    assert float(torch.sum(x * tm(x))) > 0.0


class _Recorder(k4.TridiagSolve):
    """K4's wrapper recording the operands of each solve."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __call__(self, lower, diag, upper, rhs):
        self.calls.append((lower, diag, upper, rhs))
        return super().__call__(lower, diag, upper, rhs)


@pytest.mark.parametrize("name", ["shell", "shell_lat", "annulus"])
def test_line_operands_as_k4_reads_them(name):
    """The line solves' operands as K4 describes them (ops/tridiag.py
    ``layout``): nothing copied; a wall/pole axis's residual read through
    its moved-axis view (not contiguous); a periodic axis's
    Sherman-Morrison pair as a batch axis of size 2 on axis 1, where the
    coefficients have stride 0. One V-cycle makes
    ``line_solves_per_cycle`` solves."""
    tm, _ = _mg_pair(name)
    rec = _Recorder()
    tm.tridiag, old = rec, tm.tridiag
    try:
        tm(torch.as_tensor(np.random.default_rng(3).standard_normal(
            tm.geos[0].cell_shape)))
    finally:
        tm.tridiag = old
    assert len(rec.calls) == tm.line_solves_per_cycle()
    assert rec.launches == 0 and rec.copies == 0
    kinds = set()
    for lower, diag, upper, rhs in rec.calls:
        lay = k4.layout(lower, diag, upper, rhs)
        assert lay.copied == ()
        assert lay.pair_axis is None and not lay.row_coefficients
        if lower.dim() == rhs.dim() and lower.shape[1] == 1:
            # the periodic 2-rhs form: [r, u] stacked on axis 1
            assert rhs.shape[1] == 2 and lower.expand(rhs.shape).stride(1) == 0
            kinds.add("pair")
        elif not rhs.is_contiguous():
            kinds.add("moved")
        else:
            kinds.add("contiguous")
    # the shell and the annulus relax along a periodic axis (the pair);
    # a wall/pole line axis other than 0 is read through its moved view
    assert ("pair" in kinds) == any(tm.specs[a] is None
                                    for a in tm.line_axes)
    assert ("moved" in kinds) == any(a != 0 and tm.specs[a] is not None
                                     for a in tm.line_axes)
    assert kinds


# ------------------------------------------------------------- the models
def _params(cls, kind, solver, mimetic=False):
    p = cls.from_text("")
    p.numerics.dtype = "float64"
    p.numerics.poisson_solver = solver
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 3.0
    p.time_step = DT
    p.space_dimension = 2 if kind == "annulus" else 3
    p.cuboid_geometry = kind == "box"
    if kind != "box":
        p.physical_constants.R0 = 1.0
        p.physical_constants.atm_height = 1.0
    if mimetic:
        p.use_FEEC_solver = True
        p.numerics.feec_formulation = "staggered"
    return p


MODEL_GEOS = {
    "shell": lambda f: f.make_shell(8, 16, 32, 1.0, 2.0),
    "annulus": lambda f: f.make_annulus(8, 48, 1.0, 2.0),
    "box": lambda f: f.make_cuboid(8, 8, 8),
}

MODEL_CASES = [(k, s) for k in MODEL_GEOS for s in ("cg", "mg")] + [
    ("shell", "mg-mimetic"), ("annulus", "cg-coupled")]


def _seed(tm, jm, seed=0, amp=0.05):
    rng = np.random.default_rng(seed)
    dim = tm.geo.dim
    u = amp * rng.standard_normal((dim,) + tm.geo.cell_shape)
    faces = [_np(f) for f in tm.interp_to_faces(torch.as_tensor(u))]
    ts = state_from_numpy(tm, u, faces, np.zeros(tm.geo.cell_shape),
                          tm.T_init)
    js = jm.initial_state()._replace(
        u=jnp.asarray(u), u_faces=tuple(jnp.asarray(f) for f in faces))
    return ts, js


@pytest.mark.parametrize("kind,solver", MODEL_CASES)
def test_model_poisson_solver_matches_jax(kind, solver):
    """Three steps with `poisson solver` = cg / mg in both packages:
    equal Poisson iteration counts and verdicts, the fields within
    round-off. ``mg-mimetic``: the mimetic step's projection through the
    MG-CG; ``cg-coupled``: the annulus's coupled 2x2 FGMRES, whose
    Poisson inverse is then a Jacobi-CG."""
    base, _, variant = solver.partition("-")
    mimetic = variant == "mimetic"
    tp, jp = (_params(P, kind, base, mimetic)
              for P in (Parameters, JParameters))
    if variant == "coupled":
        tp.numerics.momentum_solver = jp.numerics.momentum_solver = "coupled"
    tm = make_model(tp, MODEL_GEOS[kind](t_factory), device="cpu")
    jm = j_make_model(jp, MODEL_GEOS[kind](j_factory))
    assert tm.poisson_spectral is None
    assert (tm.poisson_precond is not None) == (base == "mg")
    ts, js = _seed(tm, jm)
    for k in range(3):
        ts, td = tm.step(ts, DT)
        js, jd = jm.step(js, DT)
        got, want = td.packed.numpy(), np.asarray(jd.packed)
        assert got[5] == want[5] and got[10] == want[10], (k, got, want)
        for f in ("u", "p", "T"):
            _close(getattr(ts, f), getattr(js, f),
                   P_TOL if f == "p" else STEP_TOL, f"{kind} {solver} {f}")
    assert td.poisson_iters > 0
    assert not tm._graphable(False, False)


def test_mg_reduces_iterations():
    """On the shell the MG-preconditioned CG takes fewer iterations than
    Jacobi-CG on the same step (the reason `mg` exists)."""
    iters = {}
    for solver in ("cg", "mg"):
        m = make_model(_params(Parameters, "shell", solver),
                       MODEL_GEOS["shell"](t_factory), device="cpu")
        jm = j_make_model(_params(JParameters, "shell", solver),
                          MODEL_GEOS["shell"](j_factory))
        s, _ = _seed(m, jm)
        _, d = m.step(s, DT)
        iters[solver] = d.poisson_iters
    assert 0 < iters["mg"] < iters["cg"], iters


def test_mg_on_the_slab_refused():
    """The JAX package's hierarchy has no 2D slab (its ``_rebuild`` calls
    the 3D factory and fails); the port raises ValueError."""
    p = _params(Parameters, "box", "mg")
    p.space_dimension = 2
    with pytest.raises(ValueError, match="no multigrid hierarchy"):
        make_model(p, t_factory.make_cuboid_2d(8, 16), device="cpu")
    jp = _params(JParameters, "box", "mg")
    jp.space_dimension = 2
    with pytest.raises(TypeError):
        j_make_model(jp, j_factory.make_cuboid_2d(8, 16))
