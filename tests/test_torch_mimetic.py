"""The mimetic (staggered C-grid) FEEC personality of the PyTorch port
against the JAX package, on the CPU in float64, from the same
numpy-seeded inputs:

  * ``ops/mimetic.py`` (grad_edges, curl_faces, div_cells) and every
    ``StaggeredOps`` method and metric on the walled and the fully
    periodic 3D box, the 2D slab, the annulus and the shell (4 x 8 x 16),
    within 1e-12 of the field's scale;
  * the de Rham identities curl(grad) = 0 and div(curl) = 0 (round-off;
    bitwise on integers), the curl-curl operator symmetric PSD on the
    box, the annulus and the shell;
  * ``MimeticBoussinesqModel`` (built through ``make_model``) against the
    JAX model: three steps on each geometry from a seeded state, with
    ``helmholtz solver = direct`` on the shell (K4's plain version),
    both ``coriolis mode``s, both ``projection``s and the
    semi-Lagrangian transport on the box: fields within 1e-12 of their
    scale (p within 1e-11), the packed diagnostics within round-off and
    the CG iteration counts equal; ``run`` with a CG miss escalating as the JAX run does;
  * the structure properties of tests/test_mimetic_model.py on the
    port: exact divergence, the projection keeps the vorticity, the
    advection + Coriolis tendency conserves energy, heat is conserved,
    the kinetic-energy drift is first order in dt, Taylor-Green decay at
    the staggered curl-curl's rate;
  * the dispatch, the kernels the model reports, no CUDA graph."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.models import make_model as j_make_model
from dycoreplanet_tpu.ops import bc as j_bc
from dycoreplanet_tpu.ops import mimetic as j_mim
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.grid import factory as t_factory
from dycoreplanet_tpu_torch.models import BoussinesqModel, make_model
from dycoreplanet_tpu_torch.models.convert import state_from_numpy
from dycoreplanet_tpu_torch.models.mimetic import MimeticBoussinesqModel
from dycoreplanet_tpu_torch.ops import mimetic as t_mim
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC

OP_TOL = 1e-12
STEP_TOL = 1e-12
# p: the volume mean both packages subtract is a sum over every cell, its
# round-off ~5e-15 absolute against the shell's p of ~5e-3
P_TOL = 1e-11
# a CG solve's residual norm is round-off of its right-hand side, known
# to a few digits only (tests/test_torch_feec.py)
RES_RTOL, RES_ATOL = 1e-3, 1e-13
N_STEPS = 3
DT = 0.005

GEOS = {
    "box": (dict(), lambda f: f.make_cuboid(6, 6, 6)),
    "periodic": (dict(), lambda f: f.make_cuboid(6, 6, 6, periodic_z=True)),
    "slab": (dict(dim=2), lambda f: f.make_cuboid_2d(8, 8)),
    "annulus": (dict(dim=2, cuboid=False),
                lambda f: f.make_annulus(8, 48, 1.0, 2.0)),
    "shell": (dict(cuboid=False), lambda f: f.make_shell(4, 8, 16, 1.0, 2.0)),
}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol, what):
    want, got = np.asarray(want), _np(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} x {scale:.3e}"


def _params(cls, dim=3, cuboid=True, **num):
    """tests/test_mimetic_model.py's physics with `use FEEC solver` and
    `feec formulation = staggered`."""
    p = cls.from_text("")
    p.space_dimension = dim
    p.cuboid_geometry = cuboid
    p.use_FEEC_solver = True
    p.numerics.feec_formulation = "staggered"
    p.numerics.dtype = "float64"
    p.reference_quantities.velocity = 1.0
    p.reference_quantities.length = 1.0
    p.reference_quantities.temperature_ref = 3.0
    p.time_step = DT
    if not cuboid:
        p.physical_constants.R0 = 1.0
        p.physical_constants.atm_height = 1.0
    for k, v in num.items():
        setattr(p.numerics, k, v)
    return p


def _models(geo_name, **num):
    """(port model on the CPU, JAX model) of the mimetic personality."""
    kw, mk = GEOS[geo_name]
    tm = make_model(_params(Parameters, **kw, **num), mk(t_factory),
                    device="cpu")
    jm = j_make_model(_params(JParameters, **kw, **num), mk(j_factory))
    return tm, jm


_OPS = {}


def _op_pair(geo_name):
    """(port StaggeredOps, JAX StaggeredOps) with the model's BC specs."""
    if geo_name not in _OPS:
        tm, jm = _models(geo_name)
        _OPS[geo_name] = (tm.stag, jm.stag, tm, jm)
    return _OPS[geo_name]


def _full(geo, rng, k=None):
    """Random full-face fields (one per axis), or one when k is given."""
    comps = [rng.standard_normal(geo.face_shape(d)) for d in range(geo.dim)]
    return comps if k is None else comps[k]


def _edge_shape(geo, c):
    return tuple(a.n if e == c else a.n_faces
                 for e, a in enumerate(geo.axes))


def _both(fn_t, fn_j, arrays):
    return (fn_t(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                   for a in arrays]),
            fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in arrays]))


def _cmp_lists(got, want, what):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, OP_TOL, f"{what}[{i}]")
    else:
        _close(got, want, OP_TOL, what)


OP_GROUPS = ["metrics", "layout", "c2f", "f2c", "circulation", "cross",
             "transpose", "curlcurl", "derham"]


@pytest.mark.parametrize("group", OP_GROUPS)
@pytest.mark.parametrize("geo_name", list(GEOS))
def test_staggered_ops_match_jax(geo_name, group):
    """Each group of StaggeredOps methods (and ops/mimetic.py's chain) on
    seeded inputs, against the JAX package's."""
    tsg, jsg, tm, jm = _op_pair(geo_name)
    geo = tm.geo
    dim = geo.dim
    rng = np.random.default_rng(10 + OP_GROUPS.index(group))
    cells = geo.cell_shape
    tspec = tm.u_specs
    jspec = jm.u_specs
    if group == "metrics":
        for d in range(dim):
            for stag in ("c", "f"):
                for ext in (None,) + tuple(range(dim)):
                    s = [stag] * dim
                    _close(tsg.m.lam(d, s, ext), jsg.m.lam(d, s, ext),
                           OP_TOL, f"lam {d} {s} {ext}")
            for name in ("h_face", "area_face", "w_face"):
                _close(getattr(tsg, name)[d], getattr(jsg, name)[d],
                       OP_TOL, f"{name}[{d}]")
        for name in ("A_edge", "inv_A_edge", "edge_w"):
            _cmp_lists(getattr(tsg, name), getattr(jsg, name), name)
    elif group == "layout":
        uf = [rng.standard_normal(cells) for _ in range(dim)]
        _cmp_lists(*_both(lambda *x: tsg.expand(list(x)),
                          lambda *x: jsg.expand(list(x)), uf), "expand")
        U = _full(geo, rng)
        _cmp_lists(*_both(lambda *x: tsg.contract(list(x)),
                          lambda *x: jsg.contract(list(x)), U), "contract")
    elif group == "c2f":
        x = rng.standard_normal(cells)
        for c in range(dim):
            for d in range(dim):
                for name in ("avg_c2f", "dcf"):
                    got, want = _both(
                        lambda a: getattr(tsg, name)(a, d, tspec[c][d]),
                        lambda a: getattr(jsg, name)(a, d, jspec[c][d]), [x])
                    _close(got, want, OP_TOL, f"{name} {c} {d}")
                w = jsg.m.lam(c, jsg._full_stag(c), ext_axis=d)
                got = tsg.dcf(torch.as_tensor(x), d, tspec[c][d],
                              weight_ext=w)
                want = jsg.dcf(jnp.asarray(x), d, jspec[c][d], weight_ext=w)
                _close(got, want, OP_TOL, f"weighted dcf {c} {d}")
    elif group == "f2c":
        for d in range(dim):
            x = _full(geo, rng, d)
            for name in ("avg_f2c", "dfc"):
                got, want = _both(lambda a: getattr(tsg, name)(a, d),
                                  lambda a: getattr(jsg, name)(a, d), [x])
                _close(got, want, OP_TOL, f"{name} {d}")
    elif group == "circulation":
        U = _full(geo, rng)
        for name in ("circulation", "vorticity"):
            _cmp_lists(*_both(lambda *x: getattr(tsg, name)(list(x)),
                              lambda *x: getattr(jsg, name)(list(x)), U),
                       name)
    elif group == "cross":
        U = _full(geo, rng)
        q = (rng.standard_normal(_edge_shape(geo, None)) if dim == 2
             else [rng.standard_normal(_edge_shape(geo, c))
                   for c in range(3)])
        qt = (torch.as_tensor(q) if dim == 2
              else [torch.as_tensor(a) for a in q])
        qj = (jnp.asarray(q) if dim == 2 else [jnp.asarray(a) for a in q])
        _cmp_lists(tsg.cross(qt, [torch.as_tensor(a) for a in U]),
                   jsg.cross(qj, [jnp.asarray(a) for a in U]), "cross")
        _cmp_lists(*_both(lambda *x: tsg.kinetic_energy(list(x)),
                          lambda *x: jsg.kinetic_energy(list(x)), U), "KE")
        f = rng.standard_normal(cells)
        _cmp_lists(tsg.grad_faces(torch.as_tensor(f), tm.p_specs),
                   jsg.grad_faces(jnp.asarray(f), jm.scalar_specs),
                   "grad_faces")
    elif group == "transpose":
        for d in range(dim):
            x = _full(geo, rng, d)
            for c in range(dim):
                got, want = _both(
                    lambda a: tsg._dcf_transpose(a, d, tspec[c][d]),
                    lambda a: jsg._dcf_transpose(a, d, jspec[c][d]), [x])
                _close(got, want, OP_TOL, f"dcf^T {c} {d}")
        for rule in (BC.ANTISYM, BC.NEUMANN) + (
                (BC.POLE, BC.POLE_FLIP) if geo.kind == "shell" else ()):
            x = rng.standard_normal(cells)
            _close(tsg._gapply(rule, torch.as_tensor(x)),
                   jsg._gapply(j_bc.BC[rule.name], jnp.asarray(x)), OP_TOL,
                   f"gapply {rule}")
        # _wtrans on an edge field, each (component, axis) of the curls
        pairs = ([(1, 0), (0, 1)] if dim == 2 else
                 [(b, a) for c in range(3)
                  for a, b in (((c + 1) % 3, (c + 2) % 3),
                               ((c + 2) % 3, (c + 1) % 3))])
        for comp, d in pairs:
            c_edge = 3 - comp - d if dim == 3 else None
            mu = rng.standard_normal(_edge_shape(geo, c_edge))
            got = tsg._wtrans(torch.as_tensor(mu), d, tspec[comp][d], comp)
            want = jsg._wtrans(
                jnp.asarray(mu), d, jspec[comp][d],
                jsg.m.lam(comp, jsg._full_stag(comp), ext_axis=d))
            _close(got, want, OP_TOL, f"wtrans {comp} {d}")
    elif group == "curlcurl":
        U = _full(geo, rng)
        _cmp_lists(*_both(lambda *x: tsg.curlcurl_weighted(list(x)),
                          lambda *x: jsg.curlcurl_weighted(list(x)), U),
                   "curlcurl_weighted")
        _cmp_lists(tsg.curlcurl_diag(), jsg.curlcurl_diag(), "curlcurl_diag")
    else:
        f = rng.standard_normal(cells)
        _cmp_lists(t_mim.grad_edges(geo, torch.as_tensor(f)),
                   j_mim.grad_edges(jm.geo, jnp.asarray(f)), "grad_edges")
        e = [rng.standard_normal(cells) for _ in range(dim)]
        _cmp_lists(t_mim.curl_faces(geo, [torch.as_tensor(a) for a in e]),
                   j_mim.curl_faces(jm.geo, [jnp.asarray(a) for a in e]),
                   "curl_faces")
        _cmp_lists(t_mim.div_cells(geo, [torch.as_tensor(a) for a in e]),
                   j_mim.div_cells(jm.geo, [jnp.asarray(a) for a in e]),
                   "div_cells")


# ------------------------------------------------------- de Rham identities
@pytest.mark.parametrize("geo_name", ["box", "annulus", "shell"])
def test_de_rham_identities(geo_name):
    """curl(grad f) = 0 and, in 3D, div(curl e) = 0: round-off on random
    data, bitwise on integers (tests/test_mimetic.py on the port)."""
    geo = GEOS[geo_name][1](t_factory)
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.standard_normal(geo.cell_shape))
    c = t_mim.curl_faces(geo, t_mim.grad_edges(geo, f))
    comps = (c,) if geo.dim == 2 else c
    tol = 16 * np.finfo(np.float64).eps * float(f.abs().max())
    assert all(float(x.abs().max()) <= tol for x in comps)
    fi = torch.as_tensor(rng.integers(-100, 100, geo.cell_shape).astype(float))
    c = t_mim.curl_faces(geo, t_mim.grad_edges(geo, fi))
    assert all(float(x.abs().max()) == 0.0
               for x in ((c,) if geo.dim == 2 else c))
    if geo.dim == 3:
        e = [torch.as_tensor(rng.integers(-50, 50, geo.cell_shape)
                             .astype(float)) for _ in range(3)]
        assert float(t_mim.div_cells(geo, t_mim.curl_faces(geo, e))
                     .abs().max()) == 0.0
        e = [torch.as_tensor(rng.standard_normal(geo.cell_shape))
             for _ in range(3)]
        F = t_mim.curl_faces(geo, e)
        tol = 64 * np.finfo(np.float64).eps * max(
            float(x.abs().max()) for x in F)
        assert float(t_mim.div_cells(geo, F).abs().max()) <= tol


@pytest.mark.parametrize("geo_name", ["box", "annulus", "shell"])
def test_curlcurl_symmetric_psd(geo_name):
    """<y, CC x> = <x, CC y> to round-off and <x, CC x> >= 0 in the
    cell-shaped layout the momentum CG sees (the transpose ghost
    foldbacks, the pole closure included)."""
    tm = _op_pair(geo_name)[2]
    sg = tm.stag
    dim = tm.geo.dim
    rng = np.random.default_rng(1)

    def cc(x):
        U = sg.expand([x[d] for d in range(dim)])
        return torch.stack(sg.contract(sg.curlcurl_weighted(U)))

    x = torch.as_tensor(rng.standard_normal((dim,) + tm.geo.cell_shape))
    y = torch.as_tensor(rng.standard_normal((dim,) + tm.geo.cell_shape))
    sym = float(torch.sum(y * cc(x)) - torch.sum(x * cc(y)))
    nrm = float(torch.sum(torch.abs(x * cc(x))))
    assert abs(sym) / nrm < 1e-12, sym
    assert float(torch.sum(x * cc(x))) >= 0.0


# ----------------------------------------------------- steps against JAX
def _seeded(tm, jm, seed=0, amp=0.05):
    """The same seeded developed flow in both packages: a random cell
    velocity and its face interpolant as the prognostic faces (the
    preset's seeding, models/presets.py)."""
    rng = np.random.default_rng(seed)
    dim = tm.geo.dim
    u = amp * rng.standard_normal((dim,) + tm.geo.cell_shape)
    faces = [_np(f) for f in tm.interp_to_faces(torch.as_tensor(u))]
    ts = state_from_numpy(tm, u, faces, np.zeros(tm.geo.cell_shape),
                          tm.T_init)
    jf = tuple(jm._apply_wall_face_values(
        jm._interp_component_to_faces(jnp.asarray(u[c]), c), c)
        for c in range(dim))
    _close(np.stack([_np(f) for f in faces]), np.stack(jf), OP_TOL, "faces")
    js = jm.initial_state()._replace(u=jnp.asarray(u), u_faces=jf)
    return ts, js


STEP_CASES = {
    "box": ("box", {}),
    "periodic": ("periodic", {}),
    "slab": ("slab", {}),
    "slab_physical": ("slab", dict(coriolis_mode="physical")),
    "annulus": ("annulus", {}),
    "annulus_direct": ("annulus", dict(helmholtz_solver="direct")),
    "shell": ("shell", {}),
    "shell_physical": ("shell", dict(coriolis_mode="physical")),
    "shell_direct": ("shell", dict(helmholtz_solver="direct")),
    "box_pressure_free": ("box", dict(projection="pressure-free")),
    "box_sl": ("box", dict(temperature_advection="semi-lagrangian")),
}


def _compare_packed(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    # iteration counts (poisson, temperature, helmholtz x dim) and the
    # verdict equal; the residuals to round-off
    for k in [5, 6, 10] + list(range(11, len(want))):
        assert got[k] == want[k], (what, k, got, want)
    for k in (7, 8, 9):
        np.testing.assert_allclose(got[k], want[k], rtol=RES_RTOL,
                                   atol=RES_ATOL, err_msg=f"{what} slot {k}")
    # cfl, max|u|, T range (float32 slots, a T_min of round-off size
    # too); max|div u| is round-off
    np.testing.assert_allclose(got[:4], want[:4], rtol=1e-6,
                               atol=1e-12 * float(np.abs(want[:4]).max()),
                               err_msg=what)
    assert got[4] <= max(4 * want[4], 1e-13), (what, got[4], want[4])


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_mimetic_steps_match_jax(case):
    """Three mimetic steps from the seeded state in both packages: u,
    the prognostic faces, p and T within 1e-12 of their scale, the packed
    diagnostics slot for slot (equal CG iterations)."""
    geo_name, num = STEP_CASES[case]
    tm, jm = _models(geo_name, **num)
    assert isinstance(tm, MimeticBoussinesqModel)
    ts, js = _seeded(tm, jm)
    for k in range(N_STEPS):
        ts, td = tm.step(ts, DT)
        js, jd = jm.step(js, DT)
        for f in ("u", "p", "T"):
            _close(getattr(ts, f), getattr(js, f),
                   P_TOL if f == "p" else STEP_TOL, f"{case} step {k} {f}")
        for d in range(tm.geo.dim):
            _close(ts.u_faces[d], js.u_faces[d], STEP_TOL,
                   f"{case} step {k} face {d}")
        _compare_packed(td.packed.numpy(), jd.packed, f"{case} step {k}")
    if num.get("helmholtz_solver") == "direct":
        # the temperature solve's -1 sentinel; K4's plain version on CPU
        assert td.temperature_iters == -1
        assert tm._tridiag.launches == 0


def test_mimetic_run_escalates_on_a_cg_miss():
    """With 1/Re = 1 (a stiff viscous solve) and `max cg iters = 2` the
    momentum CG misses its tolerance on the seeded shell: the step's
    solver_ok is False, so ``run`` redoes it with full CG and opens the
    escalation window, whose steps are full-CG steps too. Three steps of
    ``run`` equal three of the JAX model's ``step_strong``."""
    tm, jm = _models("shell", max_cg_iters=2)
    tm.one_over_Re = jm.one_over_Re = 1.0
    ts, js = _seeded(tm, jm)
    _, d = tm.step(ts, DT)
    assert not d.solver_ok and list(d.helmholtz_iters) == [2, 2, 2]
    state, hist = tm.run(max_steps=3, state=ts)
    assert tm.escalations == 1 and len(hist) == 3
    for k in range(3):
        js, jd = jm.step_strong(js, DT)
        assert hist[k]["poisson_iters"] == int(np.asarray(jd.packed)[5])
    _close(state.u, js.u, STEP_TOL, "run u")
    _close(state.T, js.T, STEP_TOL, "run T")


def test_mimetic_multi_step_chunk_equals_steps():
    """A multi_step chunk of 3 (eager: no CUDA graph for the momentum
    CG) equals 3 steps, bitwise."""
    tm, jm = _models("annulus")
    ts, _ = _seeded(tm, jm)
    s1 = ts
    for _ in range(3):
        s1, _ = tm.step(s1, DT)
    s2, rows, _ = tm.multi_step(ts, DT, 3)
    assert rows.shape[0] == 3
    assert torch.equal(s1.u, s2.u) and torch.equal(s1.T, s2.T)
    assert not tm._graphable(False, False)


def test_make_model_dispatch_and_kernels():
    """make_model builds the mimetic model for FEEC + staggered and
    BoussinesqModel otherwise, as the JAX package's; the mimetic model
    builds none of the shell's kernels (only K4's wrapper, for the
    direct temperature solve)."""
    kw, mk = GEOS["shell"]
    p = _params(Parameters, **kw)
    m = make_model(p, mk(t_factory), device="cpu")
    assert type(m) is MimeticBoussinesqModel
    assert list(m.kernels()) == ["tridiag"]
    p.numerics.feec_formulation = "coupled"
    assert type(make_model(p, mk(t_factory), device="cpu")) \
        is BoussinesqModel
    p.use_FEEC_solver = False
    p.numerics.feec_formulation = "staggered"
    assert type(make_model(p, mk(t_factory), device="cpu")) \
        is BoussinesqModel


def test_shell_needs_even_nlon():
    p = _params(Parameters, cuboid=False)
    with pytest.raises(ValueError, match="even nlon"):
        make_model(p, t_factory.make_shell(4, 8, 15, 1.0, 2.0), device="cpu")


# ------------------------------------------------ structure properties
def _smooth_faces(m):
    def fn(d, mesh):
        if m.geo.dim == 2:
            r, x = mesh
            if d == 0:
                return np.sin(2 * np.pi * r) * np.cos(3 * x)
            return np.cos(2 * np.pi * r) * np.sin(2 * x)
        z, y, x = mesh
        if d == 0:
            return np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
        if d == 1:
            return np.cos(2 * np.pi * z) * np.sin(2 * np.pi * x)
        return np.sin(2 * np.pi * y) * np.cos(2 * np.pi * z)
    return list(m.faces_from_velocity(fn))


def _project(m, uf):
    """A discretely divergence-free face field."""
    rhs = -m._vol_t * st.divergence(m.geo, uf)
    phi, _, _, _ = m._solve_pressure_poisson(rhs - torch.mean(rhs))
    return [m._apply_wall_face_values(
        uf[d] + st.grad_left_faces(m.geo, phi, d, m.p_specs[d]), d)
        for d in range(m.geo.dim)]


def _periodic_model(n=10, **num):
    return MimeticBoussinesqModel(
        _params(Parameters, **num),
        t_factory.make_cuboid(n, n, n, periodic_z=True), device="cpu")


@pytest.mark.parametrize("geo_name", ["periodic", "annulus", "shell"])
def test_step_divergence_machine_zero(geo_name):
    """f64 direct Poisson: the prognostic faces stay divergence-free to
    round-off over three steps."""
    tm = _op_pair(geo_name)[2]
    s = (tm.state_from_faces(_smooth_faces(tm)) if tm.geo.kind != "shell"
         else _seeded(tm, _op_pair(geo_name)[3])[0])
    for _ in range(3):
        s, d = tm.step(s, DT)
    assert d.div_norm < 1e-11, d.div_norm


@pytest.mark.parametrize("geo_name", ["annulus", "shell"])
def test_projection_preserves_vorticity(geo_name):
    """curl(grad phi) telescopes to zero at every interior edge, pole
    closure included (the wall rings excluded: the no-slip mirror
    intervenes there; the polar dual loops carry zero vorticity)."""
    tm = _op_pair(geo_name)[2]
    sg, geo = tm.stag, tm.geo
    rng = np.random.default_rng(1)
    uf = [tm._apply_wall_face_values(
        torch.as_tensor(0.1 * rng.standard_normal(geo.cell_shape)), d)
        for d in range(geo.dim)]
    phi = torch.as_tensor(rng.standard_normal(geo.cell_shape))
    corr = [tm._apply_wall_face_values(
        uf[d] - 0.1 * st.grad_left_faces(geo, phi, d, tm.p_specs[d]), d)
        for d in range(geo.dim)]
    z0 = sg.vorticity(sg.expand(uf))
    z1 = sg.vorticity(sg.expand(corr))
    if geo.dim == 2:
        dz = float((z1 - z0)[1:-1].abs().max())
        assert dz / float(z0.abs().max()) < 1e-12
        return
    zmag = max(float(z.abs().max()) for z in z0)
    assert float((z1[0] - z0[0])[:, 1:-1].abs().max()) / zmag < 1e-12
    assert float(z1[0][:, (0, -1)].abs().max()) == 0.0
    assert float((z1[1] - z0[1])[1:-1].abs().max()) / zmag < 1e-12
    assert float((z1[2] - z0[2])[1:-1, 1:-1].abs().max()) / zmag < 1e-12


def test_advection_coriolis_tendency_conserves_energy():
    """On the uniform periodic box the Sadourny cross product plus the
    kinetic-energy gradient puts no energy into a divergence-free flow."""
    m = _periodic_model()
    sg = m.stag
    uf = _project(m, _smooth_faces(m))
    U = sg.expand(uf)
    zeta = sg.vorticity(U)
    q = [-zeta[0] + 2.0 * m.omega_hat, -zeta[1], -zeta[2]]
    cross = sg.cross(q, U)
    gradK = sg.grad_faces(sg.kinetic_energy(U), m.p_specs)
    tend = torch.stack(sg.contract([cross[d] - gradK[d] for d in range(3)]))
    ufs = torch.stack(uf)
    e_in = float(torch.sum(m._w_stack * ufs * tend))
    e = float(torch.sum(m._w_stack * ufs * ufs))
    assert abs(e_in) / e < 1e-13, e_in / e


def _inviscid(m):
    m.one_over_Re = 0.0
    m.beta = 0.0
    m._gravity_face0 = torch.zeros_like(m._gravity_face0)
    return m


def test_kinetic_energy_drift_vanishes_with_dt():
    """The inviscid unforced step's energy drift over a fixed horizon is
    first order in dt (exact in space): it halves with dt."""
    m = _inviscid(_periodic_model(n=8))

    def drift(dt, n_steps):
        s = m.state_from_faces(_project(m, _smooth_faces(m)))
        e0 = float(torch.sum(m._w_stack * torch.stack(s.u_faces) ** 2))
        for _ in range(n_steps):
            s, _ = m.step(s, dt)
        e1 = float(torch.sum(m._w_stack * torch.stack(s.u_faces) ** 2))
        return abs(e1 - e0) / e0

    d1, d2 = drift(0.02, 4), drift(0.01, 8)
    assert d2 < 0.7 * d1, (d1, d2)


def test_heat_exactly_conserved_periodic():
    m = _periodic_model()
    s = m.state_from_faces(_project(m, _smooth_faces(m)))
    heat = lambda s: float(torch.sum(m._vol_t * s.T))
    h0 = heat(s)
    for _ in range(5):
        s, _ = m.step(s, DT)
    assert abs(heat(s) - h0) / abs(h0) < 1e-12


def test_taylor_green_decay_through_curlcurl():
    """A small Taylor-Green vortex decays at the staggered curl-curl's
    discrete rate 2 nu 2 (2/h sin(kh/2))^2 (energy) within 5%."""
    m = _inviscid(_periodic_model(n=16))
    nu = 0.02
    m.one_over_Re = nu
    m.omega_hat = 0.0
    k, amp = 2 * np.pi, 1e-3

    def fn(d, mesh):
        z, y, x = mesh
        if d == 2:
            return amp * np.sin(k * x) * np.cos(k * y)
        if d == 1:
            return -amp * np.cos(k * x) * np.sin(k * y)
        return np.zeros_like(x)

    s = m.state_from_faces(m.faces_from_velocity(fn))
    energy = lambda s: float(torch.sum(m._w_stack
                                       * torch.stack(s.u_faces) ** 2))
    e0, dt, n_steps = energy(s), 2e-3, 40
    for _ in range(n_steps):
        s, _ = m.step(s, dt)
    rate = -np.log(energy(s) / e0) / (n_steps * dt)
    h = 1.0 / 16
    exact = 2.0 * nu * 2.0 * (2.0 / h * np.sin(k * h / 2.0)) ** 2
    assert abs(rate - exact) / exact < 0.05, (rate, exact)


def test_mimetic_state_converts_both_ways():
    """A mimetic state (prognostic faces) through state_to_numpy and
    state_from_numpy is bitwise the same, and the JAX package's step of
    the converted state matches the port's."""
    from dycoreplanet_tpu_torch.models.convert import state_to_numpy
    tm, jm = _models("shell")
    ts, js = _seeded(tm, jm, seed=5)
    ts, _ = tm.step(ts, DT)
    u, faces, pres, T, time, step = state_to_numpy(ts)
    back = state_from_numpy(tm, u, faces, pres, T, time, step)
    assert all(torch.equal(a, b) for a, b in zip(back.u_faces, ts.u_faces))
    assert torch.equal(back.u, ts.u) and torch.equal(back.T, ts.T)
    js = js._replace(u=jnp.asarray(u), u_faces=tuple(map(jnp.asarray, faces)),
                     p=jnp.asarray(pres), T=jnp.asarray(T))
    js2, _ = jm.step(js, DT)
    ts2, _ = tm.step(back, DT)
    _close(ts2.u, js2.u, STEP_TOL, "converted step u")
