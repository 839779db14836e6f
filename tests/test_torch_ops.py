"""PyTorch port vs JAX package, module by module (f64, CPU): ghost
rules, stencils, vector terms, Jacobi diagonals, the fixed-iteration
Richardson solve, CG and the shell fast-diagonalization Poisson solve.
The same numpy inputs go through both; results agree to 1e-12
relative (both evaluate the same formulas in float64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.grid.factory import make_shell as j_make_shell
from dycoreplanet_tpu.ops import bc as j_bc
from dycoreplanet_tpu.ops import stencil as j_st
from dycoreplanet_tpu.ops import vector as j_vec
from dycoreplanet_tpu.ops.diagonal import (
    weak_laplacian_diagonal as j_wl_diag)
from dycoreplanet_tpu.solvers.cg import cg as j_cg
from dycoreplanet_tpu.solvers.fixed import richardson_solve as j_rich
from dycoreplanet_tpu.solvers.spectral import (
    ShellPoissonFastDiag as JFastDiag)
from dycoreplanet_tpu_torch.grid.factory import make_shell
from dycoreplanet_tpu_torch.ops import bc
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops import vector as vec
from dycoreplanet_tpu_torch.ops.diagonal import weak_laplacian_diagonal
from dycoreplanet_tpu_torch.solvers.cg import cg
from dycoreplanet_tpu_torch.solvers.fixed import richardson_solve
from dycoreplanet_tpu_torch.solvers.spectral import ShellPoissonFastDiag

TOL = 1e-12
SHAPES = [(4, 8, 16), (8, 16, 32)]


def rel(a, b):
    a = np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)
    b = np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    return float(np.max(np.abs(a - b))) / scale


def _geos(shape):
    nr, nlat, nlon = shape
    return (j_make_shell(nr, nlat, nlon, 1.0, 3.0),
            make_shell(nr, nlat, nlon, 1.0, 3.0))


def _specs(mod, rng, shape):
    """The model's shell BC tables, built in both packages: u_specs,
    p_specs, T_specs (Dirichlet wall values), T_specs_hom."""
    B, S = mod.BC, mod.BCSpec
    wall = rng.standard_normal(shape[1:])
    if mod is bc:
        wall_v = torch.as_tensor(wall)
    else:
        wall_v = wall
    u = [[S(B.ANTISYM, B.ANTISYM), S(B.POLE, B.POLE), None],
         [S(B.ANTISYM, B.NEUMANN), S(B.POLE_FLIP, B.POLE_FLIP), None],
         [S(B.ANTISYM, B.NEUMANN), S(B.POLE_FLIP, B.POLE_FLIP), None]]
    p = [S(B.NEUMANN, B.NEUMANN), S(B.POLE, B.POLE), None]
    T = [S(B.DIRICHLET, B.NEUMANN, lo_value=wall_v), S(B.POLE, B.POLE), None]
    Th = [S(B.ANTISYM, B.NEUMANN), S(B.POLE, B.POLE), None]
    return {"u0": u[0], "u1": u[1], "u2": u[2], "p": p, "T": T, "Th": Th}


def _setup(shape, seed=0):
    jgeo, geo = _geos(shape)
    js = _specs(j_bc, np.random.default_rng(seed), shape)
    ts = _specs(bc, np.random.default_rng(seed), shape)
    rng = np.random.default_rng(seed + 1)
    f = rng.standard_normal(shape)
    return jgeo, geo, js, ts, f, rng


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec", ["u0", "u1", "u2", "p", "T"])
def test_ghost_rules(shape, spec):
    jgeo, geo, js, ts, f, _ = _setup(shape)
    for d in range(3):
        periodic = geo.axes[d].periodic
        want = j_bc.pad_axis(jnp.asarray(f), d, js[spec][d], periodic)
        got = bc.pad_axis(torch.as_tensor(f), d, ts[spec][d], periodic)
        assert got.shape == want.shape
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec", ["u0", "u1", "u2", "p", "T", "Th"])
def test_stencils(shape, spec):
    jgeo, geo, js, ts, f, rng = _setup(shape)
    jf, tf = jnp.asarray(f), torch.as_tensor(f)
    uf = rng.standard_normal(shape)
    juf, tuf = jnp.asarray(uf), torch.as_tensor(uf)
    for d in range(3):
        jsp, tsp = js[spec][d], ts[spec][d]
        pairs = [
            (j_st.to_faces(jgeo, jf, d, jsp), st.to_faces(geo, tf, d, tsp)),
            (j_st.grad_left_faces(jgeo, jf, d, jsp),
             st.grad_left_faces(geo, tf, d, tsp)),
            (j_st.upwind_to_faces(jgeo, jf, d, juf, jsp),
             st.upwind_to_faces(geo, tf, d, tuf, tsp)),
            (j_st.muscl_to_faces(jgeo, jf, d, juf, jsp),
             st.muscl_to_faces(geo, tf, d, tuf, tsp)),
            (j_st.centered_gradient(jgeo, jf, d, jsp),
             st.centered_gradient(geo, tf, d, tsp)),
        ]
        for want, got in pairs:
            assert rel(got, want) <= TOL
    assert rel(st.weak_laplacian(geo, tf, ts[spec]),
               j_st.weak_laplacian(jgeo, jf, js[spec])) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
@pytest.mark.parametrize("form", ["advective", "flux"])
def test_advection_and_divergence(shape, scheme, form):
    jgeo, geo, js, ts, f, rng = _setup(shape, seed=3)
    faces = [rng.standard_normal(shape) for _ in range(3)]
    jfaces = [jnp.asarray(x) for x in faces]
    tfaces = [torch.as_tensor(x) for x in faces]
    assert rel(st.divergence(geo, tfaces),
               j_st.divergence(jgeo, jfaces)) <= TOL
    assert rel(st.face_flux_div(geo, tfaces),
               j_st.face_flux_div(jgeo, jfaces)) <= TOL
    for spec in ("u0", "u1", "T"):
        want = j_st.advect_scalar(jgeo, jfaces, jnp.asarray(f), js[spec],
                                  scheme=scheme, form=form)
        got = st.advect_scalar(geo, tfaces, torch.as_tensor(f), ts[spec],
                               scheme=scheme, form=form)
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
def test_reductions(shape):
    jgeo, geo, _, _, f, rng = _setup(shape)
    u = rng.standard_normal((3,) + shape)
    assert rel(st.cell_max_speed(geo, torch.as_tensor(u)),
               j_st.cell_max_speed(jgeo, jnp.asarray(u))) <= TOL
    assert rel(st.volume_mean(geo, torch.as_tensor(f)),
               j_st.volume_mean(jgeo, jnp.asarray(f))) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", ["reference", "physical"])
def test_vector_terms(shape, mode):
    jgeo, geo, js, ts, _, rng = _setup(shape, seed=5)
    u = rng.standard_normal((3,) + shape)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    jspecs = [js["u0"], js["u1"], js["u2"]]
    tspecs = [ts["u0"], ts["u1"], ts["u2"]]
    assert rel(vec.advection_curvature(geo, tu),
               j_vec.advection_curvature(jgeo, ju)) <= TOL
    assert rel(vec.vector_laplacian_curvature(geo, tu, tspecs),
               j_vec.vector_laplacian_curvature(jgeo, ju, jspecs)) <= TOL
    got = vec.coriolis_acceleration(geo, tu, 0.7, mode)
    want = j_vec.coriolis_acceleration(jgeo, ju, 0.7, mode)
    if mode == "reference":
        assert float(got.abs().max()) == 0.0 == float(jnp.max(jnp.abs(want)))
    else:
        assert rel(got, want) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec", ["u0", "u1", "u2", "p", "Th"])
def test_jacobi_diagonal(shape, spec):
    jgeo, geo, js, ts, _, _ = _setup(shape)
    got = weak_laplacian_diagonal(geo, ts[spec])
    want = np.asarray(j_wl_diag(jgeo, js[spec]))
    np.testing.assert_array_equal(got, want)


def _helmholtz(mod_st, geo, specs, coef, xp):
    """(vol - coef L) for one scalar field, with its Jacobi diagonal."""
    vol = np.ascontiguousarray(np.broadcast_to(geo.vol, geo.cell_shape))

    def op(x):
        return xp(vol) * x - coef * mod_st.weak_laplacian(geo, x, specs)
    return op


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("iters", [1, 2, 3])
def test_richardson_solve(shape, iters):
    jgeo, geo, js, ts, f, rng = _setup(shape, seed=7)
    coef = 0.02
    x0 = rng.standard_normal(shape)
    diag = (np.broadcast_to(geo.vol, geo.cell_shape)
            - coef * weak_laplacian_diagonal(geo, ts["Th"]))
    jr = j_rich(_helmholtz(j_st, jgeo, js["Th"], coef, jnp.asarray),
                jnp.asarray(f), jnp.asarray(x0), diag=jnp.asarray(diag),
                iters=iters, rtol=1e-12)
    tr = richardson_solve(
        _helmholtz(st, geo, ts["Th"], coef, torch.as_tensor),
        torch.as_tensor(f), torch.as_tensor(x0),
        diag=torch.as_tensor(diag), iters=iters, rtol=1e-12)
    assert rel(tr.x, jr.x) <= TOL
    assert abs(float(tr.residual_norm) - float(jr.residual_norm)) \
        <= 1e-9 * float(jr.residual_norm)
    assert bool(tr.converged) == bool(jr.converged)
    assert tr.iterations == int(jr.iterations)


@pytest.mark.parametrize("shape", SHAPES)
def test_cg(shape):
    jgeo, geo, js, ts, f, rng = _setup(shape, seed=9)
    coef = 0.5
    diag = (np.broadcast_to(geo.vol, geo.cell_shape)
            - coef * weak_laplacian_diagonal(geo, ts["u1"]))
    jres = j_cg(_helmholtz(j_st, jgeo, js["u1"], coef, jnp.asarray),
                jnp.asarray(f), rtol=1e-10, maxiter=200,
                preconditioner=lambda r: r / jnp.asarray(diag))
    tres = cg(_helmholtz(st, geo, ts["u1"], coef, torch.as_tensor),
              torch.as_tensor(f), rtol=1e-10, maxiter=200,
              preconditioner=lambda r: r / torch.as_tensor(diag))
    assert tres.iterations == int(jres.iterations)
    assert bool(tres.converged) and bool(jres.converged)
    assert rel(tres.x, jres.x) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("precision", ["highest", "high", "high-refine"])
def test_shell_fast_diag(shape, precision):
    jgeo, geo, js, ts, f, _ = _setup(shape, seed=11)
    b = f - f.mean()
    jref = lambda x: -j_st.weak_laplacian(jgeo, x, js["p"])
    tref = lambda x: -st.weak_laplacian(geo, x, ts["p"])
    jp = JFastDiag(jgeo, dtype=np.float64, precision=precision,
                   refine_op=jref)
    tp = ShellPoissonFastDiag(geo, dtype=np.float64, precision=precision,
                              refine_op=tref)
    for k in ("_F", "_G", "_V", "_Q", "_inv_denom"):
        np.testing.assert_array_equal(getattr(tp, k),
                                      np.asarray(getattr(jp, k)))
    jx, _ = jp.solve(jnp.asarray(b))
    tx, iters = tp.solve(torch.as_tensor(b))
    assert iters == 0
    assert rel(tx, jx) <= TOL
    # and it is a solve: the residual of the compatible system is tiny
    r = tref(tx) - torch.as_tensor(b)
    assert float(r.abs().max()) <= 1e-9 * float(np.abs(b).max())
