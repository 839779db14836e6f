"""The port's restarted GMRES / FGMRES (dycoreplanet_tpu_torch/solvers/
gmres.py) against the JAX package's, on the CPU in float64, on the cases
of tests/test_gmres.py: dense nonsymmetric systems (restarted, right-
preconditioned, multidimensional operands, an exact x0), the singular
Neumann Laplacian, flexible GMRES with a fixed and an inner-CG
preconditioner, and the per-cycle residual history. Both solvers get
the same numpy-seeded inputs: the iteration counts are equal, x agrees
within 1e-10 of its scale, and the residual norm and the verdict match."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycoreplanet_tpu.grid import factory as j_factory
from dycoreplanet_tpu.ops import bc as j_bc
from dycoreplanet_tpu.ops import stencil as j_st
from dycoreplanet_tpu.solvers.cg import cg as j_cg
from dycoreplanet_tpu.solvers.gmres import gmres as j_gmres
from dycoreplanet_tpu_torch.grid import factory
from dycoreplanet_tpu_torch.ops import stencil as st
from dycoreplanet_tpu_torch.ops.bc import BC, BCSpec
from dycoreplanet_tpu_torch.solvers.cg import cg
from dycoreplanet_tpu_torch.solvers.gmres import gmres

REL = 1e-10


def _system(seed, n, spd=False, shift=2.0):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n) / np.sqrt(n)
    if spd:
        A = A @ A.T
    return A + shift * np.eye(n), rng.randn(n)


def _dense(seed, n, spd=False, shift=2.0, shape=None, precond=False):
    """(jax op, torch op, b, jax M, torch M) of a dense system."""
    A, b = _system(seed, n, spd, shift)
    shape = shape or (n,)
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    j_op = lambda x: (jA @ x.reshape(-1)).reshape(shape)   # noqa: E731
    t_op = lambda x: (tA @ x.reshape(-1)).reshape(shape)   # noqa: E731
    jM = tM = None
    if precond:
        d = np.diag(A).copy()
        jd, td = jnp.asarray(d), torch.as_tensor(d)
        jM = lambda r: r / jd                               # noqa: E731
        tM = lambda r: r / td                               # noqa: E731
    return j_op, t_op, b.reshape(shape), jM, tM, A


CASES = {
    "nonsymmetric": (dict(seed=0, n=40), dict(rtol=1e-12, restart=40,
                                              maxiter=40)),
    "restarted": (dict(seed=1, n=60, shift=3.0),
                  dict(rtol=1e-10, restart=10, maxiter=200)),
    "right_preconditioned": (dict(seed=2, n=50, shift=2.5, precond=True),
                             dict(rtol=1e-10, restart=25, maxiter=100)),
    "multidimensional": (dict(seed=3, n=36, shape=(6, 6)),
                         dict(rtol=1e-10, restart=36, maxiter=36)),
    "flexible_fixed_preconditioner": (
        dict(seed=7, n=48, precond=True),
        dict(rtol=1e-12, restart=24, maxiter=96, flexible=True)),
    "history": (dict(seed=1, n=60, shift=3.0),
                dict(rtol=1e-10, restart=10, maxiter=200,
                     record_history=8)),
}


def _check(jres, tres, scale=None):
    assert tres.iterations == int(jres.iterations)
    want = np.asarray(jres.x)
    scale = scale or max(float(np.abs(want).max()), 1e-300)
    assert np.abs(tres.x.numpy() - want).max() <= REL * scale
    np.testing.assert_allclose(float(tres.residual_norm),
                               float(jres.residual_norm), rtol=1e-6,
                               atol=1e-14 * scale)
    assert bool(tres.converged) == bool(jres.converged)


@pytest.mark.parametrize("case", list(CASES))
def test_gmres_matches_jax_dense(case):
    sys_kw, kw = CASES[case]
    j_op, t_op, b, jM, tM, A = _dense(**sys_kw)
    jres = j_gmres(j_op, jnp.asarray(b), preconditioner=jM, **kw)
    tres = gmres(t_op, torch.as_tensor(b), preconditioner=tM, **kw)
    _check(jres, tres)
    assert bool(tres.converged)
    # the reported norm is the true residual (right preconditioning)
    r = b.reshape(-1) - A @ tres.x.numpy().reshape(-1)
    np.testing.assert_allclose(float(tres.residual_norm), np.linalg.norm(r),
                               rtol=1e-6, atol=1e-13)
    if case == "restarted":
        assert tres.iterations > 10
    if kw.get("record_history"):
        jh, th = np.asarray(jres.history), tres.history.numpy()
        assert th.dtype == np.float32 and th.shape == jh.shape == (8,)
        assert np.array_equal(np.isnan(th), np.isnan(jh))
        ok = ~np.isnan(jh)
        assert ok.sum() >= 2
        np.testing.assert_allclose(th[ok], jh[ok], rtol=1e-5)
    else:
        assert tres.history is None and jres.history is None


def test_gmres_x0_early_exit():
    """An exact x0: no cycle runs, 0 iterations, x = x0."""
    A, b = _system(4, 30, spd=True)
    x_exact = np.linalg.solve(A, b)
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    jres = j_gmres(lambda x: jA @ x, jnp.asarray(b),
                   x0=jnp.asarray(x_exact), rtol=1e-8, restart=10)
    tres = gmres(lambda x: tA @ x, torch.as_tensor(b),
                 x0=torch.as_tensor(x_exact), rtol=1e-8, restart=10)
    assert tres.iterations == int(jres.iterations) == 0
    np.testing.assert_array_equal(tres.x.numpy(), x_exact)
    _check(jres, tres)


def test_gmres_singular_neumann_laplacian():
    """GMRES on the compatible singular pressure operator of an 8 x 16
    annulus, projected onto zero mean (nested_schur_complement.hpp:
    170-183)."""
    jgeo = j_factory.make_annulus(8, 16, 1.0, 2.0)
    tgeo = factory.make_annulus(8, 16, 1.0, 2.0)
    jspecs = [j_bc.BCSpec(j_bc.BC.NEUMANN, j_bc.BC.NEUMANN), None]
    tspecs = [BCSpec(BC.NEUMANN, BC.NEUMANN), None]
    b = np.random.RandomState(6).randn(8, 16)
    b = b - b.mean()

    def j_op(x):
        ax = -j_st.weak_laplacian(jgeo, x, jspecs)
        return ax - jnp.mean(ax)

    def t_op(x):
        ax = -st.weak_laplacian(tgeo, x, tspecs)
        return ax - torch.mean(ax)

    jres = j_gmres(j_op, jnp.asarray(b), rtol=1e-9, restart=40, maxiter=400)
    tres = gmres(t_op, torch.as_tensor(b), rtol=1e-9, restart=40,
                 maxiter=400)
    _check(jres, tres)
    r = b - t_op(tres.x).numpy()
    assert np.linalg.norm(r) < 1e-7 * np.linalg.norm(b) + 1e-10


def test_fgmres_inner_cg_preconditioner():
    """Flexible GMRES around a truncated inner CG (3 iterations, so the
    preconditioner is nonlinear in its input): the coupled solve's
    strong-retry configuration."""
    rng = np.random.RandomState(8)
    n = 48
    S = rng.randn(n, n) / np.sqrt(n)
    A = S @ S.T + 2.0 * np.eye(n)
    N = 0.1 * (rng.randn(n, n) / np.sqrt(n))
    K = A + N - N.T
    b = rng.randn(n)
    jA, jK = jnp.asarray(A), jnp.asarray(K)
    tA, tK = torch.as_tensor(A), torch.as_tensor(K)
    jres = j_gmres(lambda x: jK @ x, jnp.asarray(b), rtol=1e-10, restart=20,
                   maxiter=200, flexible=True,
                   preconditioner=lambda r: j_cg(lambda x: jA @ x, r,
                                                 rtol=1e-12, maxiter=3).x)
    tres = gmres(lambda x: tK @ x, torch.as_tensor(b), rtol=1e-10,
                 restart=20, maxiter=200, flexible=True,
                 preconditioner=lambda r: cg(lambda x: tA @ x, r,
                                             rtol=1e-12, maxiter=3).x)
    _check(jres, tres)
    assert bool(tres.converged)
    r = b - K @ tres.x.numpy()
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(b)
