"""The port's matrix-free linear-algebra compositions
(dycoreplanet_tpu_torch/linear_algebra/) against the JAX package's, on
the CPU in float64: the seven combinators on numpy-seeded dense blocks,
the same inputs through both, within 1e-10 of the output's scale (the
inner Krylov solves converged or truncated alike)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycoreplanet_tpu import linear_algebra as jla
from dycoreplanet_tpu_torch import linear_algebra as la

REL = 1e-10


def _spd(rng, n, shift=2.0):
    A = rng.randn(n, n) / np.sqrt(n)
    return A @ A.T + shift * np.eye(n)


def _ops(M):
    """(jax op, torch op) applying the dense matrix M."""
    jM, tM = jnp.asarray(M), torch.as_tensor(M)
    return (lambda x: jM @ x), (lambda x: tM @ x)


def _inverse(rng, n, **kw):
    A = _spd(rng, n)
    jA, tA = _ops(A)
    return A, jla.inverse_operator(jA, **kw), la.inverse_operator(tA, **kw)


def _case(name, rng):
    """(jax closure, torch closure, input x, the dense result or None)."""
    if name in ("inverse_operator_cg", "inverse_operator_gmres"):
        solver = name.rsplit("_", 1)[1]
        A, j, t = _inverse(rng, 24, rtol=1e-12, maxiter=200, solver=solver)
        x = rng.randn(24)
        return j, t, x, np.linalg.solve(A, x)
    if name.startswith("approximate_inverse"):
        solver = name.rsplit("_", 1)[1]
        A = _spd(rng, 24)
        d = np.diag(A).copy()
        jA, tA = _ops(A)
        jd, td = jnp.asarray(d), torch.as_tensor(d)
        kw = dict(n_iter=3, solver=solver)
        j = jla.approximate_inverse(jA, preconditioner=lambda r: r / jd,
                                    **kw)
        t = la.approximate_inverse(tA, preconditioner=lambda r: r / td, **kw)
        return j, t, rng.randn(24), None
    if name == "schur_complement":
        n, m = 20, 8
        A, jAi, tAi = _inverse(rng, n, rtol=1e-13, maxiter=200)
        Bm = rng.randn(m, n)
        jB, tB = _ops(Bm)
        jBT, tBT = _ops(Bm.T.copy())
        x = rng.randn(m)
        return (jla.schur_complement(jB, jAi, jBT),
                la.schur_complement(tB, tAi, tBT), x,
                Bm @ np.linalg.solve(A, Bm.T @ x))
    if name == "approximate_schur_complement":
        n, m = 20, 8
        d = 1.0 + rng.rand(n)
        Bm = rng.randn(m, n)
        jB, tB = _ops(Bm)
        jBT, tBT = _ops(Bm.T.copy())
        jd, td = jnp.asarray(d), torch.as_tensor(d)
        x = rng.randn(m)
        return (jla.approximate_schur_complement(jB, lambda r: r / jd, jBT),
                la.approximate_schur_complement(tB, lambda r: r / td, tBT),
                x, Bm @ ((Bm.T @ x) / d))
    if name == "shifted_schur_complement":
        n = 16
        M11 = _spd(rng, n)
        Mw, jMwi, tMwi = _inverse(rng, n, rtol=1e-13, maxiter=200)
        B10, B01 = rng.randn(n, n) / 4, rng.randn(n, n) / 4
        (j11, t11), (j10, t10), (j01, t01) = map(_ops, (M11, B10, B01))
        x = rng.randn(n)
        return (jla.shifted_schur_complement(j11, j10, jMwi, j01),
                la.shifted_schur_complement(t11, t10, tMwi, t01), x,
                M11 @ x - B10 @ np.linalg.solve(Mw, B01 @ x))
    if name in ("zero_mean", "zero_mean_weighted"):
        x = rng.randn(12)
        if name == "zero_mean":
            return jla.zero_mean(), la.zero_mean(), x, x - x.mean()
        w = rng.rand(12) + 0.5
        return (jla.zero_mean(jnp.asarray(w)), la.zero_mean(torch.as_tensor(w)),
                x, x - (x * w).sum() / w.sum())
    if name == "nested_schur_complement":
        n, m = 18, 6
        Sw, jSi, tSi = _inverse(rng, n, rtol=1e-13, maxiter=200)
        Bm = rng.randn(m, n)
        jB, tB = _ops(Bm)
        jBT, tBT = _ops(Bm.T.copy())
        w = rng.rand(m) + 0.5
        x = rng.randn(m)
        y = Bm @ np.linalg.solve(Sw, Bm.T @ x)
        return (jla.nested_schur_complement(jB, jSi, jBT, jnp.asarray(w)),
                la.nested_schur_complement(tB, tSi, tBT, torch.as_tensor(w)),
                x, y - (y * w).sum() / w.sum())
    raise ValueError(name)


NAMES = ["inverse_operator_cg", "inverse_operator_gmres",
         "approximate_inverse_cg", "approximate_inverse_gmres",
         "schur_complement", "approximate_schur_complement",
         "shifted_schur_complement", "zero_mean", "zero_mean_weighted",
         "nested_schur_complement"]


@pytest.mark.parametrize("name", NAMES)
def test_combinator_matches_jax(name):
    rng = np.random.RandomState(NAMES.index(name))
    j, t, x, dense = _case(name, rng)
    want = np.asarray(j(jnp.asarray(x)))
    got = t(torch.as_tensor(x)).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= REL * scale, name
    if dense is not None:
        np.testing.assert_allclose(got, dense, rtol=0, atol=1e-7 * scale)
    if name.startswith("approximate_inverse"):
        assert got.shape == x.shape and np.isfinite(got).all()
