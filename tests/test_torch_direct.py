"""The direct-Helmholtz shell step (``helmholtz solver = direct``) of the
PyTorch port against the JAX model's, on CPU at (4, 8, 16): whole steps
from the same seeded state (f64: 1 step to 1e-10, 8 steps to 1e-9 of the
field scale, under the default numerics and the bench opt-ins; f32: 1
step to 1e-5), the escalated ``step_strong`` (1e-9), the ``run`` loop's
records with the direct-solve sentinels, and the port's direct step
against its own CG step (the twin of tests/test_helmholtz.py
``test_direct_vs_cg_step``: atol 1e-9 for u and T, 1e-8 for p)."""

import numpy as np
import pytest
import torch

from tests.test_torch_model import (
    OPT_INS, _max_rel, _pair, _params, _seeded_states)
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel

DIRECT = dict(helmholtz_solver="direct")


@pytest.mark.parametrize("numerics", [DIRECT, {**DIRECT, **OPT_INS}],
                         ids=["default", "bench-opt-ins"])
def test_direct_steps_match_jax_f64(numerics):
    jm, tm = _pair("float64", **numerics)
    assert tm.helmholtz_direct is not None and tm._richardson is None
    js, ts = _seeded_states(jm, tm)
    dt = 0.02
    for n in range(8):
        js, jd = jm.step(js, dt)
        ts, td = tm.step(ts, dt)
        err = _max_rel(js, ts)
        assert err <= (1e-10 if n == 0 else 1e-9), (n, err)
        # cfl, max|u|, T range (packed in f32); T_min sits at a
        # round-off zero here, hence the absolute floor
        np.testing.assert_allclose(td._h()[:4], np.asarray(jd.packed)[:4],
                                   rtol=1e-6, atol=1e-12)
        assert td.div_norm < max(2 * jd.div_norm, 1e-12)
        assert td.solver_ok and jd.solver_ok
        # the direct solves' sentinels: iterations and residuals -1
        assert list(td.helmholtz_iters) == list(jd.helmholtz_iters) == [-1] * 3
        assert td.temperature_iters == jd.temperature_iters == -1
        assert td.helmholtz_residual == jd.helmholtz_residual == -1.0
        assert td.temperature_residual == jd.temperature_residual == -1.0
        assert td.poisson_iters == jd.poisson_iters
    launches = {k: v.launches for k, v in tm.kernels().items()}
    assert launches == {"forcing": 0, "faces_div": 0, "correct": 0,
                        "tridiag": 0}       # CPU: the plain versions


def test_direct_step_matches_jax_f32():
    jm, tm = _pair("float32", **DIRECT, **OPT_INS)
    js, ts = _seeded_states(jm, tm, seed=1)
    js, jd = jm.step(js, 0.02)
    ts, td = tm.step(ts, 0.02)
    assert _max_rel(js, ts) <= 1e-5
    assert td.solver_ok == jd.solver_ok


def test_direct_step_strong_matches_jax():
    """Escalated: Helmholtz and temperature stay direct, the Poisson
    solve becomes CG preconditioned by the fast diagonalization."""
    jm, tm = _pair("float64", **DIRECT, **OPT_INS)
    js, ts = _seeded_states(jm, tm, seed=2)
    js, jd = jm.step_strong(js, 0.02)
    ts, td = tm.step_strong(ts, 0.02)
    assert _max_rel(js, ts) <= 1e-9
    assert td.solver_ok and jd.solver_ok
    assert td.poisson_iters == jd.poisson_iters >= 1
    assert list(td.helmholtz_iters) == [-1] * 3


def test_direct_run_matches_jax():
    jm, tm = _pair("float64", **DIRECT, **OPT_INS)
    _, jh = jm.run(max_steps=3)
    _, th = tm.run(max_steps=3)
    assert len(th) == len(jh) == 3
    assert tm.escalations == 0
    for g, w in zip(th, jh):
        for key in ("cfl", "max_velocity", "T_min", "T_max"):
            assert g[key] == pytest.approx(w[key], rel=1e-9, abs=1e-14), key
        assert g["div_norm"] < max(2 * w["div_norm"], 1e-9)
        assert g["poisson_iters"] == w["poisson_iters"]
        assert g["temperature_iters"] == w["temperature_iters"] == -1


def test_direct_vs_cg_step():
    """Port twin of tests/test_helmholtz.py::test_direct_vs_cg_step
    (dim 3); the CG model takes the plain CG solves (fixed solver iters
    = 0), the path the JAX model falls back to."""
    def build(solver):
        p = Parameters.from_text("")
        p.space_dimension = 3
        p.cuboid_geometry = False
        p.initial_global_refinement = 3
        p.time_step = 0.01
        p.numerics.dtype = "float64"
        p.numerics.helmholtz_solver = solver
        p.numerics.fixed_solver_iters = 0
        p.numerics.temperature_tol = 1e-14
        p.numerics.helmholtz_tol = 1e-14
        p.numerics.max_cg_iters = 2000
        return BoussinesqModel(p, device="cpu")

    m_dir, m_cg = build("direct"), build("cg")
    assert m_dir.helmholtz_direct is not None and m_cg.helmholtz_direct is None
    s_dir, s_cg = m_dir.initial_state(), m_cg.initial_state()
    for _ in range(3):
        s_dir, _ = m_dir.step(s_dir, 0.01)
        s_cg, _ = m_cg.step(s_cg, 0.01)
    for a, b, atol in ((s_dir.u, s_cg.u, 1e-9), (s_dir.T, s_cg.T, 1e-9),
                       (s_dir.p, s_cg.p, 1e-8)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol)


def test_direct_ignores_fixed_iteration_counts():
    """The direct solves take no Richardson counts: `momentum fixed
    iters > 0` beside `fixed solver iters = 0`, refused on the iterative
    path, runs here as in the JAX model."""
    m = BoussinesqModel(_params(Parameters, fixed_solver_iters=0,
                                momentum_fixed_iters=1, **DIRECT),
                        device="cpu")
    _, d = m.step(m.initial_state(), m.params.time_step)
    assert d.solver_ok and list(d.helmholtz_iters) == [-1] * 3


def test_direct_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BoussinesqModel(_params(Parameters, **DIRECT))
