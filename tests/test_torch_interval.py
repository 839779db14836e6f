"""`residual check interval` > 1 in the port, on CPU: K1's residual-free
variant (K1u) — its plain version against the JAX package's Pallas
kernel with ``track_residual=False`` in interpret mode (8x16x32 f32;
iterates and faces rtol 1e-4, atol 1e-6, as tests/test_pallas_richardson.py
pins the two JAX variants; the Poisson right-hand side at the tracked
K1's tolerance), its
iterates bitwise equal to the tracked plain version's in f64, its launch
plan and operation count — the interval-mode step against the JAX model
with the Pallas Richardson kernel in interpret mode, the interval-mode
rewind of ``run`` (twin of tests/test_model.py), and ``run`` with NSE
and check intervals against the JAX package's ``run``."""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops.pallas_richardson import make_richardson
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.ops import richardson as k1
from dycoreplanet_tpu_torch.ops.richardson import ShellRichardson
from tests.test_torch_kernels import _models, _np, _rand_rhs
from tests.test_torch_model import _params

PAIRS = [(1, 1), (2, 1), (1, 3), (3, 3)]


def _k1(m, track, iters_u=None, iters_T=None):
    """K1 (track=True) or K1u of model m's configuration."""
    return ShellRichardson(
        m.geo, one_over_Re=m.one_over_Re, one_over_Pe=m.one_over_Pe,
        nse_interval=m.params.NSE_solver_interval, helm_diags=m.helm_diags,
        T_diag=m.T_diag, iters_u=iters_u or m.momentum_iters,
        iters_T=iters_T or m.params.numerics.fixed_solver_iters,
        u_specs=m.u_specs, T_specs_hom=m.T_specs_hom, track_residual=track)


# ---------------------------------------------------------------- K1u
@pytest.mark.parametrize("iters,iters_u", [(2, 1), (1, 1)])
def test_k1u_plain_matches_jax_residual_free_kernel(iters, iters_u):
    jm, tm = _models("float32", (8, 16, 32), iters=iters, iters_u=iters_u)
    kern = make_richardson(jm.geo, jm, interpret=True, use_pallas=True,
                           track_residual=False)
    assert kern is not None and not kern.track_residual
    rhs_u, rhs_T, T0 = _rand_rhs(jm, 3, np.float32)
    dt = np.float32(0.004)
    want = kern(*(jnp.asarray(x) for x in (rhs_u, rhs_T, T0)), dt)
    args = tuple(torch.as_tensor(x) for x in (rhs_u, rhs_T, T0)) + (
        float(dt),)
    got = _k1(tm, False).plain(*args)
    for g, w in zip((got[0], got[1]) + tuple(got[2][:3]),
                    (want[0], want[1]) + tuple(want[2][:3])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    # rhs_phi = -vol div(u*) / dt cancels: the tracked K1's tolerance
    # (tests/test_torch_kernels.py), relative to its scale
    scale = float(jnp.max(jnp.abs(want[2][3])))
    np.testing.assert_allclose(_np(got[2][3]), np.asarray(want[2][3]),
                               rtol=1e-4, atol=2e-5 * scale)
    rn_u, bn_u, rn_T, bn_T = (float(x) for x in got[3])
    assert rn_u == -1.0 and rn_T == -1.0              # the sentinel
    assert float(want[3][0]) == float(want[3][2]) == -1.0
    tracked = tm._richardson.plain(*args)[3]
    assert bn_u == float(tracked[1]) and bn_T == float(tracked[3])
    np.testing.assert_allclose([bn_u, bn_T],
                               [float(want[3][1]), float(want[3][3])],
                               rtol=1e-5)


@pytest.mark.parametrize("iters_u,iters_T", PAIRS)
def test_k1u_iterates_bitwise_f64(iters_u, iters_T):
    """Without the last residual update the iterates, faces and Poisson
    right-hand side are the tracked plain version's, bit for bit."""
    _, tm = _models("float64", (4, 8, 16))
    rhs_u, rhs_T, T0 = (torch.as_tensor(x)
                        for x in _rand_rhs(tm, 5, np.float64))
    a = _k1(tm, True, iters_u, iters_T).plain(rhs_u, rhs_T, T0, 0.004)
    b = _k1(tm, False, iters_u, iters_T).plain(rhs_u, rhs_T, T0, 0.004)
    for x, y in zip((a[0], a[1]) + tuple(a[2]), (b[0], b[1]) + tuple(b[2])):
        assert torch.equal(x, y)
    assert float(b[3][0]) == float(b[3][2]) == -1.0
    assert float(a[3][0]) > 0 and float(a[3][2]) > 0
    assert torch.equal(a[3][1], b[3][1]) and torch.equal(a[3][3], b[3][3])


@pytest.mark.parametrize("iters_u,iters_T", PAIRS)
def test_k1u_launch_plan_and_operations(iters_u, iters_T):
    """One pass with halo max(iters_u + 1, iters_T) (the JAX kernel's H
    without tracking; 2 for the bench's (1, 1), as tracked); under a
    small shared-memory limit the earlier passes keep max + 1 (their
    residual goes on to the next pass). One operator apply a sweep and
    channel fewer: 4 applies a cell at (1, 1) instead of 8."""
    shape = (32, 128, 256)
    for itemsize in (4, 8):
        trk = k1.plan(shape, itemsize, iters_u, iters_T)
        fr = k1.plan(shape, itemsize, iters_u, iters_T, track=False)
        assert len(trk) == len(fr) == 1
        assert trk[0].halo == max(iters_u, iters_T) + 1
        assert fr[0].halo == max(iters_u + 1, iters_T)
        assert fr[0].smem_bytes <= k1.kl.SMEM_PER_BLOCK - 16
        groups = k1.plan(shape, itemsize, 3 + iters_u, 3 + iters_T,
                         smem_limit=2500 * itemsize, track=False)
        assert len(groups) > 1
        for ps in groups[:-1]:
            assert ps.halo == max(ps.n_u, ps.n_T) + 1
        last = groups[-1]
        assert last.halo == max(last.n_u + 1, last.n_T)
        assert sum(ps.n_u for ps in groups) == 3 + iters_u
        assert sum(ps.n_T for ps in groups) == 3 + iters_T
    per = k1.OPS_PER_CHANNEL_APPLY
    assert (k1.ops_per_cell(iters_u, iters_T)
            - k1.ops_per_cell(iters_u, iters_T, track=False)) == 4 * per
    if (iters_u, iters_T) == (1, 1):
        assert k1.ops_per_cell(1, 1, track=False) == 4 * per \
            + k1.OPS_PER_CELL_HEAD
        assert k1.plan(shape, 4, 1, 1, track=False)[0].halo == 2


# ------------------------------------------------------ interval mode
def _seeded(m, seed=5):
    """tests/test_pallas_richardson.py's seeded velocity and its faces."""
    rng = np.random.RandomState(seed)
    u = jnp.asarray(0.05 * rng.randn(3, *m.geo.cell_shape), jnp.float32)
    faces = tuple(m._apply_wall_face_values(
        m._interp_component_to_faces(u[c], c), c) for c in range(3))
    return m.initial_state()._replace(u=u, u_faces=faces)


def test_residual_check_interval_step_semantics():
    """`residual check interval = 4` (twin of tests/test_pallas_richardson
    .py): the trajectory of the tracked-every-step model, bit for bit in
    the port (K1u's iterates are K1's), and the JAX model's with its
    Pallas Richardson kernel in interpret mode to f32 reassociation;
    real residuals on checked steps, the -1 sentinel with solver_ok in
    between."""
    from dycoreplanet_tpu_torch.models.convert import state_from_numpy

    jm4, t1 = _models("float32", (8, 16, 32), iters=2, iters_u=1)
    jm4.params.numerics.residual_check_interval = 4
    jm4.enable_pallas_richardson(interpret=True)
    assert jm4._richardson_fast is not None
    p4 = copy.deepcopy(t1.params)
    p4.numerics.residual_check_interval = 4
    t4 = BoussinesqModel(p4, device="cpu")
    assert t1._richardson_free is None and t4._richardson_free is not None
    dt = np.float32(0.002)
    js = _seeded(jm4)
    ts = state_from_numpy(t1, np.asarray(js.u),
                          [np.asarray(f) for f in js.u_faces],
                          np.asarray(js.p), np.asarray(js.T))
    sa = sb = ts
    for i in range(5):
        sa, da = t1.step(sa, float(dt))
        sb, db = t4.step(sb, float(dt))
        js, jd = jm4.step(js, dt)
        assert torch.equal(sa.u, sb.u) and torch.equal(sa.T, sb.T)
        np.testing.assert_allclose(_np(sb.u), np.asarray(js.u), rtol=5e-5,
                                   atol=5e-6)
        np.testing.assert_allclose(_np(sb.T), np.asarray(js.T), rtol=5e-5,
                                   atol=5e-6)
        assert db.solver_ok and jd.solver_ok
        if i % 4 == 0:       # step_number 0, 4: checked
            assert db.helmholtz_residual == da.helmholtz_residual >= 0.0
            assert db.temperature_residual >= 0.0
            np.testing.assert_allclose(db.helmholtz_residual,
                                       float(jd.helmholtz_residual),
                                       rtol=5e-2)
        else:                # in between: the "unchecked" sentinel
            assert db.helmholtz_residual == -1.0 == float(
                jd.helmholtz_residual)
            assert db.temperature_residual == -1.0
            assert da.helmholtz_residual >= 0.0


class TestIntervalRewind:
    """Port twin of tests/test_model.py::TestEscalationRearm's
    interval-mode tests."""

    def _model(self, rearm=3):
        p = _params(Parameters)
        p.NSE_solver_interval = 1
        p.numerics.helmholtz_tol = 1e-4
        p.numerics.temperature_tol = 1e-6
        assert p.numerics.fixed_solver_iters > 0
        m = BoussinesqModel(p, device="cpu")
        m._fast_rearm_steps = rearm
        m._fast_penalty_now = rearm
        return m

    def test_interval_mode_rewinds_unchecked_window(self):
        """A miss detected on a checked step discards the unchecked
        steps since the last verified state and redoes the whole window
        with full CG."""
        M = 4
        m = self._model(rearm=2)
        m.params.numerics.residual_check_interval = M
        calls = {"fast": [], "strong": []}
        real_step, real_strong = m.step, m.step_strong
        inject = {"armed": True}

        def fake_step(state, dt):
            sn = int(state.step_number)
            calls["fast"].append(sn)
            ns, diag = real_step(state, dt)
            vals = diag._h().copy()
            if sn % M != 0:
                # the residual-free variant: sentinel, solver_ok true
                vals[7] = -1.0
                vals[10] = 1.0
            elif sn == 8 and inject["armed"]:
                inject["armed"] = False
                vals[10] = 0.0          # checked-step miss
            diag._host_vals = vals
            return ns, diag

        def fake_strong(state, dt):
            calls["strong"].append(int(state.step_number))
            return real_strong(state, dt)

        m.step, m.step_strong = fake_step, fake_strong
        state, history = m.run(max_steps=12)
        # the whole unchecked window 5-8 is redone, not just step 8
        assert calls["fast"] == list(range(9)) + [9, 10, 11], calls
        assert calls["strong"] == [5, 6, 7, 8], calls
        assert [r["step"] for r in history] == list(range(12))
        assert np.allclose([r["time"] for r in history],
                           np.arange(12) * m.params.time_step)
        assert m._strong_steps_left == 0
        assert m._fast_penalty_now == m._fast_rearm_steps
        assert m.escalations == 1
        m_ref = self._model(rearm=2)
        state_ref, _ = m_ref.run(max_steps=12)
        np.testing.assert_allclose(_np(state.u), _np(state_ref.u),
                                   rtol=5e-3, atol=5e-5)
        np.testing.assert_allclose(_np(state.T), _np(state_ref.T),
                                   rtol=5e-3, atol=5e-5)

    def test_run_rearms_after_transient_miss(self):
        """Twin of test_run_rearms_after_transient_miss: one miss opens a
        window of full-CG steps, then the fast path returns."""
        m = self._model(rearm=3)
        calls = {"fast": [], "strong": []}
        real_step, real_strong = m.step, m.step_strong
        miss = {"armed": True}

        def fake_step(state, dt):
            calls["fast"].append(int(state.step_number))
            ns, diag = real_step(state, dt)
            if miss["armed"]:
                miss["armed"] = False
                vals = diag._h().copy()
                vals[10] = 0.0
                diag._host_vals = vals
            return ns, diag

        def fake_strong(state, dt):
            calls["strong"].append(int(state.step_number))
            return real_strong(state, dt)

        m.step, m.step_strong = fake_step, fake_strong
        m.run(max_steps=8)
        assert calls["fast"] == [0, 4, 5, 6, 7], calls
        assert calls["strong"] == [0, 1, 2, 3], calls
        assert m._strong_steps_left == 0
        assert m._fast_penalty_now == m._fast_rearm_steps


@pytest.mark.parametrize("nse_interval,check_interval",
                         [(2, 1), (1, 3), (2, 2)])
def test_run_matches_jax_with_intervals(nse_interval, check_interval):
    """``run`` with NSE sub-cycling and the check interval against the
    JAX package's run (f64; its CPU path tracks every residual, the
    port's K1u skips them in between: the iterates are the same)."""
    num = dict(helmholtz_tol=1e-4, temperature_tol=1e-6,
               residual_check_interval=check_interval)
    pj, pt = _params(JParameters, **num), _params(Parameters, **num)
    pj.NSE_solver_interval = pt.NSE_solver_interval = nse_interval
    jm, tm = JModel(pj), BoussinesqModel(pt, device="cpu")
    assert (tm._richardson_free is not None) == (check_interval > 1)
    _, jh = jm.run(max_steps=6)
    _, th = tm.run(max_steps=6)
    assert len(th) == len(jh) == 6
    for g, w in zip(th, jh):
        assert g["time"] == pytest.approx(w["time"], rel=1e-14)
        for key in ("cfl", "max_velocity", "T_min", "T_max"):
            assert g[key] == pytest.approx(w[key], rel=1e-9, abs=1e-14), key
        assert g["div_norm"] < max(2 * w["div_norm"], 1e-9)
        assert g["poisson_iters"] == w["poisson_iters"]
        assert g["temperature_iters"] == w["temperature_iters"]
    assert tm.escalations == 0
