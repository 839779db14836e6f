"""The port's semi-Lagrangian temperature path on CPU, against the JAX
package:

  * the wide ghost padding (``pad_axis_width``) for every rule, f64,
    bitwise;
  * the transport (``semi_lagrangian_transport``) on the shell, f64, with
    displacements that clamp at +-K and fractional ones, K = 2 and 4, to
    1e-12 of the field's scale; the no-flow identity to 1e-12; no new
    extrema; its constants (cell widths, T's wall value);
  * K2m, the forcing without the fused transport: its plain version
    against the Pallas kernel ``ShellForcingPallas(advect_T=False)`` in
    interpret mode, f64, rtol = atol = 1e-12, three schemes and both
    projection modes;
  * whole steps of a `temperature advection = semi-lagrangian` model,
    f64: 1e-10 of the field scale after the first step, 1e-9 after 8, on
    the default, bench opt-in, direct, `residual check interval = 4` and
    `NSE solver interval = 2` paths;
  * ``multi_step`` against ``run`` (states and rows), the CLI with an SL
    copy of the classic prm, and its refusal of `solver diagnostics
    level` >= 3.

The CUDA kernel K2m runs only on a card: the ``cuda``-marked test holds
it, and the transport on the card, against the plain versions there.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu.ops import bc as jbc
from dycoreplanet_tpu.ops.pallas_stencil import make_shell_forcing
from dycoreplanet_tpu.ops.semi_lagrangian import (
    _center_spacing, semi_lagrangian_transport as j_sl)
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.convert import state_from_numpy
from dycoreplanet_tpu_torch.ops import bc as tbc
from dycoreplanet_tpu_torch.ops import forcing as k2
from dycoreplanet_tpu_torch.ops.semi_lagrangian import (
    SemiLagrangian, center_spacing, semi_lagrangian_transport as t_sl)
from tests.test_torch_kernels import _configure, _fields, _np, _rel, _t
from tests.test_torch_model import (
    OPT_INS, PRM, _max_rel, _params, _seeded_states)

SL = dict(temperature_advection="semi-lagrangian")
# the gate tolerances the fast path meets on the seeded flow at 4x8x16
GATE = dict(helmholtz_tol=1e-4, temperature_tol=1e-6)


def _port_specs(jm):
    """The port's T ghost rules with the JAX model's wall value."""
    wall = torch.as_tensor(np.array(jm.T_specs[0].lo_value))
    return [tbc.BCSpec(tbc.BC.DIRICHLET, tbc.BC.NEUMANN, lo_value=wall),
            tbc.BCSpec(tbc.BC.POLE, tbc.BC.POLE), None]


def _jmodel(shape, **num):
    return JModel(_params(JParameters, "float64", shape, **num))


# ------------------------------------------------------------- padding
@pytest.mark.parametrize("rule", ["NEUMANN", "DIRICHLET", "ANTISYM", "POLE",
                                  "POLE_FLIP", "periodic"])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_pad_axis_width_matches_jax(rule, width):
    """Ghost k mirrors interior cell k-1 at each end (the pole rules roll
    it by nlon/2 along lon); bitwise the JAX function's."""
    rng = np.random.default_rng(width)
    f = rng.standard_normal((5, 6, 8))
    value = rng.standard_normal((6, 8))
    for d in (0, 1):
        if rule == "periodic":
            want = jbc.pad_axis_width(jnp.asarray(f), d, None, True, width)
            got = tbc.pad_axis_width(torch.as_tensor(f), d, None, True, width)
        else:
            # the wall value, shaped for the unpadded later axes
            v = value if d == 0 else value[:1]
            want = jbc.pad_axis_width(
                jnp.asarray(f), d, jbc.BCSpec(getattr(jbc.BC, rule),
                                              getattr(jbc.BC, rule),
                                              jnp.asarray(v), jnp.asarray(v)),
                False, width)
            got = tbc.pad_axis_width(
                torch.as_tensor(f), d, tbc.BCSpec(
                    getattr(tbc.BC, rule), getattr(tbc.BC, rule),
                    torch.as_tensor(v), torch.as_tensor(v)), False, width)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ transport
def test_constants_match_jax():
    """The transport's constants: the cell widths per axis and T's inner
    wall value, as the JAX model has them."""
    jm = _jmodel((4, 8, 16), **SL)
    tm = BoussinesqModel(_params(Parameters, "float64", (4, 8, 16), **SL),
                         device="cpu")
    # the two packages' geometries agree to round-off (1 ulp)
    for d in range(3):
        np.testing.assert_allclose(center_spacing(tm.geo, d),
                                   _center_spacing(jm.geo, d), rtol=1e-14,
                                   atol=0)
    np.testing.assert_allclose(
        tm.T_specs[0].lo_value.numpy(),
        np.broadcast_to(np.asarray(jm.T_specs[0].lo_value),
                        tm.geo.cell_shape[1:]), rtol=1e-14, atol=0)
    h = tm._semi_lagrangian.tables("cpu", torch.float64)[0]
    np.testing.assert_array_equal(
        h.numpy(), np.stack([center_spacing(tm.geo, d) for d in range(3)]))


def _random_flow(geo, K, seed):
    """Cell velocities whose displacements dt u / h (dt = 1) clamp at +-K
    in a few cells and are fractional in most."""
    rng = np.random.default_rng(seed)
    h = np.stack([_center_spacing(geo, d) for d in range(3)])
    return 0.6 * K * h * rng.standard_normal((3,) + geo.cell_shape)


@pytest.mark.parametrize("shape", [(4, 8, 16), (6, 20, 36)])
@pytest.mark.parametrize("K", [2, 4])
def test_transport_matches_jax(shape, K):
    jm = _jmodel(shape)
    u = _random_flow(jm.geo, K, seed=K)
    f = np.asarray(jm.T_init) + 0.1 * np.random.default_rng(1).standard_normal(
        shape)
    h = np.stack([_center_spacing(jm.geo, d) for d in range(3)])
    s = np.abs(u / h)
    assert 0.0 < float((s >= K).mean()) < 0.2          # some clamp
    assert float(((s % 1) > 1e-3).mean()) > 0.8        # most fractional
    want = np.asarray(j_sl(jm.geo, jnp.asarray(u), jnp.asarray(f),
                           jm.T_specs, 1.0, ghost_width=K))
    got = t_sl(jm.geo, torch.as_tensor(u), torch.as_tensor(f),
               _port_specs(jm), 1.0, ghost_width=K).numpy()
    assert float(np.abs(got - want).max()) <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("K", [2, 4])
def test_no_flow_identity(K):
    jm = _jmodel((6, 20, 36))
    f = torch.as_tensor(np.random.default_rng(2).standard_normal(
        jm.geo.cell_shape))
    got = t_sl(jm.geo, torch.zeros((3,) + jm.geo.cell_shape,
                                   dtype=torch.float64), f,
               _port_specs(jm), 0.3, ghost_width=K)
    assert float((got - f).abs().max()) <= 1e-12


@pytest.mark.parametrize("K", [2, 4])
def test_no_new_extrema(K):
    """Each value is a convex combination of the padded field's: within
    its range, and a constant field with Neumann walls stays constant."""
    jm = _jmodel((6, 20, 36))
    geo = jm.geo
    u = torch.as_tensor(_random_flow(geo, K, seed=5))
    f = torch.as_tensor(np.random.default_rng(3).standard_normal(
        geo.cell_shape))
    specs = _port_specs(jm)
    got = t_sl(geo, u, f, specs, 1.0, ghost_width=K)
    padded = f
    for d in range(3):
        padded = tbc.pad_axis_width(padded, d, specs[d],
                                    geo.axes[d].periodic, K)
    assert float(got.min()) >= float(padded.min()) - 1e-14
    assert float(got.max()) <= float(padded.max()) + 1e-14
    neumann = [tbc.BCSpec(tbc.BC.NEUMANN, tbc.BC.NEUMANN), specs[1], None]
    const = t_sl(geo, u, torch.full(geo.cell_shape, 1.7, dtype=torch.float64),
                 neumann, 1.0, ghost_width=K)
    assert float((const - 1.7).abs().max()) <= 1e-14


def test_transport_tables_are_cached_per_device_and_dtype():
    jm = _jmodel((4, 8, 16))
    sl = SemiLagrangian(jm.geo, _port_specs(jm))
    a = sl.tables("cpu", torch.float64)
    assert sl.tables("cpu", torch.float64) is a
    h32, base, strides, corners = sl.tables("cpu", torch.float32)
    assert h32.dtype == torch.float32 and base.dtype == torch.int64
    # the padded field is (8, 12, 20): a cell's corners are its index
    # plus every combination of one row, one lat row and one lon column
    assert strides.flatten().tolist() == [240, 20, 1]
    assert corners.flatten().tolist() == [0, 1, 20, 21, 240, 241, 260, 261]
    assert int(base[0, 0, 0]) == 2 * 240 + 2 * 20 + 2


# ------------------------------------------------------------------ K2m
def _k2m_models(scheme, projection):
    jp = _configure(JParameters.from_text(""), "float64", (8, 8, 16),
                    scheme=scheme)
    tp = _configure(Parameters.from_text(""), "float64", (8, 8, 16),
                    scheme=scheme)
    for p in (jp, tp):
        p.numerics.temperature_advection = "semi-lagrangian"
        p.numerics.projection = projection
    return JModel(jp), BoussinesqModel(tp, device="cpu")


@pytest.mark.parametrize("scheme", ["muscl", "upwind", "centered"])
@pytest.mark.parametrize("projection", ["incremental", "pressure-free"])
def test_k2m_plain_vs_pallas_interpret_f64(scheme, projection):
    jm, tm = _k2m_models(scheme, projection)
    pall = make_shell_forcing(jm.geo, jm, interpret=True, use_pallas=True)
    assert pall is not None and not pall.advect_T
    assert not tm._forcing.advect_T
    assert tm._forcing.include_gradp == (projection == "incremental")
    u, f0, f1, f2, T, pres = _fields(jm, 3, np.float64)
    dt = 0.01
    want = pall(jnp.asarray(u), tuple(jnp.asarray(x) for x in (f0, f1, f2)),
                jnp.asarray(T), jnp.asarray(pres), dt)
    got = tm._forcing(torch.as_tensor(u), _t([f0, f1, f2]),
                      torch.as_tensor(T), torch.as_tensor(pres), dt)
    assert torch.is_tensor(got) and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    # the same momentum forcing as the fused K2's plain version
    fused = copy.copy(tm._forcing)
    fused.advect_T = True
    rhs_u, _ = fused(torch.as_tensor(u), _t([f0, f1, f2]),
                     torch.as_tensor(T), torch.as_tensor(pres), dt)
    assert torch.equal(rhs_u, got)
    assert tm._forcing.launches == 0


def test_k2m_traffic_and_shared_memory():
    """11 fields (46.1 MB at 32x128x256 f32, a 13.8 us bound at 3.35
    TB/s) against K2's 12; a block's shared memory holds 3 staged fields
    and their fluxes, not 4."""
    n = 32 * 128 * 256
    assert k2.MOMENTUM_FIELDS_MOVED * n * 4 / 3.35e12 * 1e6 == \
        pytest.approx(13.77, abs=0.01)
    assert (k2.shared_bytes(4), k2.shared_bytes(4, advect_T=False)) == (
        30856, 25192)
    assert (k2.shared_bytes(8), k2.shared_bytes(8, advect_T=False)) == (
        61712, 50384)


@pytest.mark.parametrize("kernel,wrapper", [
    ("void (anonymous namespace)::forcing_kernel<float, true>(Args<float>)",
     "forcing"),
    ("void (anonymous namespace)::forcing_kernel<float, false>(Args<float>)",
     "forcing_momentum"),
    ("void <unnamed>::forcing_kernel<double, (bool)0>(Args<double>)",
     "forcing_momentum"),
    ("void <unnamed>::forcing_kernel<double, (bool)1>(Args<double>)",
     "forcing"),
])
def test_forcing_kernel_names_map_to_wrappers(kernel, wrapper):
    """The profiler tells K2m from K2 by its ADVECT_T argument."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import wrapper_of
    assert wrapper_of(kernel) == wrapper


def test_sl_model_lists_k2m_and_no_fused_k2():
    tm = BoussinesqModel(_params(Parameters, "float64", (4, 8, 16), **SL),
                         device="cpu")
    assert "forcing_momentum" in tm.kernels()
    assert "forcing" not in tm.kernels()
    eu = BoussinesqModel(_params(Parameters, "float64", (4, 8, 16)),
                         device="cpu")
    assert "forcing" in eu.kernels() and eu._semi_lagrangian is None


# ---------------------------------------------------------- whole steps
def _sl_pair(nse_interval=1, **num):
    pj = _params(JParameters, "float64", **dict(num, **SL))
    pt = _params(Parameters, "float64", **dict(num, **SL))
    pj.NSE_solver_interval = pt.NSE_solver_interval = nse_interval
    return JModel(pj), BoussinesqModel(pt, device="cpu")


@pytest.mark.parametrize("path", ["default", "bench-opt-ins", "direct",
                                  "interval-4", "nse-2"])
def test_sl_steps_match_jax_f64(path):
    nse = 2 if path == "nse-2" else 1
    num = {"default": {}, "bench-opt-ins": OPT_INS,
           "direct": dict(OPT_INS, helmholtz_solver="direct"),
           "interval-4": dict(OPT_INS, residual_check_interval=4, **GATE),
           "nse-2": dict(OPT_INS, **GATE)}[path]
    jm, tm = _sl_pair(nse, **num)
    if path == "interval-4":
        # the JAX package's CPU path tracks every residual; its Pallas
        # Richardson kernels skip them between checks, as the port does
        assert jm.enable_pallas_richardson(interpret=True)
    js, ts = _seeded_states(jm, tm, seed=7)
    dt = 0.02
    for n in range(8):
        nse_step = ts.step_number % nse == 0
        js, jd = (jm.step if nse_step else jm.temperature_step)(js, dt)
        ts, td = (tm.step if nse_step else tm.temperature_step)(ts, dt)
        err = _max_rel(js, ts)
        assert err <= (1e-10 if n == 0 else 1e-9), (n, err)
        # cfl, max|u|, T range (packed in f32; on the direct path T_min is
        # a round-off value near 0: an absolute floor of 1e-14)
        np.testing.assert_allclose(td._h()[:4], np.asarray(jd.packed)[:4],
                                   rtol=1e-6, atol=1e-14)
        assert td.div_norm < max(2 * jd.div_norm, 1e-12)
        assert td.solver_ok == jd.solver_ok
        assert td.poisson_iters == jd.poisson_iters
        assert td.temperature_iters == jd.temperature_iters
        if path == "interval-4":
            assert (td.helmholtz_residual < 0) == (n % 4 != 0)
    assert ts.step_number == int(js.step_number) == 8
    assert ts.time == pytest.approx(float(js.time), rel=1e-14)
    assert tm._forcing.launches == 0       # CPU: the plain versions


def test_sl_step_strong_matches_jax():
    """The escalated (full-CG) step takes K2m and the transport too."""
    jm, tm = _sl_pair()
    js, ts = _seeded_states(jm, tm, seed=8)
    js, jd = jm.step_strong(js, 0.02)
    ts, td = tm.step_strong(ts, 0.02)
    assert _max_rel(js, ts) <= 1e-9
    assert td.solver_ok and jd.solver_ok


def test_sl_multi_step_equals_run():
    """multi_step against run from one state, with sub-cycling: the same
    states and the chunk's rows equal the run's records."""
    p = _params(Parameters, "float64", **dict(OPT_INS, **GATE, **SL))
    p.NSE_solver_interval = 2
    m = BoussinesqModel(p, device="cpu")
    s0 = m.initial_state()
    s_run, hist = m.run(max_steps=6, state=s0)
    s_ms, rows, _ = m.multi_step(s0, p.time_step, 6)
    for g, w in zip((s_ms.u, s_ms.p, s_ms.T) + tuple(s_ms.u_faces),
                    (s_run.u, s_run.p, s_run.T) + tuple(s_run.u_faces)):
        assert torch.equal(g, w)
    keys = ("cfl", "max_velocity", "T_min", "T_max", "div_norm",
            "poisson_iters", "temperature_iters")
    want = np.array([[h[k] for k in keys] for h in hist], np.float32)
    np.testing.assert_array_equal(rows[:, :7].numpy(), want)
    assert m.escalations == 0 and s_ms.step_number == 6


# ------------------------------------------------------------------ CLI
def _sl_prm(tmp_path):
    """The classic prm with semi-Lagrangian temperature transport, and a
    final time that lets 3 adaptive steps run."""
    prm = tmp_path / "classic-sl.prm"
    with open(PRM) as f:
        prm.write_text(f.read() + "\nsubsection Numerics\n"
                       "  set temperature advection = semi-lagrangian\n"
                       "end\nsubsection Boussinesq Model\n"
                       "  set final time = 10\nend\n")
    return str(prm)


@pytest.mark.parametrize("chunk", [[], ["--chunk", "2"]],
                         ids=["per-step", "chunk"])
def test_cli_runs_semi_lagrangian_on_cpu(capsys, tmp_path, chunk):
    from dycoreplanet_tpu_torch.cli.main import main

    rc = main(["-p", _sl_prm(tmp_path), "--max-steps", "3", "--no-output",
               "--device", "cpu"] + chunk)
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("Post-projection max |div u|") == 3


def test_cli_refuses_solver_diagnostics_level_3(capsys, tmp_path):
    """The residual trails of `solver diagnostics level` >= 3 are printed
    per step (the SL prm: the helmholtz and temperature Richardson
    solves); with --chunk the CLI refuses, as the trails work per step."""
    from dycoreplanet_tpu_torch.cli.main import main

    prm = tmp_path / "level3.prm"
    with open(_sl_prm(tmp_path)) as f:
        prm.write_text(f.read() + "\nsubsection Boussinesq Model\n"
                       "  set solver diagnostics level = 3\nend\n")
    assert main(["-p", str(prm), "--max-steps", "2", "--no-output",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("helmholtz richardson", "temperature richardson"):
        assert out.count(f"   [{name}] ||r|| trail (2 its): ") == 2
    assert main(["-p", str(prm), "--max-steps", "1", "--no-output",
                 "--device", "cpu", "--chunk", "2"]) == 1
    err = capsys.readouterr().err
    assert "solver diagnostics level >= 3) work per step" in err
    assert "without --chunk" in err


# ----------------------------------------------------------------- card
@pytest.mark.cuda
def test_cuda_k2m_and_transport_match_plain_versions():
    """On a card: K2m against its plain version (1e-5 x scale f32, 1e-12
    f64) at a shape no tile divides and one smaller than a tile, with no
    T_adv; the transport on the card against the same function in f64
    on the CPU (rel 1e-5 in f32); an SL model's step launches K2m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for shape in [(6, 20, 36), (4, 8, 16)]:
        for dtype, npd, tol in (("float32", np.float32, 1e-5),
                                ("float64", np.float64, 1e-12)):
            p = _params(Parameters, dtype, shape, **SL)
            m = BoussinesqModel(p, device="cuda")
            u, f0, f1, f2, T, pres = [torch.as_tensor(x, device="cuda")
                                      for x in _fields(m, 13, npd)]
            args = (u, (f0, f1, f2), T, pres, 0.004)
            got, want = m._forcing(*args), m._forcing.plain(*args)
            assert torch.is_tensor(got)
            assert _rel(got, want) <= tol
            assert m._forcing.launches == 1
            T_sl = m._advected_temperature(u, None, T, 0.3)
            cpu = SemiLagrangian(m.geo, [
                tbc.BCSpec(tbc.BC.DIRICHLET, tbc.BC.NEUMANN,
                           lo_value=torch.as_tensor(m.T_wall, dtype=torch.float64)),
                m.T_specs[1], None])
            ref = cpu(u.cpu().double(), T.cpu().double(), 0.3)
            assert _rel(T_sl.cpu().double(), ref) <= tol
            s, _ = m.step(state_from_numpy(m, _np(u), [_np(f) for f in
                                                      (f0, f1, f2)],
                                           _np(pres), _np(T)), 0.004)
            assert m._forcing.launches == 2
            assert bool(torch.isfinite(s.T).all())
