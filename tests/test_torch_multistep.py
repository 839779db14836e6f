"""The port's ``multi_step`` (and the CLI's ``--chunk``) on CPU: against
the port's own step loop (f64, bitwise up to atol 1e-14), against the JAX
package's ``multi_step`` for 8 steps (f64, 1e-9 of the field scale; NSE
interval sub-cycling, adaptive dt, no collected diagnostics), the
temperature substep against JAX, the chunk-level gate (a forced miss
redoes the chunk with CG from the original state) and the escalation
window's countdown. The CUDA graph of a chunk runs only on a card: the
``cuda``-marked test holds it against the eager loop there."""

import os

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import BoussinesqModel as JModel
from dycoreplanet_tpu_torch.models.convert import state_from_numpy
from tests.test_torch_model import (
    OPT_INS, PRM, _max_rel, _params, _seeded_states)

# tolerances the fast path meets on the seeded flow at 4x8x16 (its
# tracked residuals are ~1e-7 / 1e-9 of |b|), so that no chunk escalates
GATE = dict(helmholtz_tol=1e-4, temperature_tol=1e-6)
DT = 0.02
FIELDS = ("u", "p", "T")


def _fields(s):
    return [getattr(s, k) for k in FIELDS] + list(s.u_faces)


def _model(nse_interval=1, dtype="float64", shape=(4, 8, 16),
           device="cpu", **num):
    p = _params(Parameters, dtype, shape, **num)
    p.NSE_solver_interval = nse_interval
    return BoussinesqModel(p, device=device)


def _pair(nse_interval=1, **num):
    """The JAX model and the port's from the same f64 parameters."""
    p = _params(JParameters, "float64", **num)
    p.NSE_solver_interval = nse_interval
    return JModel(p), _model(nse_interval, **num)


def _port_state(m, seed=0):
    """A seeded flow built by the port alone: random velocity and its
    interpolated faces, a random pressure, the initial temperature."""
    rng = np.random.default_rng(seed)
    shp = m.geo.cell_shape
    u = 0.05 * rng.standard_normal((3,) + shp)
    s = state_from_numpy(m, u, [np.zeros(shp)] * 3,
                         0.01 * rng.standard_normal(shp), m.T_init)
    return s._replace(u_faces=m.interp_to_faces(s.u))


def _step_loop(m, s, dt, n):
    """n steps through step / temperature_step, dispatched as
    multi_step dispatches them; returns the state and the packed rows."""
    rows = []
    for _ in range(n):
        nse = s.step_number % m.params.NSE_solver_interval == 0
        s, d = (m.step if nse else m.temperature_step)(s, dt)
        rows.append(d.packed)
    return s, torch.stack(rows)


@pytest.mark.parametrize("nse_interval,numerics", [
    (1, GATE), (3, GATE), (1, dict(OPT_INS, **GATE)),
    (2, dict(OPT_INS, helmholtz_solver="direct")),
], ids=["default", "nse3", "bench-opt-ins", "direct-nse2"])
def test_multi_step_matches_step_loop(nse_interval, numerics):
    m = _model(nse_interval, **numerics)
    s0 = _port_state(m)
    want, rows = _step_loop(m, s0, DT, 6)
    got, packed, dt_out = m.multi_step(s0, DT, 6)
    for g, w in zip(_fields(got), _fields(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_array_equal(packed.numpy(), rows.numpy())
    assert (got.time, got.step_number) == (want.time, want.step_number)
    assert dt_out == DT and m.escalations == 0
    # without collected diagnostics: the last row, solver_ok the AND
    _, last, _ = m.multi_step(s0, DT, 6, collect_diagnostics=False)
    assert tuple(last.shape) == (1, rows.shape[1])
    np.testing.assert_array_equal(last[0, :10].numpy(), rows[-1, :10].numpy())
    np.testing.assert_array_equal(last[0, 11:].numpy(), rows[-1, 11:].numpy())
    assert float(last[0, 10]) == float(rows[:, 10].min()) == 1.0


@pytest.mark.parametrize("case", ["plain", "nse3", "adaptive", "no-collect"])
def test_multi_step_matches_jax(case):
    jm, tm = _pair(3 if case == "nse3" else 1, **GATE)
    js, ts = _seeded_states(jm, tm, seed=3)
    kw = dict(adaptive=case == "adaptive",
              collect_diagnostics=case != "no-collect")
    js, jrows, jdt = jm.multi_step(js, DT, 8, **kw)
    ts, trows, tdt = tm.multi_step(ts, DT, 8, **kw)
    assert _max_rel(js, ts) <= 1e-9
    jrows = np.asarray(jrows)
    assert trows.shape == jrows.shape
    # cfl, max|u|, T range (packed in f32); the iteration counts; the
    # divergence is a round-off residual: bound it
    np.testing.assert_allclose(trows[:, :4].numpy(), jrows[:, :4],
                               rtol=1e-6, atol=1e-30)
    np.testing.assert_array_equal(trows[:, 5:7].numpy(), jrows[:, 5:7])
    np.testing.assert_array_equal(trows[:, 10:].numpy(), jrows[:, 10:])
    assert np.all(trows[:, 4].numpy() < np.maximum(2 * jrows[:, 4], 1e-12))
    assert tdt == pytest.approx(float(jdt), rel=1e-14, abs=0)
    if case == "adaptive":
        assert tdt != DT
    assert ts.step_number == int(js.step_number) == 8
    assert ts.time == pytest.approx(float(js.time), rel=1e-14)
    assert tm.escalations == 0


def test_temperature_step_matches_jax():
    """The temperature-only substep freezes u and advances time by
    dt / interval (twin of tests/test_model.py TestSubcycling)."""
    jm, tm = _pair(2, **GATE)
    js, ts = _seeded_states(jm, tm, seed=4)
    js, _ = jm.step(js, DT)
    ts, _ = tm.step(ts, DT)
    j2, jd = jm.temperature_step(js, DT)
    t2, td = tm.temperature_step(ts, DT)
    assert _max_rel(j2, t2) <= 1e-12
    assert torch.equal(t2.u, ts.u) and torch.equal(t2.p, ts.p)
    assert float((t2.T - ts.T).abs().max()) > 0
    assert t2.step_number == 2 == int(j2.step_number)
    assert t2.time == pytest.approx(ts.time + DT / 2, rel=1e-14)
    np.testing.assert_allclose(td._h()[:4], np.asarray(jd.packed)[:4],
                               rtol=1e-6, atol=1e-30)
    assert (td.poisson_iters, td.temperature_iters, td.solver_ok) == (
        0, jd.temperature_iters, True)
    assert list(td.helmholtz_iters) == [0, 0, 0]
    # the strong substep takes CG for temperature
    t3, d3 = tm.temperature_step_strong(ts, DT)
    assert d3.solver_ok and d3.temperature_iters != td.temperature_iters
    np.testing.assert_allclose(t3.T.numpy(), t2.T.numpy(), rtol=0,
                               atol=1e-6)


def _gated_model(**num):
    """The classic prm at 4x8x16 f64 whose fast path meets its gate
    (tests/test_torch_model.py TestSpectralResidualCheck)."""
    p = _params(Parameters, **num)
    p.numerics.helmholtz_tol = 1e-4
    p.numerics.temperature_tol = 1e-6
    return BoussinesqModel(p, device="cpu")


def test_forced_miss_redoes_chunk_with_cg():
    """A corrupted fast-diagonalization constant trips the Poisson
    spot-check inside the chunk: the whole chunk is redone with full CG
    from the ORIGINAL state and equals a step_strong loop."""
    m = _gated_model()
    m.poisson_spectral._inv_denom = 3.0 * m.poisson_spectral._inv_denom
    m.poisson_spectral.to(m.device)
    s0 = m.initial_state()
    with pytest.warns(RuntimeWarning, match="retrying chunk with full CG"):
        got, rows, _ = m.multi_step(s0, m.params.time_step, 4)
    assert m.escalations == 1
    assert m._strong_steps_left == m._fast_rearm_steps - 4
    assert bool((rows[:, 10] == 1).all())
    assert all(int(r[5]) > 0 for r in rows)      # CG Poisson iterations
    want = s0
    for _ in range(4):
        want, _ = m.step_strong(want, m.params.time_step)
    for g, w in zip(_fields(got), _fields(want)):
        assert torch.equal(g, w)
    assert float(rows[:, 4].max()) < 1e-6


def test_multi_step_window_counts_down():
    """Twin of tests/test_model.py::TestEscalationRearm::
    test_multi_step_window_counts_down."""
    m = _gated_model()
    m._fast_rearm_steps = m._fast_penalty_now = 4
    s = m.initial_state()
    m._strong_steps_left = 4          # escalation window open
    s, _, _ = m.multi_step(s, m.params.time_step, 3)
    assert m._strong_steps_left == 1  # 3 clean strong steps served
    m.multi_step(s, m.params.time_step, 3)
    assert m._strong_steps_left == 0  # window closed, re-armed
    assert m.escalations == 0


def _div_lines(out):
    return [ln.strip() for ln in out.splitlines() if "Post-projection" in ln]


def test_cli_chunk_matches_per_step(capsys, tmp_path):
    """`--chunk 4 --max-steps 8` prints the per-step divergence lines of
    `--chunk 1`: the classic prm in float64 with a later final time, so
    that 8 adaptive steps run, and gate tolerances that the fast path
    meets there, also on the second step, whose adaptive dt is 1.53 (the
    per-step loop, as the JAX package's, does not gate; a missed chunk
    would be redone with CG)."""
    from dycoreplanet_tpu_torch.cli.main import main

    prm = tmp_path / "classic-f64.prm"
    with open(PRM) as f:
        prm.write_text(f.read() + "\nsubsection Boussinesq Model\n"
                       "  set final time = 10\nend\n"
                       "subsection Numerics\n  set dtype = float64\n"
                       "  set helmholtz tol = 1e-2\n"
                       "  set temperature tol = 1e-3\nend\n")
    lines = {}
    for chunk in (1, 4):
        rc = main(["-p", str(prm), "--max-steps", "8", "--chunk", str(chunk),
                   "--no-output", "--device", "cpu"])
        assert rc == 0
        lines[chunk] = _div_lines(capsys.readouterr().out)
    assert len(lines[4]) == 8
    assert lines[4] == lines[1]


def test_cli_chunk_classic_prm():
    """The acceptance command: the classic prm as it is, chunks of 4."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "dycoreplanet_tpu_torch", "-p", PRM,
         "--max-steps", "8", "--chunk", "4", "--no-output", "--device",
         "cpu"], cwd=repo, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "Post-projection max |div u|" in r.stdout


def test_chunk_graphs_keep_at_most_max_graphs(monkeypatch):
    """The graph cache's policy, on CPU with the capture replaced by a
    stand-in that copies its inputs through: at most ``max_graphs``
    graphs kept, the least recently replayed dropped first, a kept key
    captured once; each chunk still advances the state's step count and
    time."""
    from dycoreplanet_tpu_torch.models import graphs

    class NoGraph:
        def replay(self):
            pass

    made = []

    def capture(self, state, dt, n_steps, collect):
        made.append(n_steps)
        self.captures += 1
        fields = (state.u,) + tuple(state.u_faces) + (state.p, state.T)
        inputs = tuple(f.clone() for f in fields)
        return graphs.CapturedChunk(NoGraph(), inputs,
                                    inputs + (torch.zeros(1, 14),))

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(graphs.ChunkGraphs, "_capture", capture)
    m = _model(**GATE)
    s0 = _port_state(m)
    g = graphs.ChunkGraphs(m)
    g.max_graphs = 2
    for n in (1, 2, 1, 3, 2, 1):
        s, packed, dt = g.run(s0, DT, n, True)
        assert s.step_number == s0.step_number + n
        assert s.time == pytest.approx(s0.time + n * DT, rel=1e-14)
        assert torch.equal(s.u, s0.u) and s.u is not s0.u
    assert made == [1, 2, 3, 2, 1]
    assert (g.captures, g.replays, len(g)) == (5, 6, 2)
    assert [key[0] for key in g._chunks] == [2, 1]


@pytest.mark.parametrize("kernel,wrapper", [
    ("void (anonymous namespace)::forcing_kernel<float>(Args<float>)",
     "forcing"),
    ("void (anonymous namespace)::rich_fused<float, 8, 8, 32, 2, true>"
     "(Pass<float>)", "richardson"),
    ("void (anonymous namespace)::rich_fused<float, 8, 8, 32, 2, false>"
     "(Pass<float>)", "richardson_free"),
    ("void <unnamed>::rich_fused<double, (int)4, (int)4, (int)16, (int)1, "
     "(bool)0>(Pass<double>)", "richardson_free"),
    ("void faces_div_kernel<float>(Dims, float const*)", "faces_div"),
    ("void shell::reduce_partials<float, 256>(float const*, int)", None),
    ("void correct_kernel<double>(Dims, double const*)", "correct"),
    ("void (anonymous namespace)::thomas_staged<float, 1>(Args<float>)",
     "tridiag"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32", None),
])
def test_device_kernel_names_map_to_wrappers(kernel, wrapper):
    """The profiler's kernel names, as the replay counts read them: K1
    and K1u by their TRACK argument, K3's reduction and library kernels
    belonging to no wrapper."""
    from dycoreplanet_tpu_torch.diagnostics.device_time import wrapper_of
    assert wrapper_of(kernel) == wrapper


def test_ptxas_summary_reads_the_saved_build_log(tmp_path, monkeypatch):
    """A library built by an earlier process keeps nvcc's output beside
    it, so a later process (a second chip_smoke.py run on one tree)
    still reads each kernel's registers and spills."""
    from dycoreplanet_tpu_torch.ops import kernel_lib as kl
    monkeypatch.setattr(kl, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kl, "BUILD_LOG", {})
    src = "richardson.cu"
    assert kl.ptxas_summary(src) == []
    with open(f"{kl.lib_path(src)}.log", "w") as f:
        f.write("ptxas info    : Compiling entry function "
                "'_ZN12_GLOBAL__N_19rich_fusedIfLi8ELi8ELi32ELi2ELb0EEEv' "
                "for 'sm_90a'\n"
                "ptxas info    : Function properties for x\n"
                "    0 bytes stack frame, 0 bytes spill stores, "
                "0 bytes spill loads\n"
                "ptxas info    : Used 96 registers, 16 bytes smem\n")
    (row,) = kl.ptxas_summary(src)
    assert "rich_fused" in row["kernel"]
    assert (row["registers"], row["stack_bytes"], row["spill_stores"],
            row["spill_loads"], row["smem_bytes"]) == (96, 0, 0, 0, 16)


@pytest.mark.cuda
def test_cuda_graph_matches_eager_loop():
    """On a card: multi_step as a CUDA graph against the eager step loop
    from the same state (f32, bench opt-ins; the same kernels in the same
    order, so bitwise), on the default, interval (M = 4, NSE interval 2)
    and direct paths. The replay calls no kernel wrapper, and the hand
    kernels it runs on the device (counted by torch.profiler) are those
    the eager loop's wrappers launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graph path has no CPU mode")
    from dycoreplanet_tpu_torch.diagnostics.device_time import (
        device_launches)
    for num, nse in ((dict(OPT_INS), 1),
                     (dict(OPT_INS, residual_check_interval=4), 2),
                     (dict(OPT_INS, helmholtz_solver="direct"), 1)):
        m = _model(nse, "float32", (8, 16, 32), "cuda", **num)
        s0 = _port_state(m)
        want, rows = _step_loop(m, s0, DT, 8)
        eager = {k: v.launches for k, v in m.kernels().items()}
        m.multi_step(s0, DT, 8)                      # capture + replay
        for k in m.kernels().values():
            k.launches = 0
        (got, packed, _), on_device = device_launches(
            lambda: m.multi_step(s0, DT, 8), m.kernels())   # one replay
        assert m.chunk_graphs.captures == 1 and m.chunk_graphs.replays == 2
        assert all(v.launches == 0 for v in m.kernels().values())
        assert on_device == eager
        for g, w in zip(_fields(got), _fields(want)):
            assert torch.equal(g, w)
        assert torch.equal(packed, rows)
        assert m.escalations == 0
