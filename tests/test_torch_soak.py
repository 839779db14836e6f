"""scripts/torch_soak_production.py, the port's production soak, against
the JAX package's chain of scripts/soak_production.py on the CPU at a
small size in f64: the production prm (2D: the annulus's projection
path, as in the JAX package) at 4 x 512 and the 3D shell variant (``--scale3d``) at 4 x 32 x 64, 4 chunks of 2
steps each (dt 0.002, then the adaptive CFL dt). Both packages' models
are built from the script's ``soak_params`` on their own ``Parameters``;
the JAX chain is the JAX script's loop (``multi_step`` with
``collect_diagnostics=False``). Held: every chunk's record (dt, cfl,
max_u, T range, div, solver_ok) and the final state; the checkpoint
round trip and the resume bitwise on the CPU, also after an escalation
that falls after the checkpoint; the script's output and exit code."""

import importlib.util
import json
import os
import re
import warnings

import numpy as np
import pytest

from dycoreplanet_tpu.base.params import Parameters as JParameters
from dycoreplanet_tpu.models import make_model as j_make_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_soak_production.py")

_spec = importlib.util.spec_from_file_location("torch_soak_production",
                                               SCRIPT)
soak = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(soak)

STEPS, CHUNK = 8, 2
CASES = {"2d": dict(scale3d=False, shape=(4, 512)),
         "3d": dict(scale3d=True, shape=(4, 32, 64))}
# f64 records are packed in f32: the same f32 value, or the next one
RECORD_RTOL = 1e-6
# the post-projection divergence is round-off (~1e-13): held to this
# fraction of max_u
DIV_ATOL = 1e-11
# the final state, relative to each field's scale (f64 round-off)
STATE_RTOL = 1e-9


def _jax_chain(case):
    """The JAX script's loop on the JAX model of the same parameters:
    (records, final state)."""
    m = j_make_model(soak.soak_params(JParameters, dtype="float64",
                                      **CASES[case]))
    state = m.initial_state()
    dt = np.asarray(soak.FIRST_DT, m.dtype)
    records = []
    for c in range(STEPS // CHUNK):
        state, packed, dt = m.multi_step(state, dt, CHUNK,
                                         collect_diagnostics=False,
                                         adaptive=c > 0)
        records.append(soak.record_of((c + 1) * CHUNK,
                                      float(np.asarray(dt)),
                                      np.asarray(packed[-1])))
    return records, state


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    case = request.param
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        port = soak.soak(STEPS, CHUNK, device="cpu", dtype="float64",
                         **CASES[case])
    return case, port, _jax_chain(case)


def test_chunk_records_match_jax(runs):
    """Every chunk's record of the port's soak equals the JAX chain's:
    dt within 1e-12, cfl, max_u and the T range within RECORD_RTOL, div
    within DIV_ATOL x max_u, solver_ok equal."""
    case, port, (jrec, _) = runs
    assert len(port["records"]) == len(jrec) == STEPS // CHUNK
    for got, want in zip(port["records"], jrec):
        assert got["step"] == want["step"]
        assert got["solver_ok"] == want["solver_ok"], (case, got, want)
        assert got["dt"] == pytest.approx(want["dt"], rel=1e-12)
        for k in ("cfl", "max_u", "T_min", "T_max"):
            assert got[k] == pytest.approx(want[k], rel=RECORD_RTOL,
                                           abs=1e-30), (case, k)
        assert abs(got["div"] - want["div"]) <= DIV_ATOL * want["max_u"]
    # the adaptive dt took over after the first chunk
    assert port["records"][0]["dt"] == soak.FIRST_DT
    assert port["records"][-1]["dt"] != soak.FIRST_DT


def test_final_state_matches_jax(runs):
    """The final state of the port's first run against the JAX chain's,
    each field within STATE_RTOL of its scale; the same step count."""
    case, port, (_, jstate) = runs
    final = port["final"]
    assert int(final.step_number) == int(jstate.step_number) == STEPS
    pairs = [("u", final.u, jstate.u), ("p", final.p, jstate.p),
             ("T", final.T, jstate.T)] + [
        (f"u_faces[{d}]", a, b)
        for d, (a, b) in enumerate(zip(final.u_faces, jstate.u_faces))]
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-300)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=STATE_RTOL * scale,
                                   err_msg=f"{case} {name}")
    assert float(final.time) == pytest.approx(float(jstate.time),
                                              rel=1e-12)


def test_resume_is_bitwise(runs):
    """The checkpoint round trip (else the soak raises) and the resumed
    second half bitwise the first run's; the summary ok; no chunk ran as
    a CUDA graph on the CPU."""
    case, port, _ = runs
    s = port["summary"]
    assert s["bitwise_resume"] and s["ok"], (case, s)
    assert soak.same_state(port["final"], port["resumed"])
    assert port["replays"] == []
    assert port["gate"]["strong_steps_left"] == 0


def _corrupt_at(k0):
    """A before_chunk hook: the fast-diagonalization constant tripled for
    chunk k0 alone (as chip_smoke.py's phase 5 corrupts it), so that the
    Poisson spot-check misses there and the chunk is redone with CG."""
    orig = {}

    def hook(model, c):
        ps = model.poisson_spectral
        orig.setdefault("inv", ps._inv_denom)
        ps._inv_denom = 3.0 * orig["inv"] if c == k0 else orig["inv"]
        ps.to(model.device)
    return hook


# 6 chunks of 2: the checkpoint after chunk 3, the miss in chunk 5 (index
# 4); its window of 8 steps is still open at the end (4 steps left)
ESC = dict(steps=12, chunk=2, scale3d=True, shape=(4, 32, 64),
           device="cpu", dtype="float64")


@pytest.mark.parametrize("restore", [True, False],
                         ids=["gate-restored", "jax-resume"])
def test_escalation_after_the_checkpoint(monkeypatch, restore):
    """A forced miss after the checkpoint escalates once. The port's
    soak saves the gate's state with the checkpoint (no window open
    there) and restores it: the resume is bitwise. Resumed with the
    gate's state of the run's end (the restore replaced by nothing), as
    the JAX script resumes on its model, the resume opens in the
    escalation window and runs the chunk the first run ran fast with CG:
    not bitwise (ROADMAP.md Queue 3)."""
    if not restore:
        monkeypatch.setattr(soak, "set_gate_state", lambda model, gate: None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = soak.soak(**ESC, before_chunk=_corrupt_at(4))
    assert out["escalations"] == 1
    assert any("retrying chunk with full CG" in str(w.message)
               for w in caught)
    assert out["gate"] == {"strong_steps_left": 0, "fast_penalty_now": 8,
                           "escalations": 0}
    assert all(r["solver_ok"] for r in out["records"])
    assert out["summary"]["bitwise_resume"] is restore
    assert out["summary"]["ok"] is restore
    if restore:
        assert soak.gate_state(out["model"]) == {
            "strong_steps_left": 4, "fast_penalty_now": 16,
            "escalations": 1}


def test_float32_time_round_trips():
    """In float32 the state's time is a float32 sum of the steps' dt, as
    the JAX package's is (tests/test_torch_graft_entry.py holds it equal
    to JAX's), so that the checkpoint (time in the fields' dtype) holds it
    exactly: a float32 soak whose checkpoint falls after adaptive chunks
    (a time a float64 sum would not hold in float32) round-trips and
    resumes bitwise."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = soak.soak(12, 2, scale3d=True, shape=CASES["3d"]["shape"],
                        device="cpu", dtype="float32")
    assert out["summary"]["bitwise_resume"] and out["summary"]["ok"]
    t = float(out["final"].time)
    assert t == float(np.float32(t))
    dts = [r["dt"] for r in out["records"]]
    assert len(set(dts)) > 2        # adaptive chunks before the checkpoint


def _jax_summary_keys():
    """The keys of the JAX script's summary, read from its source."""
    with open(os.path.join(REPO, "scripts", "soak_production.py")) as f:
        text = f.read()
    block = text[text.index("summary = {"):]
    block = block[:block.index("\n    }")]
    return re.findall(r'^\s+"(\w+)":', block, re.M)


def test_command_line(tmp_path, capsys):
    """The script's command line at the small 2D size: the replay line,
    then the JSON summary with the JAX script's keys, the trajectory on
    stderr in the JAX script's lines, rc 0; --ckpt where asked, with dt
    and the gate's state in its metadata."""
    ckpt = str(tmp_path / "soak.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rc = soak.main(["--steps", str(STEPS), "--chunk", str(CHUNK),
                        "--device", "cpu", "--shape", "4x512", "--dtype",
                        "float64", "--ckpt", ckpt])
    out, err = capsys.readouterr()
    assert rc == 0
    lines = out.strip().splitlines()
    assert lines[-2].startswith("soak: chunks [] of 4 ran as CUDA graph "
                                "replays")
    summary = json.loads(lines[-1])
    keys = _jax_summary_keys()
    assert len(keys) == 13 and list(summary) == keys
    assert summary["grid"] == [4, 512] and summary["steps"] == STEPS
    traj = [ln for ln in err.splitlines() if ln.startswith("  step ")]
    assert len(traj) == STEPS // CHUNK
    assert re.match(r"  step +2: cfl=\S+ max\|u\|=\S+ T=\[\S+,\S+\] "
                    r"div=\S+$", traj[0])
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    assert meta["chunk"] == 2 and meta["dt"] > 0
    assert meta["gate"] == {"strong_steps_left": 0, "fast_penalty_now": 8,
                            "escalations": 0}


def test_shape_and_steps_refused():
    """Steps that are not a multiple of the chunk, or a single chunk (no
    checkpoint halfway), are refused before a model is built."""
    for steps, chunk in ((7, 2), (2, 2)):
        with pytest.raises(ValueError, match="multiple of --chunk"):
            soak.soak(steps, chunk, device="cpu", shape=(4, 64))
