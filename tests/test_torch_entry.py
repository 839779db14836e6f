"""The PyTorch port through its entry points, on CPU: the
``shell_3d_classic`` golden trajectory replayed through the port's
``step`` (at tests/test_golden.py's tolerances), the CLI, and the rule
that the package imports neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np

from tests.golden_trajectories import (
    CASES, GOLDEN_PATH, N_STEPS, SNAP_STEPS, _snapshot)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PRM = os.path.join(REPO, "data", "aqua_planet_shell_test_3d-classic.prm")


def _run_case_port(name):
    """tests/golden_trajectories.run_case, driving the port's model."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    case = CASES[name]
    p = Parameters.from_file(os.path.join(REPO, "data", case["prm"]))
    p.numerics.dtype = "float64"
    p.adapt_time_step = False
    for k, v in case["over"].items():
        setattr(p.numerics, k, v)
    m = BoussinesqModel(p, device="cpu")
    s = m.initial_state()
    rows, snaps = [], {}
    for k in range(N_STEPS):
        s, d = m.step(s, p.time_step)
        rows.append({"cfl": d.cfl, "max_velocity": d.max_velocity,
                     "T_min": d.T_min, "T_max": d.T_max,
                     "div_norm": d.div_norm})
        if (k + 1) in SNAP_STEPS:
            snaps[str(k + 1)] = _snapshot(s)
    return {"rows": rows, "fields": snaps}


def test_shell_classic_golden_through_port():
    name = "shell_3d_classic"
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)[name]
    got = _run_case_port(name)
    assert len(got["rows"]) == len(golden["rows"])
    for i, (g, w) in enumerate(zip(got["rows"], golden["rows"])):
        for key in ("cfl", "max_velocity", "T_min", "T_max"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-8, atol=1e-12,
                                       err_msg=f"step {i} {key}")
        assert g["div_norm"] < max(2 * w["div_norm"], 1e-9), i
    for step, want in golden["fields"].items():
        snap = got["fields"][step]
        for key in ("u", "p", "T"):
            w = np.asarray(want[key])
            scale = max(float(np.max(np.abs(w))), 1e-30)
            np.testing.assert_allclose(np.asarray(snap[key]), w, rtol=1e-7,
                                       atol=1e-10 * scale,
                                       err_msg=f"step {step} {key}")


def test_port_run_loop_short():
    """The port's own gated loop: 3 steps of the classic prm (adaptive
    dt), finite and divergence-free."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    p = Parameters.from_file(PRM)
    p.numerics.dtype = "float64"
    p.final_time = 1e9
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 8, 16
    m = BoussinesqModel(p, device="cpu")
    state, hist = m.run(max_steps=3)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert hist[1]["dt"] != hist[0]["dt"]          # adaptive dt engaged
    assert all(h["div_norm"] < 1e-9 for h in hist)
    assert state.step_number == 3
    import torch
    assert all(bool(torch.isfinite(x).all())
               for x in (state.u, state.p, state.T))


def test_cli_runs_on_cpu(capsys):
    from dycoreplanet_tpu_torch.cli.main import main

    rc = main(["-p", PRM, "--max-steps", "2", "--no-output",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Post-projection max |div u|" in out
    assert "Grid cells             : 4 x 8 x 16" in out


def test_cli_refuses_what_is_not_ported(capsys):
    from dycoreplanet_tpu_torch.cli.main import main

    assert main(["-p", PRM, "--max-steps", "1", "--device", "cpu"]) != 0
    assert "VTK output not yet ported" in capsys.readouterr().err
    assert main(["-p", PRM, "--no-output", "--chunk", "4",
                 "--device", "cpu"]) != 0
    assert "multi_step / --chunk" in capsys.readouterr().err
    assert main(["-p", PRM, "--no-output", "--restart", "ckpt",
                 "--device", "cpu"]) != 0
    assert "checkpoints not yet ported" in capsys.readouterr().err


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls
    in neither jax nor dycoreplanet_tpu (this process has both loaded:
    tests/conftest.py imports jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dycoreplanet_tpu_torch, dycoreplanet_tpu_torch.cli.main\n"
        "for m in pkgutil.walk_packages(dycoreplanet_tpu_torch.__path__,\n"
        "                               'dycoreplanet_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'dycoreplanet_tpu'\n"
        "       or k.startswith('dycoreplanet_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('dycoreplanet_tpu_torch')]))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok ")
    assert int(r.stdout.split()[1]) > 20
