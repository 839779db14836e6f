"""The PyTorch port through its entry points, on CPU: the golden
trajectories, all nine (``shell_3d_classic``, ``annulus_2d``,
``aqua_planet_production``, ``aqua_planet_production_dynamic``, the FEEC
and coupled ``shell_3d_feec`` and ``annulus_2d_coupled``, the cube's
``cube_3d_feec``, and the mimetic ``cube_3d_feec_staggered`` and
``shell_3d_feec_staggered``) replayed through the port's ``make_model``
and ``step`` (at tests/test_golden.py's tolerances), the CLI, and the rule that the
package imports neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.golden_trajectories import (
    CASES, GOLDEN_PATH, N_STEPS, SNAP_STEPS, _snapshot)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PRM = os.path.join(REPO, "data", "aqua_planet_shell_test_3d-classic.prm")


def _run_case_port(name):
    """tests/golden_trajectories.run_case, driving the port's model."""
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import make_model

    case = CASES[name]
    p = Parameters.from_file(os.path.join(REPO, "data", case["prm"]))
    p.numerics.dtype = "float64"
    p.adapt_time_step = False
    for k, v in case["over"].items():
        setattr(p.numerics, k, v)
    m = make_model(p, device="cpu")
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


@pytest.mark.parametrize("name", [
    "shell_3d_classic", "annulus_2d", "aqua_planet_production",
    "aqua_planet_production_dynamic", "shell_3d_feec", "annulus_2d_coupled",
    "cube_3d_feec", "cube_3d_feec_staggered", "shell_3d_feec_staggered"])
def test_shell_classic_golden_through_port(name):
    """The goldens of every configuration (the shell, the annulus and the
    cube: the standard personality, the FEEC shell's coupled 3x3 solve,
    the annulus's coupled 2x2 solve, the cube prm's Schur GMRES with the
    cuboid's rotational advection, and the mimetic C-grid personality on
    the cube and the shell), replayed through make_model and step."""
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


def test_cli_runs_direct_helmholtz_on_cpu(capsys, tmp_path):
    """The classic prm with `set helmholtz solver = direct` in a Numerics
    subsection appended to it (a subsection read again merges)."""
    from dycoreplanet_tpu_torch.cli.main import main

    prm = tmp_path / "direct.prm"
    with open(PRM) as f:
        prm.write_text(f.read() + "\nsubsection Numerics\n"
                       "  set helmholtz solver = direct\nend\n")
    rc = main(["-p", str(prm), "--max-steps", "2", "--no-output",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "helmholtz=[-1, -1, -1]" in out and "temperature=-1" in out


def test_cli_refuses_what_is_not_ported(capsys, tmp_path):
    """Output and checkpoints are ported: a run without --no-output
    writes its .vts files and the .pvd into the prm's `dirname output`;
    --restart of a missing file fails with rc 1 through the catch-all."""
    from dycoreplanet_tpu_torch.cli.main import main

    prm = tmp_path / "out.prm"
    with open(PRM) as f:
        prm.write_text(f.read().replace(
            "data-output-3d-shell-classic", str(tmp_path / "out")))
    assert main(["-p", str(prm), "--max-steps", "2", "--device", "cpu"]) == 0
    # the prm's final time (0.09) lets one step of dt 0.1 run
    assert sorted(os.listdir(tmp_path / "out")) == [
        "boussinesq.pvd", "boussinesq_000000.vts", "boussinesq_000001.vts"]
    capsys.readouterr()
    assert main(["-p", str(prm), "--no-output", "--restart",
                 str(tmp_path / "ckpt"), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "Exception on processing" in err and "ckpt" in err


# the port's scripts that the import check loads beside the package
PORT_SCRIPTS = ("torch_soak_production.py", "torch_comm_bytes.py")


def test_port_imports_no_jax():
    """Every module of the port, and the scripts of PORT_SCRIPTS, imported
    in a fresh interpreter, pull in neither jax, nor ml_dtypes (the
    port's bfloat16 goes through torch), nor dycoreplanet_tpu (this
    process has them loaded: tests/conftest.py imports jax)."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import dycoreplanet_tpu_torch, dycoreplanet_tpu_torch.cli.main\n"
        "for m in pkgutil.walk_packages(dycoreplanet_tpu_torch.__path__,\n"
        "                               'dycoreplanet_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        f"for name in {PORT_SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name[:-3], 'scripts/' + name)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'ml_dtypes' or k.startswith('ml_dtypes.')\n"
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
