"""The port's CLI refuses the options whose work is not ported yet
(``--profile DIR``, ``--write-mesh``) with rc 1 and an error naming the
ROADMAP item that brings them, per step and with ``--chunk``, where the
JAX CLI accepts both (dycoreplanet_tpu/cli/main.py)."""

import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(REPO, "data", "aqua_planet_shell_test_3d-classic.prm")


@pytest.mark.parametrize("chunk", [[], ["--chunk", "4"]],
                         ids=["per_step", "chunk4"])
@pytest.mark.parametrize("flag", [["--write-mesh"], ["--profile", "prof"]],
                         ids=["write_mesh", "profile"])
def test_cli_refuses_unported_output_flags(capsys, tmp_path, flag, chunk):
    from dycoreplanet_tpu_torch.cli.main import main

    if flag[0] == "--profile":
        flag = ["--profile", str(tmp_path / "prof")]
    rc = main(["-p", PRM, "--no-output", "--device", "cpu", "--max-steps",
               "2"] + flag + chunk)
    err = capsys.readouterr().err
    assert rc == 1
    assert f"{flag[0]} not yet ported" in err
    assert "VTK output and checkpoints" in err
    assert not (tmp_path / "prof").exists()


def test_cli_subprocess_rc_for_write_mesh():
    """Through ``python -m`` as a user runs it: rc 1, not argparse's 2."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "dycoreplanet_tpu_torch", "-p",
                        PRM, "--no-output", "--device", "cpu",
                        "--write-mesh"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1, r.stderr
    assert "VTK output and checkpoints" in r.stderr
