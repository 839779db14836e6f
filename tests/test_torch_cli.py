"""The port's CLI against the JAX package's (dycoreplanet_tpu/cli/main.py)
on the CPU: the VTK time series, ``mesh.vts``, checkpoints, a restart,
``--profile`` and the solver residual trails of ``solver diagnostics
level`` >= 3, on copies of the shell and annulus prms whose ``dirname
output`` is a temp directory, in float64.

The JAX CLI compiles its step, so each of its runs is made once, by a
module-scoped fixture. ``.pvd`` and ``mesh.vts`` files must be equal
byte for byte; a ``.vts`` file is written as Float32 from float64 states
that agree to round-off, so its XML skeleton must be equal and its
decoded arrays within 1e-6 of their scale; checkpoints within 1e-12.
"""

import base64
import contextlib
import io
import os
import re
import struct
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRM = os.path.join(REPO, "data", "aqua_planet_shell_test_3d-classic.prm")
PRM_2D = os.path.join(REPO, "data", "aqua_planet_test_2d.prm")
F64 = "\nsubsection Numerics\n  set dtype = float64\nend\n"
# the classic prm's final time (0.09) lets one step of dt 0.1 run
LATER = "\nsubsection Boussinesq Model\n  set final time = 10\nend\n"
# a fixed dt, and gate tolerances that the fast path meets in f64 (the
# per-step loop, as the JAX CLI's, does not gate; a chunk that missed
# would be redone with CG)
FIXED_DT = ("\nsubsection Boussinesq Model\n  set adapt time step = false\n"
            "end\nsubsection Numerics\n  set helmholtz tol = 1e-2\n"
            "  set temperature tol = 1e-3\nend\n")
LEVEL3 = ("\nsubsection Boussinesq Model\n"
          "  set solver diagnostics level = 3\nend\n")


def _prm(path, src, outdir, extra=""):
    """A copy of ``src`` writing into ``outdir``, with ``extra`` appended
    (a subsection read again merges into the first)."""
    with open(src) as f:
        text = re.sub(r"set dirname output = .*",
                      f"set dirname output = {outdir}", f.read())
    path.write_text(text + extra)
    return str(path)


def _jax_run(prm, argv):
    from dycoreplanet_tpu.cli.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["-p", prm] + argv)
    assert rc == 0
    return out.getvalue()


def _port_run(prm, argv, monkeypatch=None):
    import jax

    from dycoreplanet_tpu_torch.cli import main as cli

    if monkeypatch is not None:
        # the JAX CLI maps --write-mesh's shards over the conftest's 8
        # virtual devices: the port's map counts as many
        monkeypatch.setattr(cli, "_device_count",
                            lambda device: len(jax.devices()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-p", prm, "--device", "cpu"] + argv)
    assert rc == 0
    return out.getvalue()


PER_STEP = ["--max-steps", "2", "--checkpoint-every", "1", "--write-mesh"]
CASES = {"shell": (PRM, F64 + LATER), "annulus": (PRM_2D, F64)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's per-step runs, one a prm, and its level-3 run."""
    runs = {}
    for label, (src, extra) in CASES.items():
        d = tmp_path_factory.mktemp(f"jax-{label}")
        _jax_run(_prm(d / "a.prm", src, d / "out", extra), PER_STEP)
        runs[label] = d / "out"
    d = tmp_path_factory.mktemp("jax-level3")
    runs["level3"] = _jax_run(
        _prm(d / "a.prm", PRM, d / "out", F64 + LATER + LEVEL3),
        ["--max-steps", "2", "--no-output"])
    return runs


def _decode(path):
    """(the XML with every data block blanked, {name: float32 array})."""
    root = ET.parse(path).getroot()
    arrays = {}
    for a in root.iter("DataArray"):
        raw = base64.b64decode(a.text.strip())
        (n,) = struct.unpack("<I", raw[:4])
        arrays[a.attrib.get("Name", "points")] = np.frombuffer(
            raw[4:4 + n], np.float32)
        a.text = ""
    return ET.tostring(root), arrays


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("label", list(CASES))
def test_cli_output_matches_jax_cli(tmp_path, monkeypatch, jax_runs, label):
    """``--max-steps 2 --checkpoint-every 1 --write-mesh``: the same file
    names; the .pvd and mesh.vts byte for byte; each .vts's skeleton
    equal and its arrays within 1e-6 of their scale; each checkpoint
    within 1e-12, with an equal step number and metadata."""
    src, extra = CASES[label]
    out = tmp_path / "out"
    _port_run(_prm(tmp_path / "a.prm", src, out, extra), PER_STEP,
              monkeypatch)
    jout = jax_runs[label]
    names = sorted(os.listdir(jout))
    assert names == sorted(os.listdir(out))
    assert "mesh.vts" in names and "boussinesq_000002.vts" in names
    assert "boussinesq_ckpt_000002.npz" in names
    for name in names:
        if name.endswith(".pvd") or name == "mesh.vts":
            assert _bytes(jout / name) == _bytes(out / name), name
        elif name.endswith(".vts"):
            (js, ja), (ts, ta) = _decode(jout / name), _decode(out / name)
            assert js == ts, name
            assert list(ja) == list(ta)
            for k in ja:
                scale = max(float(np.abs(ja[k]).max()), 1e-30)
                assert np.abs(ja[k].astype(float) - ta[k]).max() \
                    <= 1e-6 * scale, (name, k)
        elif name.endswith(".json"):
            assert _bytes(jout / name) == _bytes(out / name), name
        else:
            with np.load(jout / name) as ja, np.load(out / name) as ta:
                assert sorted(ja.files) == sorted(ta.files)
                assert int(ja["step_number"]) == int(ta["step_number"])
                for k in ja.files:
                    assert ja[k].dtype == ta[k].dtype
                    scale = max(float(np.abs(ja[k]).max()), 1e-30)
                    assert np.abs(ja[k] - ta[k]).max() <= 1e-12 * scale, \
                        (name, k)


def _trails(out):
    """{name: (count, [values])} of the printed residual trails, in
    order of appearance, per step."""
    rows = re.findall(r"\[(.+?)\] \|\|r\|\| trail \((\d+) its\):(.*)", out)
    return [(name, int(n), [float(v) for v in vals.split()])
            for name, n, vals in rows]


def test_cli_level3_trails_match_jax_cli(tmp_path, jax_runs):
    """`solver diagnostics level = 3`, 2 steps: the same trail names, in
    the same order, with the same counts and values as the JAX CLI's."""
    out = _port_run(_prm(tmp_path / "a.prm", PRM, tmp_path / "out",
                         F64 + LATER + LEVEL3),
                    ["--max-steps", "2", "--no-output"])
    got, want = _trails(out), _trails(jax_runs["level3"])
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert [r[0] for r in got] == ["helmholtz richardson",
                                   "temperature richardson"] * 2
    assert all(n == 2 for _, n, _ in got)
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


def test_step_verbose_trails_match_jax():
    """``step_verbose`` on the same state in f64: the port's trails are
    the JAX model's within 1e-9 relative, NaN-padded to 48 alike, and
    its state the plain step's (not K1's branch: the unfused one)."""
    from dycoreplanet_tpu.base.params import Parameters as JParameters
    from dycoreplanet_tpu.models import BoussinesqModel as JModel
    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    with open(PRM) as f:
        text = f.read() + F64
    jm = JModel(JParameters.from_text(text))
    tm = BoussinesqModel(Parameters.from_text(text), device="cpu")
    dt = 0.1
    js, jd, jh = jm.step_verbose(jm.initial_state(), dt)
    ts, diag, th = tm.step_verbose(tm.initial_state(), dt)
    assert sorted(jh) == sorted(th) == ["helmholtz richardson",
                                        "temperature richardson"]
    for name in jh:
        want, got = np.asarray(jh[name]), th[name]
        assert got.shape == want.shape == (48,)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-9, atol=0)
    assert tm.kernels()["richardson"].launches == 0
    assert tm._solver_trace is False and tm._trace_sink == []
    np.testing.assert_allclose(ts.u.numpy(), np.asarray(js.u), rtol=0,
                               atol=1e-12 * float(np.abs(js.u).max()))
    assert diag.solver_ok == bool(jd.solver_ok)
    assert diag.helmholtz_iters.tolist() == [2, 2, 2]


def test_step_verbose_refuses_a_sharded_state():
    """step_verbose on a sharded state of the shell prm (which raised
    before the mesh ran the plain solves) returns the trails of the
    single-device step_verbose, within 1e-8."""
    import torch

    from dycoreplanet_tpu_torch.base.params import Parameters
    from dycoreplanet_tpu_torch.models import BoussinesqModel
    from dycoreplanet_tpu_torch.parallel.mesh import Mesh, shard_state

    with open(PRM) as f:
        text = f.read() + F64
    m = BoussinesqModel(Parameters.from_text(text), device="cpu")
    one = BoussinesqModel(Parameters.from_text(text), device="cpu")
    mesh = Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("lat", "lon"))
    m.prepare_sharded(mesh)
    s = shard_state(m.initial_state(), m.geo, mesh)
    _, _, trails = m.step_verbose(s, 0.1)
    _, _, want = one.step_verbose(one.initial_state(), 0.1)
    assert set(trails) == set(want) and trails
    for name in want:
        np.testing.assert_allclose(trails[name], want[name], rtol=1e-8,
                                   atol=1e-20, err_msg=name)
    assert torch.is_tensor(s.p[0, 0])


def test_cli_restart_is_bitwise(tmp_path):
    """A fixed-dt f64 run: A writes 4 steps with checkpoints every 2; B
    restarts from A's ckpt_000002 and runs 2 steps, so its ckpt_000002
    is A's ckpt_000004 bitwise (u, faces, p, T, step number; time equal
    at its dtype); C runs the 4 steps in chunks of 2, and its
    boussinesq_000004.vts is A's byte for byte."""
    extra = F64 + LATER + FIXED_DT
    a, b, c = (tmp_path / x for x in "abc")
    _port_run(_prm(tmp_path / "a.prm", PRM, a, extra),
              ["--max-steps", "4", "--checkpoint-every", "2"])
    out = _port_run(_prm(tmp_path / "b.prm", PRM, b, extra),
                    ["--restart", str(a / "boussinesq_ckpt_000002.npz"),
                     "--max-steps", "2", "--checkpoint-every", "2"])
    assert f"Restarted from {a / 'boussinesq_ckpt_000002.npz'} at step 2" \
        in out
    _port_run(_prm(tmp_path / "c.prm", PRM, c, extra),
              ["--chunk", "2", "--max-steps", "4"])
    with np.load(a / "boussinesq_ckpt_000004.npz") as want, \
            np.load(b / "boussinesq_ckpt_000002.npz") as got:
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            assert want[k].dtype == got[k].dtype
            assert want[k].tobytes() == got[k].tobytes(), k
        assert int(got["step_number"]) == 4
    # the restart counts its files from 0 again, as the JAX CLI does
    assert sorted(os.listdir(b))[:2] == ["boussinesq.pvd",
                                         "boussinesq_000000.vts"]
    assert _bytes(c / "boussinesq_000004.vts") == \
        _bytes(a / "boussinesq_000004.vts")
    assert len(ET.parse(c / "boussinesq.pvd").getroot()
               .findall(".//DataSet")) == 3


# -------------------------------------------- refusals and the old tests
@pytest.mark.parametrize("chunk", [[], ["--chunk", "4"]],
                         ids=["per_step", "chunk4"])
@pytest.mark.parametrize("flag", [["--write-mesh"], ["--profile", "prof"]],
                         ids=["write_mesh", "profile"])
def test_cli_refuses_unported_output_flags(capsys, tmp_path, flag, chunk):
    """``--write-mesh`` and ``--profile DIR``, refused until the output
    layer was ported, now run, per step and with ``--chunk``: rc 0, and
    mesh.vts, or a trace in DIR, written."""
    from dycoreplanet_tpu_torch.cli.main import main

    if flag[0] == "--profile":
        flag = ["--profile", str(tmp_path / "prof")]
    prm = _prm(tmp_path / "a.prm", PRM, tmp_path / "out")
    rc = main(["-p", prm, "--no-output", "--device", "cpu", "--max-steps",
               "2"] + flag + chunk)
    out = capsys.readouterr().out
    assert rc == 0
    if flag[0] == "--write-mesh":
        assert os.listdir(tmp_path / "out") == ["mesh.vts"]
        assert not (tmp_path / "prof").exists()
    else:
        traces = os.listdir(tmp_path / "prof")
        assert len(traces) == 1 and traces[0].endswith(".json")
        assert f"Profiler trace written to {tmp_path / 'prof'}" in out
        assert not (tmp_path / "out").exists()


def test_cli_subprocess_rc_for_write_mesh(tmp_path):
    """Through ``python -m`` as a user runs it: rc 0 and mesh.vts."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    prm = _prm(tmp_path / "a.prm", PRM, tmp_path / "out")
    r = subprocess.run([sys.executable, "-m", "dycoreplanet_tpu_torch", "-p",
                        prm, "--no-output", "--device", "cpu",
                        "--write-mesh"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "out" / "mesh.vts").exists()


def test_cli_refuses_checkpoints_with_chunk(capsys, tmp_path):
    """``--checkpoint-every`` works per step: with ``--chunk`` the port
    refuses (rc 1), where the JAX CLI silently saves nothing."""
    from dycoreplanet_tpu_torch.cli.main import main

    prm = _prm(tmp_path / "a.prm", PRM, tmp_path / "out")
    rc = main(["-p", prm, "--device", "cpu", "--max-steps", "2",
               "--chunk", "2", "--checkpoint-every", "1"])
    assert rc == 1
    assert "--checkpoint-every works per step, without --chunk" in \
        capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_cli_profile_exports_when_the_run_raises(tmp_path, monkeypatch,
                                                 capsys):
    """The trace is written also when the run fails (rc 1 through the
    catch-all)."""
    from dycoreplanet_tpu_torch.cli.main import main
    from dycoreplanet_tpu_torch.models import BoussinesqModel

    def boom(self, state, dt):
        raise RuntimeError("step failed")

    monkeypatch.setattr(BoussinesqModel, "step", boom)
    prm = _prm(tmp_path / "a.prm", PRM, tmp_path / "out")
    rc = main(["-p", prm, "--device", "cpu", "--no-output", "--max-steps",
               "1", "--profile", str(tmp_path / "prof")])
    assert rc == 1
    assert "step failed" in capsys.readouterr().err
    assert len(os.listdir(tmp_path / "prof")) == 1


# ------------------------------------------------------- the FEEC prm
PRM_FEEC = os.path.join(REPO, "data", "aqua_planet_shell_test_3d-feec.prm")
# a fixed dt of 0.01, where the 3x3 FGMRES converges every step; at the
# prm's own dt of 0.1 it stalls at `max cg iters` (512) in both packages
DT_001 = ("\nsubsection Boussinesq Model\n  set adapt time step = false\n"
          "  set time step = 0.01\nend\n")
FEEC_RUNS = {"prm": (F64 + LATER, ["--max-steps", "2"]),
             "dt0.01": (F64 + LATER + DT_001, ["--max-steps", "2"]),
             "dt0.01_chunk2": (F64 + LATER + DT_001,
                               ["--max-steps", "4", "--chunk", "2"])}
# the per-step lines and their numbers, in order of appearance
_LINE = re.compile(r"^ *(Time step \d+|Max of local CFL numbers|"
                   r"Max velocity \(dimensionless\)|Temperature range|"
                   r"Solver iterations|Solver residuals|"
                   r"Post-projection max \|div u\||"
                   r"New time step \(dimensionless\))(.*)$", re.M)
_NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _printed(out):
    """[(label, [numbers])] of the printed diagnostics (the JAX CLI
    prints its iteration counts as np.int32(n))."""
    return [(label, [float(v) for v in
                     _NUM.findall(rest.replace("np.int32(", "("))])
            for label, rest in _LINE.findall(out)]


@pytest.fixture(scope="module")
def jax_feec(tmp_path_factory):
    """The JAX CLI's runs of FEEC_RUNS."""
    out = {}
    for label, (extra, argv) in FEEC_RUNS.items():
        d = tmp_path_factory.mktemp(f"jax-feec-{label}")
        out[label] = _jax_run(_prm(d / "a.prm", PRM_FEEC, d / "out", extra),
                              argv + ["--no-output"])
    return out


@pytest.mark.parametrize("label", list(FEEC_RUNS))
def test_cli_feec_prm_matches_jax_cli(tmp_path, jax_feec, label):
    """data/aqua_planet_shell_test_3d-feec.prm (the coupled 3x3 FGMRES) in
    f64 through both CLIs with --device cpu, as it is (adaptive dt from
    0.1) and with a fixed dt of 0.01, per step and with --chunk 2: the
    same lines in the same order, the iteration counts equal, every
    other number within its print precision (6 significant digits), the
    residuals and |div u| (round-off of the solve's right-hand side)
    within 1e-3 relative or 1e-13. A step whose outer solve stalls at
    the iteration cap (the prm's dt) ends on a round-off-driven iterate:
    there the residuals and |div u| agree within a factor 4, below 1e-6."""
    extra, argv = FEEC_RUNS[label]
    out = _port_run(_prm(tmp_path / "a.prm", PRM_FEEC, tmp_path / "out",
                         extra), argv + ["--no-output"])
    assert "Formulation            : FEEC (rotational, coupled 3x3)" in out
    got, want = _printed(out), _printed(jax_feec[label])
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len(got) >= 12
    stalled = False
    for (name, g), (_, w) in zip(got, want):
        if name == "Solver iterations":
            assert g == w
            stalled = w[-2] >= 512          # poisson = the outer count
        elif name in ("Solver residuals", "Post-projection max |div u|"):
            if stalled:
                assert max(g + w) < 1e-6
                np.testing.assert_allclose(np.log(g), np.log(w), rtol=0,
                                           atol=np.log(4.0), err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-13,
                                           err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=0,
                                       err_msg=name)
    if label == "prm":
        assert stalled


# --------------------------------- the FEEC prm's mimetic realization
STAGGERED = ("\nsubsection Numerics\n  set feec formulation = staggered\n"
             "end\n")
MIMETIC_RUNS = {"steps": ["--max-steps", "3"],
                "chunk2": ["--max-steps", "4", "--chunk", "2"]}


@pytest.fixture(scope="module")
def jax_mimetic(tmp_path_factory):
    """The JAX CLI's runs of MIMETIC_RUNS."""
    out = {}
    for label, argv in MIMETIC_RUNS.items():
        d = tmp_path_factory.mktemp(f"jax-mimetic-{label}")
        out[label] = _jax_run(_prm(d / "a.prm", PRM_FEEC, d / "out",
                                   F64 + LATER + STAGGERED),
                              argv + ["--no-output"])
    return out


@pytest.mark.parametrize("label", list(MIMETIC_RUNS))
def test_cli_mimetic_feec_prm_matches_jax_cli(tmp_path, jax_mimetic, label):
    """data/aqua_planet_shell_test_3d-feec.prm with `feec formulation =
    staggered` (the mimetic C-grid model, built by make_model) at its own
    grid, f64, adaptive dt, through both CLIs with --device cpu, per step
    and with --chunk 2: the personality line, the same lines in the same
    order, the iteration counts equal, the residuals and |div u| within
    1e-3 relative or 1e-13, every other number within its print
    precision."""
    argv = MIMETIC_RUNS[label]
    out = _port_run(_prm(tmp_path / "a.prm", PRM_FEEC, tmp_path / "out",
                         F64 + LATER + STAGGERED), argv + ["--no-output"])
    assert "Formulation            : FEEC mimetic (staggered C-grid)" in out
    got, want = _printed(out), _printed(jax_mimetic[label])
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len(got) >= 12
    for (name, g), (_, w) in zip(got, want):
        if name == "Solver iterations":
            assert g == w
        elif name in ("Solver residuals", "Post-projection max |div u|"):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-13,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=0,
                                       err_msg=name)


# ------------------------------------------------------- the cube prm
PRM_CUBE = os.path.join(REPO, "data", "aqua_planet_cube_test_3d.prm")
LEVEL2 = ("\nsubsection Boussinesq Model\n"
          "  set solver diagnostics level = 2\nend\n")
CUBE_RUNS = {"steps": ["--max-steps", "3"],
             "chunk2": ["--max-steps", "4", "--chunk", "2", "--no-output"]}


@pytest.fixture(scope="module")
def jax_cube(tmp_path_factory):
    """The JAX CLI's runs of CUBE_RUNS: (stdout, output directory)."""
    out = {}
    for label, argv in CUBE_RUNS.items():
        d = tmp_path_factory.mktemp(f"jax-cube-{label}")
        out[label] = (_jax_run(_prm(d / "a.prm", PRM_CUBE, d / "out",
                                    F64 + LEVEL2), argv), d / "out")
    return out


@pytest.mark.parametrize("label", list(CUBE_RUNS))
def test_cli_cube_prm_matches_jax_cli(tmp_path, jax_cube, label):
    """data/aqua_planet_cube_test_3d.prm (the Schur GMRES with the
    cuboid's rotational advection, at its own 16^3, f64, with `solver
    diagnostics level = 2`) through both CLIs with --device cpu, 3 steps
    with output into a temporary dirname, and 4 steps in chunks of 2:
    the same lines in the same order, the iteration counts equal, the
    residuals and |div u| within 1e-3 relative or 1e-13, every other
    number within its print precision; with output the same files, the
    .pvd and the first .vts (the initial state) byte for byte."""
    argv = CUBE_RUNS[label]
    out = _port_run(_prm(tmp_path / "a.prm", PRM_CUBE, tmp_path / "out",
                         F64 + LEVEL2), argv)
    jout, jdir = jax_cube[label]
    assert "Geometry               : cuboid" in out
    got, want = _printed(out), _printed(jout)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert len(got) >= 12
    for (name, g), (_, w) in zip(got, want):
        if name == "Solver iterations":
            assert g == w
        elif name in ("Solver residuals", "Post-projection max |div u|"):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-13,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=0,
                                       err_msg=name)
    if "--no-output" in argv:
        assert not (tmp_path / "out").exists()
        return
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tmp_path / "out"))
    assert "boussinesq_000003.vts" in names
    for name in ("boussinesq.pvd", "boussinesq_000000.vts"):
        assert _bytes(jdir / name) == _bytes(tmp_path / "out" / name), name
