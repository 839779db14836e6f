"""The port's native VTK encoder (csrc/vtkenc.cpp, built by the host
compiler at first use) and its bfloat16 checkpoints, on the CPU.

The encoder must give the bytes of the port's Python encoder
(``_b64_block_plain``) and of the JAX package's ``_b64_block`` over
payloads of 0-7 values (every header and padding case) and a large
seeded array, and a failed build must raise. A bfloat16 checkpoint must
hold the bytes the JAX writer writes for the same state (2-byte voids,
``'<V2'``), restore bitwise, and restart the model bitwise; the JAX
package cannot read its own bfloat16 checkpoints back (ROADMAP.md Queue
3), which the last test pins.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycoreplanet_tpu.io import checkpoint as jck
from dycoreplanet_tpu.io import vtk as jvtk
from dycoreplanet_tpu.models.boussinesq import State as JState
from dycoreplanet_tpu_torch.base import dtypes
from dycoreplanet_tpu_torch.base.params import Parameters
from dycoreplanet_tpu_torch.io import checkpoint as tck
from dycoreplanet_tpu_torch.io import vtk as tvtk
from dycoreplanet_tpu_torch.models import BoussinesqModel
from dycoreplanet_tpu_torch.models.boussinesq import State
from dycoreplanet_tpu_torch.ops import kernel_lib

PRM = os.path.join(os.path.dirname(__file__), "..", "data",
                   "aqua_planet_shell_test_3d-classic.prm")


@pytest.mark.parametrize("n", range(8))
def test_native_encoder_matches_python_and_jax(n):
    """0-7 float32 values: 4-11 bytes behind the header, every padding."""
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got = tvtk._b64_block(a)
    assert got == tvtk._b64_block_plain(a) == jvtk._b64_block(a)


def test_native_encoder_large_array():
    """A seeded (32768, 3) float64 array, narrowed to float32 as the
    writers store it; a (7,) int array likewise."""
    rng = np.random.default_rng(17)
    for a in (rng.standard_normal((32768, 3)), np.arange(7)):
        got = tvtk._b64_block(a)
        assert got == tvtk._b64_block_plain(a) == jvtk._b64_block(a)


def test_native_encoder_build_failure_raises(monkeypatch, tmp_path):
    """A source the host compiler rejects raises with its output; nothing
    falls back to the Python encoder."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(kernel_lib, "CSRC", str(tmp_path))
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="failed to build bad.cpp"):
        kernel_lib.host_library("bad.cpp")


def _bf16_state(seed=3):
    """One seeded state, its values rounded to bfloat16 once, in both
    packages' forms: (JAX State, port State)."""
    rng = np.random.default_rng(seed)
    shp = (4, 8, 16)
    r = lambda *s: dtypes.round_bf16(rng.standard_normal(s))  # noqa: E731
    u, faces, p, T = r(3, *shp), [r(*shp) for _ in range(3)], r(*shp), r(*shp)
    j = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    t = lambda x: torch.as_tensor(x).to(torch.bfloat16)  # noqa: E731
    js = JState(u=j(u), u_faces=tuple(j(f) for f in faces), p=j(p), T=j(T),
                time=jnp.asarray(0.0, jnp.bfloat16),
                step_number=jnp.asarray(0, jnp.int32))
    ts = State(u=t(u), u_faces=tuple(t(f) for f in faces), p=t(p), T=t(T),
               time=0.0, step_number=0)
    return js, ts


def test_bf16_checkpoint_bytes_equal_jax(tmp_path):
    """The same bfloat16 state at step 0 saved by both packages: the same
    keys, shapes, dtypes ('<V2' but step_number's int32) and bytes, but
    ``time``, which the port writes as the float32 it keeps and the JAX
    package as bfloat16; equal .json files; the port restores both files
    bitwise."""
    js, ts = _bf16_state()
    a = jck.save_checkpoint(str(tmp_path / "jax"), js, {"dt": 0.1})
    b = tck.save_checkpoint(str(tmp_path / "port"), ts, {"dt": 0.1})
    with np.load(a) as ja, np.load(b) as tb:
        assert sorted(ja.files) == sorted(tb.files)
        for k in ja.files:
            assert ja[k].shape == tb[k].shape, k
            if k == "time":
                assert ja[k].dtype == np.dtype("V2")
                assert tb[k].dtype == np.float32 and float(tb[k]) == 0.0
                continue
            assert ja[k].dtype == tb[k].dtype, k
            assert ja[k].tobytes() == tb[k].tobytes(), k
        assert tb["u"].dtype == np.dtype("V2")
    with open(a + ".json", "rb") as f, open(b + ".json", "rb") as g:
        assert f.read() == g.read()
    for path in (a, b):
        got, _ = tck.load_checkpoint(path, "cpu")
        for x, y in zip((got.u, got.p, got.T) + got.u_faces,
                        (ts.u, ts.p, ts.T) + ts.u_faces):
            assert x.dtype == torch.bfloat16 and torch.equal(
                x.view(torch.int16), y.view(torch.int16))
        assert got.time == 0.0 and got.step_number == 0


def test_bf16_restart_bitwise(tmp_path):
    """Two steps from time 4.25, a checkpoint, three more from the
    restored state: bitwise the three steps from the saved state, time
    included. The saved time (4.25 + 2 dt in float32) lies between two
    bfloat16 values, so a bfloat16 time would move the clock."""
    p = Parameters.from_file(PRM)
    p.numerics.dtype = "bfloat16"
    p.numerics.n_radial, p.numerics.n_lat, p.numerics.n_lon = 4, 8, 16
    p.adapt_time_step = False
    p.final_time = 1e9
    m = BoussinesqModel(p, device="cpu")
    s2, _ = m.run(max_steps=2, state=m.initial_state()._replace(time=4.25))
    assert s2.time > 4.25
    assert s2.time != dtypes.round_scalar(s2.time, torch.bfloat16)
    r2, _ = tck.load_checkpoint(
        tck.save_checkpoint(str(tmp_path / "ck"), s2), "cpu")
    assert r2.time == s2.time and r2.step_number == 2
    a, _ = m.run(max_steps=3, state=s2)
    b, _ = m.run(max_steps=3, state=r2)
    assert a.time == b.time and a.step_number == b.step_number == 5
    for x, y in zip((a.u, a.p, a.T) + a.u_faces, (b.u, b.p, b.T) + b.u_faces):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)


def test_jax_cannot_restore_its_bf16_checkpoint(tmp_path):
    """The JAX writer saves bfloat16 leaves as 2-byte voids, which its
    loader hands to jnp.asarray without ml_dtypes: TypeError. The port
    reads the same file bitwise (ROADMAP.md Queue 3)."""
    js, ts = _bf16_state(5)
    a = jck.save_checkpoint(str(tmp_path / "jax"), js, {})
    with pytest.raises(TypeError, match="V2"):
        jck.load_checkpoint(a)
    got, _ = tck.load_checkpoint(a, "cpu")
    assert torch.equal(got.T.view(torch.int16), ts.T.view(torch.int16))


def test_cli_bf16_checkpoints_chunks_and_restarts(tmp_path):
    """The CLI on the classic prm with `dtype = bfloat16` and a fixed dt:
    6 steps with output and checkpoints every 3, 4 steps in chunks of 2
    (graph chunks on a card; rc 0), and a restart from the step-3
    checkpoint, whose step-3 checkpoint is the first run's step-6 one
    bitwise, time included. dt 1.3515625 (a bfloat16 value) puts the
    restart's time, 3 dt = 4.0546875, between two bfloat16 values."""
    import contextlib
    import io
    import re

    from dycoreplanet_tpu_torch.cli import main as cli

    def run(outdir, argv):
        with open(PRM) as f:
            text = re.sub(r"set dirname output = .*",
                          f"set dirname output = {outdir}", f.read())
        prm = tmp_path / f"{os.path.basename(outdir)}.prm"
        prm.write_text(text + "\nsubsection Boussinesq Model\n"
                       "  set adapt time step = false\n"
                       "  set final time = 10\n"
                       "  set time step = 1.3515625\nend\n"
                       "subsection Numerics\n  set dtype = bfloat16\nend\n")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["-p", str(prm), "--device", "cpu"] + argv) == 0

    a, b, c = (str(tmp_path / x) for x in ("a", "b", "c"))
    run(a, ["--max-steps", "6", "--checkpoint-every", "3"])
    with np.load(os.path.join(a, "boussinesq_ckpt_000003.npz")) as x:
        assert float(x["time"]) == 3 * 1.3515625 and \
            x["time"].dtype == np.float32
        assert dtypes.round_scalar(x["time"], torch.bfloat16) != x["time"]
    run(b, ["--max-steps", "3", "--checkpoint-every", "3", "--restart",
            os.path.join(a, "boussinesq_ckpt_000003.npz")])
    run(c, ["--max-steps", "4", "--chunk", "2", "--no-output"])
    with np.load(os.path.join(a, "boussinesq_ckpt_000006.npz")) as x, \
            np.load(os.path.join(b, "boussinesq_ckpt_000003.npz")) as y:
        assert x["T"].dtype == np.dtype("V2")
        for k in ("u", "p", "T", "u_face_0", "u_face_1", "u_face_2",
                  "time", "step_number"):
            assert x[k].tobytes() == y[k].tobytes(), k
    assert os.path.exists(os.path.join(a, "boussinesq_000004.vts"))
