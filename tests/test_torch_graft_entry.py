"""The port's ``entry()`` (dycoreplanet_tpu_torch/entry.py) against the
JAX package's ``__graft_entry__.entry()`` on the CPU: the same step of
the flagship shell at (8, 16, 32) f32 from the same initial state, every
``State`` field within the f32 tolerance below; ``_make_model``'s knobs
building the JAX ``_make_model``'s ``Parameters`` field for field; no
card and no ``device="cpu"``: a raise; the module's command line."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch import entry as tentry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32: the port's plain PyTorch step against XLA's on the same state
# differs by reassociation; relative to each field's scale
RTOL = 1e-5


def _graft():
    """__graft_entry__.py loaded by file, as scripts/comm_bytes.py loads
    it."""
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(REPO, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    return graft


@pytest.fixture(scope="module")
def graft():
    return _graft()


@pytest.fixture(scope="module")
def steps(graft):
    """(JAX example args, JAX new state, port example args, port new
    state)."""
    jfn, jargs = graft.entry()
    jout = jax.jit(jfn)(*jargs)
    jax.block_until_ready(jout.u)
    fn, args = tentry.entry(device="cpu")
    return jargs, jout, args, fn(*args)


def _pairs(j, t):
    yield "u", np.asarray(j.u), t.u.numpy()
    yield "p", np.asarray(j.p), t.p.numpy()
    yield "T", np.asarray(j.T), t.T.numpy()
    for d, (a, b) in enumerate(zip(j.u_faces, t.u_faces)):
        yield f"u_faces[{d}]", np.asarray(a), b.numpy()


def test_entry_example_args_match_jax(steps):
    """The same initial state (bitwise: both compute it in f64 on the
    host and round it once) and dt (float32(0.01))."""
    jargs, _, args, _ = steps
    for name, a, b in _pairs(jargs[0], args[0]):
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert args[1] == float(jargs[1]) == float(np.float32(0.01))
    assert float(args[0].time) == float(jargs[0].time)
    assert int(args[0].step_number) == int(jargs[0].step_number)


def test_entry_step_matches_jax(steps):
    """fn(state, dt) of both packages: every State field within RTOL of
    its scale (f32); time and step number equal."""
    _, jout, _, out = steps
    for name, a, b in _pairs(jout, out):
        assert a.shape == b.shape and b.dtype == np.float32, name
        scale = max(float(np.abs(a).max()), 1e-30)
        assert np.isfinite(b).all(), name
        np.testing.assert_allclose(b, a, rtol=0, atol=RTOL * scale,
                                   err_msg=name)
    # the time is the JAX package's, a float32 sum
    assert float(out.time) == float(jout.time) == float(np.float32(0.01))
    assert int(out.step_number) == int(jout.step_number) == 1


def test_entry_step_moves_the_state(steps):
    """The step is not the identity (the buoyancy spins the flow up from
    rest), and fn runs on the flagship shell at (8, 16, 32) f32 on the
    CPU asked for."""
    _, _, args, out = steps
    assert float((out.u - args[0].u).abs().max()) > 0.0
    m = tentry.entry(device="cpu")[0].model
    assert (m.geo.kind, m.geo.cell_shape) == ("shell", (8, 16, 32))
    assert (m.torch_dtype, m.device.type) == (torch.float32, "cpu")


def _as_dict(p):
    return dataclasses.asdict(p)


KNOBS = [
    {},
    {"shape": (4, 8, 16)},
    {"poisson_precision": "high"},
    {"momentum_fixed_iters": 1},
    {"residual_check_interval": 4},
    {"fixed_solver_iters": 0},
    {"shape": (8, 32, 64), "poisson_precision": "highest",
     "momentum_fixed_iters": 2, "residual_check_interval": 2,
     "fixed_solver_iters": 3},
]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(k) or "none")
def test_make_model_parameters_match_jax(graft, monkeypatch, knobs):
    """The port's _make_model builds, with each knob, the Parameters the
    JAX _make_model builds, field for field (the JAX model is not built:
    its class is replaced by one that keeps the parameters)."""
    import dycoreplanet_tpu.models as jmodels

    monkeypatch.setattr(jmodels, "BoussinesqModel",
                        lambda p: type("M", (), {"params": p})())
    want = graft._make_model("float32", **knobs).params
    got = tentry._params("float32", **knobs)
    assert _as_dict(got) == _as_dict(want)
    model = tentry._make_model("float32", **knobs, device="cpu")
    assert _as_dict(model.params) == _as_dict(want)


def test_entry_without_a_card_raises(monkeypatch):
    """entry() without device= runs on the card: without CUDA it raises,
    as resolve_device does, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


def test_entry_command_line(capsys):
    """python -m dycoreplanet_tpu_torch.entry --device cpu: one entry()
    step, then dryrun_multichip(8)."""
    tentry.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "entry(): single-device step OK, shape (3, 8, 16, 32)" in out
    assert "dryrun_multichip: 8 shards" in out
    assert "FEEC staggered mimetic on the same mesh" in out
