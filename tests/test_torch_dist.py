"""The port's mesh across processes (parallel/dist.py; the process mesh of
parallel/mesh.py) on CPU ranks over gloo: scripts/torch_multihost_smoke.py
launched as ranks, each a subprocess with RANK and WORLD_SIZE set and a
``file://`` rendezvous under tmp_path, against the same paths on the
single-controller mesh run beside them by a process started alike
(``--single``).

  * 2 ranks on a 2 x 2 mesh, two shards a rank (every transport call
    mixes local and remote pieces): the flagship default step (f64 and
    f32), SL at `NSE solver interval` = 2, `helmholtz solver = direct`, a
    forced miss in run and in a multi_step chunk, the mimetic step, `poisson
    solver = mg` and the FEEC 3x3 (one step, the Krylov solves capped
    alike on both sides), the 8^3 box on ("y", "x"); 4 ranks on the
    annulus's 4 phi shards; 3 ranks on a 2 x 3 mesh (odd B: the half
    turn's two source shards lie on two ranks);
  * every gathered state and packed row bitwise the single-controller
    mesh's; the default step within rtol 1e-9, atol 1e-11 of the JAX
    single-device step; each rank's comm ledger equal to the
    single-controller ledger, its all-gathered bytes the ledger's
    process-mesh column (scripts/torch_comm_bytes.py); the forced miss
    escalating on every rank at the same step; a sharded checkpoint written by 2 ranks restored
    bitwise onto the ranks' own mesh, the single-controller mesh and one
    device; the sharded .vts pieces and .pvts written by 2 ranks byte
    for byte the single-controller mesh's; the ranks import no JAX; NCCL without CUDA, and CUDA without a card,
    refused.

Every launch has at most RANK_TIMEOUT seconds: a rank that hangs is
killed with its group and fails the test.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dycoreplanet_tpu_torch.io import checkpoint as tck
from dycoreplanet_tpu_torch.parallel import dist as pdist
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, unshard_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "torch_multihost_smoke.py")
RANK_TIMEOUT = 120

_spec = importlib.util.spec_from_file_location("torch_multihost_smoke",
                                               SCRIPT)
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# world size -> the paths its launch runs
LAUNCHES = {
    2: ["default", "default32", "sl2", "direct", "escalate", "mimetic",
        "mg", "feec", "box"],
    4: ["annulus"],
    3: ["odd", "odd_sl"],
}
ALL_PATHS = [p for paths in LAUNCHES.values() for p in paths]


def _popen(argv, **env):
    return subprocess.Popen(
        [sys.executable, SCRIPT, "--device", "cpu", "--threads", "1"]
        + argv, cwd=ROOT, env=dict(os.environ, **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _start(world, paths, base):
    """The ranks of one launch and, beside them, one process running the
    same paths on the single-controller mesh (``--single``), started
    alike: the same environment (numpy's BLAS threads, which the models'
    host tables follow at round-off) and one torch thread."""
    out = os.path.join(base, f"w{world}")
    os.makedirs(out, exist_ok=True)
    check = ["--check", ",".join(paths)]
    if world == 2:
        check.append("--checkpoint")
    procs = []
    for r in range(world):
        argv = ["--backend", "gloo", "--init-method",
                f"file://{out}/rendezvous", "--timeout", str(RANK_TIMEOUT),
                "--out", out] + check
        if world == 2:
            argv.append("--smoke")
        procs.append(_popen(argv, RANK=str(r), WORLD_SIZE=str(world),
                            LOCAL_RANK=str(r)))
    procs.append(_popen(["--single", "--out",
                         os.path.join(base, f"single{world}")] + check))
    return procs


def _finish(launches, t0):
    """Wait for every rank of every launch (RANK_TIMEOUT seconds from
    ``t0`` at most); on a timeout kill them all and fail."""
    outs = {}
    everyone = [p for procs in launches.values() for p in procs]
    for world, procs in launches.items():
        texts = []
        for p in procs:
            try:
                text, _ = p.communicate(
                    timeout=max(t0 + RANK_TIMEOUT - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                for q in everyone:
                    q.kill()
                for q in everyone:
                    q.communicate()
                pytest.fail(f"a rank of the {world}-rank launch ran past "
                            f"{RANK_TIMEOUT} s")
            texts.append(text)
        for r, (p, text) in enumerate(zip(procs, texts)):
            assert p.returncode == 0, \
                f"process {r} of {world} rc {p.returncode}:\n{text[-3000:]}"
        outs[world] = texts[:world]
    return outs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every launch and its single-controller twin started at once:
    (stdout by world size, results.npz and the rank records by world
    size, the single-controller arrays and records by path, the
    checkpoint directories of the ranks and of the single-controller
    mesh)."""
    base = tmp_path_factory.mktemp("ranks")
    t0 = time.monotonic()
    launches = {w: _start(w, paths, str(base))
                for w, paths in LAUNCHES.items()}
    outs = _finish(launches, t0)
    results, records, ref_arrays, ref_records = {}, {}, {}, {}
    for w in LAUNCHES:
        for d, arrays in ((f"w{w}", results), (f"single{w}", ref_arrays)):
            with np.load(base / d / "results.npz") as f:
                arrays.update({k: f[k] for k in f.files})
        records[w] = []
        for r in range(w):
            with open(base / f"w{w}" / f"rank{r}.json") as f:
                records[w].append(json.load(f))
        with open(base / f"single{w}" / "rank0.json") as f:
            ref_records.update(json.load(f)["paths"])
    return dict(outs=outs, results=results, records=records,
                ref_arrays=ref_arrays, ref_records=ref_records,
                ckpt=str(base / "w2" / "ckpt"),
                ref_ckpt=str(base / "single2" / "ckpt"))


def _world_of(path):
    return next(w for w, paths in LAUNCHES.items() if path in paths)


@pytest.mark.parametrize("path", ALL_PATHS)
def test_path_bitwise_the_single_controller_mesh(launched, path):
    """The ranks' gathered final state(s) and packed rows equal the
    single-controller mesh's bit for bit, with the same shards."""
    got, want = launched["results"], launched["ref_arrays"]
    keys = [k for k in want if k.split("/")[0] == path]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(np.isfinite(want[k]).all() for k in keys
               if not k.endswith("rows"))
    for rec in launched["records"][_world_of(path)]:
        assert rec["paths"][path]["mesh"] == \
            launched["ref_records"][path]["mesh"]


def test_default_within_the_jax_single_device_step(launched):
    """The flagship default path on 2 ranks (two steps, f64) within rtol
    1e-9, atol 1e-11 of the JAX single-device step from the same state
    (the bound of tests/test_torch_sharded.py)."""
    import jax.numpy as jnp
    from dycoreplanet_tpu.base.params import Parameters as JParameters
    from dycoreplanet_tpu.models import BoussinesqModel as JModel
    from dycoreplanet_tpu.models.boussinesq import State as JState

    from dycoreplanet_tpu_torch.models.convert import state_to_numpy

    jm = JModel(smoke.shell_params(JParameters.from_text("")))
    u, faces, p, T, _, _ = state_to_numpy(
        smoke.seeded(smoke.make_model("default", "cpu")))
    js = JState(u=jnp.asarray(u), u_faces=tuple(map(jnp.asarray, faces)),
                p=jnp.asarray(p), T=jnp.asarray(T),
                time=jnp.asarray(0.0, jnp.float64),
                step_number=jnp.asarray(0))
    for _ in range(smoke.PATHS["default"][2]):
        js, _ = jm.step(js, smoke.DT)
    got = launched["results"]
    for name in ("u", "p", "T"):
        np.testing.assert_allclose(got[f"default/{name}"],
                                   np.asarray(getattr(js, name)),
                                   rtol=1e-9, atol=1e-11, err_msg=name)
    for d in range(3):
        np.testing.assert_allclose(got[f"default/u_face_{d}"],
                                   np.asarray(js.u_faces[d]), rtol=1e-9,
                                   atol=1e-11, err_msg=f"faces {d}")


@pytest.mark.parametrize("world", sorted(LAUNCHES))
def test_each_rank_ledger_is_the_single_controller_ledger(launched, world):
    """Every rank records the transport calls it executes under the JAX
    op names and per-device bytes: for one step of each path, each rank's
    ledger equals the single-controller mesh's, which moves something."""
    for path in LAUNCHES[world]:
        want = launched["ref_records"][path].get("ledger")
        if want is None:
            continue
        assert want["collective-permute"]["count"] > 0
        assert want["all-reduce"]["count"] > 0
        for rec in launched["records"][world]:
            assert rec["paths"][path]["ledger"] == want, (path, rec["rank"])


def test_derived_gather_column_equals_the_ranks_stats(launched):
    """scripts/torch_comm_bytes.py's process-mesh column, derived from
    the ledger (the partial bytes of every psum and pmax times the shards
    of the other ranks: 2 of the 4 here, two shards a rank), equals the
    bytes each of the 2 ranks received in all-gathers during the
    ledger's step (``parallel/dist.py`` ``stats``), on every path with a
    ledger; nothing else was all-gathered."""
    spec = importlib.util.spec_from_file_location(
        "torch_comm_bytes", os.path.join(ROOT, "scripts",
                                         "torch_comm_bytes.py"))
    cb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cb)
    seen = 0
    for path in LAUNCHES[2]:
        for rec in launched["records"][2]:
            got = rec["paths"][path]
            if "ledger" not in got:
                continue
            tr = got["ledger_transport"]
            want = cb.gathered_bytes(got["ledger"], 4, world=2)
            assert want > 0
            assert tr["all_gather_received_bytes"] == want, (path,
                                                             rec["rank"])
            # what a rank puts in: its 2 partials a sum, as much as it
            # receives from the one other rank
            assert tr["all_gather_bytes"] == want
            assert tr["all_gather"] == got["ledger"]["all-reduce"]["count"]
            seen += 1
    assert seen == 2 * (len(LAUNCHES[2]) - 1)


def test_forced_miss_escalates_on_every_rank_at_the_same_step(launched):
    """With `helmholtz tol` beyond the sweeps' reach, run escalates at its
    first step on both ranks, as on one process, and the window counts
    down alike; a multi_step chunk is retried with full CG on both."""
    ref = launched["ref_records"]["escalate"]
    assert ref["escalations_by_step"][0] == 1
    assert ref["chunk_escalations"] == 1 and ref["chunk_retry_warned"]
    for rec in launched["records"][2]:
        got = rec["paths"]["escalate"]
        for key in ("escalations_by_step", "strong_steps_left",
                    "chunk_escalations", "chunk_strong_steps_left",
                    "chunk_retry_warned"):
            assert got[key] == ref[key], (key, rec["rank"])


def test_checkpoint_of_two_ranks_restores_bitwise(launched):
    """Each of the 2 ranks wrote its own shards of every path's final
    state under their global index, rank 0 the master; the checkpoint
    restores bitwise onto the ranks' own mesh (each rank reading its own
    blocks), the single-controller mesh and one device."""
    got = launched["results"]
    for path in LAUNCHES[2]:
        assert launched["ref_records"][path]["restored_bitwise"], path
        for rec in launched["records"][2]:
            assert rec["paths"][path]["restored_bitwise"], \
                (path, rec["rank"])
    for path in ("default", "box"):
        stem = os.path.join(launched["ckpt"], path)
        with open(stem + ".json") as f:
            meta = json.load(f)
        assert meta["n_shards"] == 4 and meta["path"] == path
        assert all(os.path.exists(f"{stem}.shard{k:03d}.npz")
                   for k in range(4))
        one, _ = tck.load_checkpoint_sharded(stem, "cpu")
        model = smoke.make_model(path, "cpu")
        mesh = build_mesh(model.geo, ["cpu"] * 4)
        sharded, _ = tck.load_checkpoint_sharded(stem, geo=model.geo,
                                                 mesh=mesh)
        for state in (one, unshard_state(sharded)):
            assert state.step_number == smoke.PATHS[path][2]
            for name in ("u", "p", "T"):
                np.testing.assert_array_equal(
                    getattr(state, name).numpy(), got[f"{path}/{name}"])
            for d, f in enumerate(state.u_faces):
                np.testing.assert_array_equal(f.numpy(),
                                              got[f"{path}/u_face_{d}"])


def test_sharded_vts_of_two_ranks_bytes_equal_one_process(launched):
    """Each of the 2 ranks wrote the .vts pieces of its own shards of
    every path's final state, rank 0 the .pvts once both had: the files
    are byte for byte those of the single-controller mesh."""
    for path in LAUNCHES[2]:
        names = [f"{path}.pvts"] + [f"{path}.p{k:03d}.vts"
                                    for k in range(4)]
        for name in names:
            with open(os.path.join(launched["ckpt"], name), "rb") as f:
                mine = f.read()
            with open(os.path.join(launched["ref_ckpt"], name), "rb") as f:
                assert mine == f.read(), name


def test_ranks_report_and_import_no_jax(launched):
    """Every rank names its backend and device, holds its own block of
    shards in shard order, printed the smoke step's finite max|u| and
    divergence (2 ranks), and imported neither JAX nor the JAX package."""
    for world, recs in launched["records"].items():
        per = smoke.PATHS[LAUNCHES[world][0]][1] // world
        for r, rec in enumerate(recs):
            assert (rec["rank"], rec["world"], rec["backend"],
                    rec["device"]) == (r, world, "gloo", "cpu")
            assert not rec["imported_jax"]
            shards = rec["paths"][LAUNCHES[world][0]]["shards"]
            assert len(shards) == per
    for r, text in enumerate(launched["outs"][2]):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"[rank {r}/2] gloo on cpu"))
        vals = [float(x.split("=")[1]) for x in line.split()
                if x.startswith(("max|u|=", "div="))]
        assert len(vals) == 2 and np.isfinite(vals).all()


@pytest.mark.parametrize("backend, device, error", [
    ("nccl", "cpu", ValueError),       # NCCL needs CUDA
    (None, "cpu", ValueError),         # a CPU rank names its backend
    ("gloo", "cuda:0", RuntimeError),  # CUDA asked for, none here
    ("mpi", "cpu", ValueError),        # not a backend of the mesh
])
def test_init_ranks_refuses_without_guessing(backend, device, error):
    """No silent fallback: the backend and the device are named, and a
    request this machine cannot serve raises before any rendezvous."""
    if device.startswith("cuda") and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(error):
        pdist.init_ranks(backend, device, init_method="file:///nowhere",
                         rank=0, world_size=1)


def test_init_ranks_needs_cuda_by_default(monkeypatch):
    """A rank given no device takes cuda:LOCAL_RANK, and raises where
    CUDA is not available."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdist.init_ranks("gloo", None, init_method="file:///nowhere",
                         rank=0, world_size=1)
