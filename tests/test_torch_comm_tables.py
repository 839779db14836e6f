"""scripts/torch_comm_bytes.py, the port's weak and strong scaling tables
(the counterpart of scripts/comm_bytes.py), on the CPU at a tiny size in
f64 for 1, 2 and 4 shards: each row is the communication ledger of one
mesh step of the same model built anew (``parallel/comm_analysis.py``
``step_comm_summary``), on the mesh ``mesh_shape_for`` lays out; one
shard moves nothing across a shard boundary; no all-to-all and no
reduce-scatter anywhere; the process-mesh column is the ledger's
all-reduce bytes times n - 1 (tests/test_torch_dist.py holds it against
``parallel/dist.py`` ``stats`` of a 2-rank launch)."""

import importlib.util
import os

import pytest

from dycoreplanet_tpu_torch.entry import _make_model
from dycoreplanet_tpu_torch.parallel.comm_analysis import (
    COLLECTIVE_OPS, step_comm_summary)
from dycoreplanet_tpu_torch.parallel.mesh import (
    build_mesh, mesh_shape_for, shard_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_comm_bytes.py")

_spec = importlib.util.spec_from_file_location("torch_comm_bytes", SCRIPT)
cb = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cb)

PER_SHARD = (4, 8, 16)
BASE = (4, 16, 32)
SHARDS = (1, 2, 4)
SIZES = {"weak": PER_SHARD, "strong": BASE}


@pytest.fixture(scope="module")
def tables():
    return {kind: cb.scaling_rows(kind, size, "cpu", "float64", SHARDS)
            for kind, size in SIZES.items()}


@pytest.mark.parametrize("kind", sorted(SIZES))
def test_rows_equal_the_ledger_of_the_same_model(tables, kind):
    """Each row: the ledger of one step of _make_model("float64", grid)
    prepared on its mesh of n shards, built here anew; the mesh as
    mesh_shape_for lays it out; the weak grid the shard's times the
    mesh."""
    for row in tables[kind]:
        n = row["shards"]
        model = _make_model("float64", row["grid"], device="cpu")
        mesh = build_mesh(model.geo, ["cpu"] * n)
        assert row["mesh"] == tuple(mesh.grid) == \
            mesh_shape_for(model.geo, n)[1:]
        if kind == "weak":
            a, b = row["mesh"]
            assert row["grid"] == (PER_SHARD[0], PER_SHARD[1] * a,
                                   PER_SHARD[2] * b)
        else:
            assert row["grid"] == BASE
        model.prepare_sharded(mesh)
        state = shard_state(model.initial_state(), model.geo, mesh)
        want = step_comm_summary(model, state,
                                 model._scalar(model.params.time_step))
        assert row["summary"] == want, (kind, n)
        assert row["gathered"] == (n - 1) * want["all-reduce"]["bytes"]


def test_one_shard_moves_nothing_and_no_transposes(tables):
    """At one shard no permute and no gather cross a shard boundary and
    the process-mesh column is 0; on every mesh all-to-all and
    reduce-scatter are 0 (the port transposes no field across the mesh)
    and the halos are permutes."""
    for kind, rows in tables.items():
        one = rows[0]
        assert one["shards"] == 1
        for op in ("collective-permute", "all-gather", "all-to-all",
                   "reduce-scatter"):
            assert one["summary"][op] == {"count": 0, "bytes": 0}
        assert one["gathered"] == 0
        for row in rows:
            for op in ("all-to-all", "reduce-scatter"):
                assert row["summary"][op] == {"count": 0, "bytes": 0}
            assert row["summary"]["all-reduce"]["count"] > 0
        for row in rows[1:]:
            assert row["summary"]["collective-permute"]["count"] > 0
            assert row["gathered"] > 0


def test_weak_all_reduce_bytes_grow_with_the_global_grid(tables):
    """Weak scaling: the sums' partials are of the global spectral
    field, so their bytes grow with n; strong scaling: they stay."""
    weak = [r["summary"]["all-reduce"]["bytes"] for r in tables["weak"]]
    strong = [r["summary"]["all-reduce"]["bytes"] for r in tables["strong"]]
    assert weak[0] < weak[1] < weak[2]
    assert len(set(strong)) == 1


def test_gathered_bytes_by_ranks():
    """The process-mesh column for several shards a rank: a rank
    receives the partials of the other ranks' shards."""
    s = {"all-reduce": {"count": 3, "bytes": 100}}
    assert cb.gathered_bytes(s, 4) == 300           # one shard a rank
    assert cb.gathered_bytes(s, 4, world=2) == 200  # two shards a rank
    assert cb.gathered_bytes(s, 4, world=1) == 0    # one process
    assert cb.gathered_bytes(s, 1) == 0


def test_command_line(capsys):
    """The script's two tables in the JAX script's markdown layout:
    devices, global grid, `count / MB` for each op of COLLECTIVE_OPS,
    then the process-mesh column; one row a shard count."""
    assert cb.main(["--device", "cpu", "--per-shard", "4x8x16", "--base",
                    "4x16x32"]) == 0
    out = capsys.readouterr().out
    assert "## Weak scaling (per-shard grid fixed at 4x8x16, float32)" in out
    assert "## Strong scaling (global grid fixed at 4x16x32, float32)" in out
    head = ("| devices | global grid | " + " | ".join(COLLECTIVE_OPS)
            + f" | {cb.GATHERED} (MB) |")
    assert out.count(head) == 2
    rows = [ln for ln in out.splitlines()
            if ln.startswith("| ") and not ln.startswith("| devices")]
    assert [r.split(" | ")[0] for r in rows] == ["| 1", "| 2", "| 4",
                                                 "| 8"] * 2
    assert rows[3].split(" | ")[1] == "4x16x64"
    assert all(c.endswith(" MB") for r in rows
               for c in r.split(" | ")[2:2 + len(COLLECTIVE_OPS)])
