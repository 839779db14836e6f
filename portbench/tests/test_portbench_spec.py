"""BENCHMARK.json against the contract's shapes, and every cell's files
found by name."""

import json
import os
import re

import pytest

from core import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # 2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s a cell to
    # compile, 1200 s spare, with the full 24 cells, within 43200 s
    n = 24
    assert ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200
            <= 43200)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve(name):
    c = spec.cell(name)
    assert c.chips == 1
    assert set(c.limits) == set(check.NUMBERS)
    for key in ("grid", "dt", "chunk", "segment", "seed_rule",
                "trace_chunks", "sample_segments"):
        assert key in c.traffic
    assert c.traffic["segment"] % c.traffic["chunk"] == 0
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_and_units(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        for w in metric.get("workloads", []):
            assert w in CELLS
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_names_configs_and_files():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))[
            "reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_file_names_under_paths():
    for dirpath, _, files in os.walk(spec.HERE):
        if "_cache" in dirpath or "__pycache__" in dirpath:
            continue
        rel = os.path.relpath(dirpath, spec.ROOT)
        for f in files:
            assert re.match(r"^[A-Za-z0-9_./\-]+$", os.path.join(rel, f))


def test_only_a_closed_loop_is_run(monkeypatch):
    """A traffic mix whose loop is not the closed one that the window
    runs is refused, not run as another."""
    load = spec.load_json

    def opened(path):
        data = load(path)
        return dict(data, loop="open") if "traffic" in path else data
    monkeypatch.setattr(spec, "load_json", opened)
    with pytest.raises(ValueError, match="closed"):
        spec.cell(CELLS[0])


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_is_its_source_but_for_reduced(config):
    """Each configuration file holds its source prm (the repo's copy
    under data/, read by the port's own parser) in every key that
    ``reduced`` does not name."""
    import dataclasses

    from dycoreplanet_tpu_torch.base.params import Parameters

    prm = os.path.join(spec.ROOT, "data",
                       config["source"].rsplit("/", 1)[-1])
    want = dataclasses.asdict(Parameters.from_file(prm))
    got = spec.load_json(os.path.join(spec.ROOT, config["file"]))
    differ = []
    for key, value in got.items():
        if key not in want or key in config["reduced"]:
            continue
        if isinstance(value, dict):
            differ += [f"{key}.{k}" for k, v in value.items()
                       if want[key][k] != v]
        elif want[key] != value:
            differ.append(key)
    assert not differ
