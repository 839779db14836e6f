"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file, its limits file and the
readers of its metrics (``metrics/<name>.py``). A later cell, mix or
metric is added as files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List, NamedTuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = bench if bench is not None else benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    if traffic.get("loop") != "closed":
        # the window (core/cellrun.py) is one caller's closed loop
        raise ValueError(f"traffic {w['traffic']!r}: loop "
                         f"{traffic.get('loop')!r}, only 'closed' is run")
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    return Cell(name, w["chips"], config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
