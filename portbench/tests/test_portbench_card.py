"""One short run of every cell through the command, on the card (the
``cuda`` marker: skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         name, "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace",
         "0"], capture_output=True, text=True, cwd=spec.ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    command exits non-zero and prints no result."""
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
