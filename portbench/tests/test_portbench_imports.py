"""No module of portbench imports JAX, flax or the JAX package, and the
reference imports nothing of the port: top-level names compared whole
(``dycoreplanet_tpu_torch`` begins with ``dycoreplanet_tpu``)."""

import ast
import os

import pytest

from core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dycoreplanet_tpu"}


def modules():
    for dirpath, _, files in os.walk(spec.HERE):
        if "_cache" in dirpath or "tests" in os.path.relpath(dirpath,
                                                              spec.HERE):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


PATHS = sorted(modules())


@pytest.mark.parametrize("path", PATHS,
                         ids=[os.path.relpath(p, spec.HERE) for p in PATHS])
def test_no_jax(path):
    names = set(top_names(path))
    assert not names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "dycoreplanet_tpu_torch" not in names
        assert "core" not in names


def test_the_whole_name_is_compared():
    import run

    assert "dycoreplanet_tpu" in run.FORBIDDEN
    assert "dycoreplanet_tpu_torch".split(".")[0] not in run.FORBIDDEN
