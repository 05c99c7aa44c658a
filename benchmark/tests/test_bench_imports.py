"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port. Top-level names are compared
whole: the port's name begins with the JAX package's."""

import ast
import os

import pytest

from benchmark import core

FORBIDDEN = {"jax", "jaxlib", "flax", "gaussianrenderer_tpu"}
PORT = "gaussianrenderer_tpu_torch"


def modules():
    for dirpath, _, files in os.walk(core.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, core.ROOT))
def test_no_jax(path):
    names = set(top_names(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert PORT not in names


def test_whole_name_comparison():
    # "gaussianrenderer_tpu_torch" is the port, not the JAX package.
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "gaussianrenderer_tpu.ops".split(".")[0] in FORBIDDEN
