"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the measured program. Module names are compared
by their top-level part, whole: ``retr_tpu_torch`` is not ``retr_tpu``."""

import ast
import os

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "retr_tpu"}


def _sources(sub=""):
    root = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    assert "retr_tpu_torch" not in set(_top_level_imports(path))


def test_the_name_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "retr_tpu_torch.fake_part", types.ModuleType("x"))
    assert "retr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "retr_tpu.fake_part", types.ModuleType("x"))
    assert "retr_tpu" in harness.forbidden_modules()
