"""Nothing under port_bench/ imports jax or the JAX package."""

import ast

import pytest

from port_bench import spec

FILES = sorted(p for p in spec.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_import(path):
    for name in _imported(ast.parse(path.read_text())):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "tpu_bench"), (path, name)
