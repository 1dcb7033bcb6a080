"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either: each import's
top-level name (before the first dot) compared whole."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "ubpl_tpu"}
MODULES = sorted(
    os.path.relpath(os.path.join(d, f), BENCH)
    for d, _, files in os.walk(BENCH) for f in files if f.endswith(".py"))


def top_level_imports(path):
    """Top-level names of every absolute import in the file (relative
    imports stay inside the benchmark)."""
    with open(os.path.join(BENCH, path)) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES)
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", [m for m in MODULES
                                  if m.startswith("reference" + os.sep)])
def test_reference_stands_alone(path):
    names = top_level_imports(path)
    assert not names & (JAX | {"ubpl_torch", "benchmark"})
    # and the standard library's module finding for the registry
    assert names <= {"torch", "numpy", "math", "typing", "dataclasses",
                     "importlib", "pkgutil"}


def test_names_compared_whole():
    # the port's name begins with the JAX package's name; only a whole
    # top-level name counts
    assert "ubpl_torch".split(".")[0] not in JAX
    assert "ubpl_tpu.config".split(".")[0] in JAX
