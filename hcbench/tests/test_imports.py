"""What the benchmark imports and reads: no JAX and no JAX package anywhere,
nothing of the program in the reference and its frozen copies, and none of
the JAX package's benchmark files."""

import ast
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run  # noqa: E402

HCBENCH = os.path.join(ROOT, "hcbench")
PORT = "trifocal_pose_estimation_using_improved_gpuhc_torch"
SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(HCBENCH) for f in fs
    if f.endswith(".py") and "__pycache__" not in d)
# The files a run runs (not the tests).
RUNS = [p for p in SOURCES
        if os.path.relpath(p, HCBENCH).split(os.sep)[0] != "tests"]
# The files the reference runs: they take nothing of the program.
REFERENCE = [p for p in SOURCES
             if os.path.relpath(p, HCBENCH).split(os.sep)[0] in (
                 "plain", "reference.py", "views.py", "trace.py", "metrics",
                 "drivers")]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax.numpy"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax.linen", "jaxlib.xla_client"]),
    (["trifocal_pose_estimation_using_improved_gpuhc_tpu.ops.fused"],
     ["trifocal_pose_estimation_using_improved_gpuhc_tpu.ops.fused"]),
    # Whole top-level names: the port's name begins with the JAX package's
    # stem, and other packages begin with "jax".
    ([PORT, PORT + ".engine", "jaxtyping", "flaxen", "jax_extra"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not run.forbidden_modules(_imports(path))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[os.path.relpath(p, ROOT) for p in REFERENCE])
def test_reference_takes_nothing_of_the_program(path):
    assert not [m for m in _imports(path) if m.split(".")[0] == PORT]


def _strings(path):
    """The string constants of a file other than its docstrings."""
    tree = ast.parse(open(path).read())
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", RUNS,
                         ids=[os.path.relpath(p, ROOT) for p in RUNS])
def test_no_file_names_the_jax_packages_benchmark_or_tools(path):
    for s in _strings(path):
        assert not any(name in s for name in (
            "bench.py", "BENCH_r", "MULTICHIP_", "BASELINE")), s
        assert s != "tools" and not s.startswith("tools/"), s


def test_plain_copies_import_only_plain_copies():
    for path in REFERENCE:
        for m in _imports(path):
            top = m.split(".")[0]
            assert top in ("hcbench", "numpy", "torch", "dataclasses",
                           "typing", "collections", "bisect", "json", "os",
                           "contextlib",
                           "__future__", "time", "yaml"), (path, m)
