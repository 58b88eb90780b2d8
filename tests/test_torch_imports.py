"""The torch port imports no jax and nothing of the JAX package (it must run
on a GPU host without them)."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_PKG = "trifocal_pose_estimation_using_improved_gpuhc_tpu"

_MODULES = [
    "trifocal_pose_estimation_using_improved_gpuhc_torch",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.engine",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.cli",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.models.monodromy",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.eval",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.fused",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops._kernels",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.bound",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.linalg",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.p2c",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.tracker",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.phases",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.ransac",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.reduce",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.schedule",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.segmented",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.parallel",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.parallel.mesh",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.utils.data_io",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.utils.evaluation",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.utils.tooling",
]


@pytest.fixture(scope="module")
def loaded_after_import():
    """In a fresh interpreter, import the modules one by one and record
    which jax and JAX-package modules are loaded after each."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for m in {_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "    out[m] = sorted(k for k in sys.modules if k == 'jax' or "
        f"k.startswith(('jax.', 'jaxlib', {_JAX_PKG!r})))\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", _MODULES)
def test_port_module_imports_no_jax(loaded_after_import, module):
    assert loaded_after_import[module] == []


def _imported_names(path):
    """Every module name an import statement of the file names."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_chip_smoke_names_no_jax_module():
    """chip_smoke.py imports the port inside main, so it is read, not run."""
    names = list(_imported_names(os.path.join(REPO, "chip_smoke.py")))
    assert any(n.startswith("trifocal_pose_estimation_using_improved_gpuhc_"
                            "torch") for n in names)
    for n in names:
        assert not n.startswith((_JAX_PKG, "jax")), n


def test_microbench_torch_names_no_jax_module():
    """tools/microbench_torch.py imports the port inside main, so it is
    read, not run."""
    names = list(_imported_names(os.path.join(REPO, "tools",
                                              "microbench_torch.py")))
    assert any(n.startswith("trifocal_pose_estimation_using_improved_gpuhc_"
                            "torch") for n in names)
    for n in names:
        assert not n.startswith((_JAX_PKG, "jax")), n


@pytest.mark.parametrize("tool", ["profile_torch_round.py",
                                  "time_torch_tracker.py",
                                  "scaling_torch.py",
                                  "f64_reconcile_torch.py",
                                  "reconcile_stats_torch.py",
                                  "accuracy_sweep_torch.py",
                                  "roofline_torch.py",
                                  "tile_sweep_torch.py",
                                  "span_probe_torch.py"])
def test_torch_tools_name_no_jax_module(tool):
    """The other tools/*_torch*.py import the port inside main, so they
    are read, not run."""
    names = list(_imported_names(os.path.join(REPO, "tools", tool)))
    assert any(n.startswith("trifocal_pose_estimation_using_improved_gpuhc_"
                            "torch") for n in names)
    for n in names:
        assert not n.startswith((_JAX_PKG, "jax")), n
