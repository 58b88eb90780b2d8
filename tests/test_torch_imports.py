"""The torch port imports no jax (it must run on a GPU host without it)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MODULES = [
    "trifocal_pose_estimation_using_improved_gpuhc_torch",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.engine",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.eval",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.fused",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops._kernels",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.ops.ransac",
    "trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config",
]


@pytest.fixture(scope="module")
def jax_after_import():
    """In a fresh interpreter, import the modules one by one and record
    which jax modules are loaded after each."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for m in {_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "    out[m] = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')))\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", _MODULES)
def test_port_module_imports_no_jax(jax_after_import, module):
    assert jax_after_import[module] == []
