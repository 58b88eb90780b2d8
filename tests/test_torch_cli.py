"""The port's command line (``python -m
trifocal_pose_estimation_using_improved_gpuhc_torch.cli``) on the CPU, in
subprocesses: one round at one hypothesis writes the reference's four
output files and loads no jax module; its default output directory lies
under build/; without a card and without ``--platform cpu`` it exits
nonzero; the flags of paths not ported yet
are refused before any tracking."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLI = "trifocal_pose_estimation_using_improved_gpuhc_torch.cli"
_JAX_PKG = "trifocal_pose_estimation_using_improved_gpuhc_tpu"
# Runs the CLI as ``python -m`` does, then prints the jax and JAX-package
# modules it loaded.
_RUN = (
    "import json, runpy, sys\n"
    "sys.argv = [{cli!r}] + {args!r}\n"
    "try:\n"
    "    runpy.run_module({cli!r}, run_name='__main__')\n"
    "    rc = 0\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith(('jax.', 'jaxlib', {pkg!r})))))\n"
    "sys.exit(rc)\n"
)


def _cli(args, timeout, no_card=False):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    if no_card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    code = _RUN.format(cli=_CLI, args=list(args), pkg=_JAX_PKG)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cli_round_on_the_cpu_writes_the_files(tmp_path):
    out = tmp_path / "out"
    proc = _cli(["--platform", "cpu", "--hypotheses", "1", "--views", "1",
                 "--output-dir", str(out)], timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert json.loads(lines[-1]) == []  # no jax module loaded
    assert any(ln.startswith("view 000 round 0: track") for ln in lines)
    assert " - [Average Computation Time]" in proc.stdout
    names = sorted(p.name for p in out.iterdir())
    assert names == ["GPUHC_Steps_of_Actual_Solutions.txt",
                     "GPU_Converged_HC_tracks.txt",
                     "GPU_Sols_Statistics.txt", "GPU_Timings.txt"]
    stats = (out / "GPU_Sols_Statistics.txt").read_text().split()
    assert len(stats) == 3 and int(stats[0]) > 0
    assert float((out / "GPU_Timings.txt").read_text()) > 0
    assert (out / "GPU_Converged_HC_tracks.txt").read_text().startswith(
        "-------------------- RANSAC Iteration 1 --------------------\n")


def test_cli_without_a_card_exits_nonzero(tmp_path):
    proc = _cli(["--hypotheses", "1", "--output-dir", str(tmp_path / "out")],
                timeout=120, no_card=True)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "out").exists()


def test_cli_writes_under_build_by_default():
    """The JAX CLI's default output directory holds the reference's
    committed outputs: the port's default lies under build/."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch import cli

    out = cli._parser().parse_args([]).output_dir
    assert out == os.path.join("build", "cli_out")
    assert "Output_Write_Files" not in out


@pytest.mark.parametrize("flags,item", [
    (["--cross-check"], "item 4"),
    (["--cross-check-full"], "item 4"),
    (["--ablation"], "item 7"),
    (["--devices", "2"], "item 5"),
])
def test_cli_refuses_flags_not_ported(tmp_path, flags, item):
    """Refused before the engine is built: no output directory, no round
    line, and the message names the ROADMAP.md Queue 1 item."""
    out = tmp_path / "out"
    proc = _cli(["--platform", "cpu", "--hypotheses", "1", "--output-dir",
                 str(out)] + flags, timeout=120)
    assert proc.returncode != 0
    assert f"ROADMAP.md Queue 1 {item}" in proc.stderr
    assert "round" not in proc.stdout and not out.exists()
