"""The port's command line (``python -m
trifocal_pose_estimation_using_improved_gpuhc_torch.cli``) on the CPU, in
subprocesses: one round at one hypothesis writes the reference's four
output files and loads no jax module; its default output directory lies
under build/; without a card and without ``--platform cpu`` it exits
nonzero; ``--ablation`` with ``--devices 2`` is refused before any
tracking; ``--devices 2 --platform cpu`` runs over two CPU shards
(in-process, with a 2-step budget).

The cross-check (``--cross-check``) runs in-process at one hypothesis on
the CPU, with the engine's rounds recorded: it writes the oracle's two
files, and its printed disagreement count, totals, supports and exit code
are the JAX CLI's rule applied to the two rounds it ran, with the JAX
CLI's band constants."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("flags,reason", [
    (["--ablation", "--devices", "2"], "its P2C rung runs on one device"),
])
def test_cli_refuses_flags_not_ported(tmp_path, flags, reason):
    """Refused before the engine is built: no output directory, no round
    line, and the message says why (the ladder's P2C rung does not shard:
    the JAX engine would track it with its oracle)."""
    out = tmp_path / "out"
    proc = _cli(["--platform", "cpu", "--hypotheses", "1", "--output-dir",
                 str(out)] + flags, timeout=120)
    assert proc.returncode != 0
    assert reason in proc.stderr
    assert "round" not in proc.stdout and not out.exists()


def test_cli_shards_over_cpu_devices(tmp_path, monkeypatch, capsys,
                                     _few_threads):
    """--devices 2 --platform cpu: one engine over two CPU shards, whose
    header says "over 2 devices", and whose rounds write the four files;
    in-process at one hypothesis (padded to two) with a 2-step budget."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch import cli, engine
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
    )

    load = config.config_for_data_root

    def short(*a):
        cfg = load(*a)
        return dataclasses.replace(cfg, hc=dataclasses.replace(
            cfg.hc, max_steps=1, segment_steps=1))

    monkeypatch.setattr(config, "config_for_data_root", short)
    meshes = []
    init = engine.TrifocalPoseEngine.__init__

    def recorded(self, *a, **k):
        init(self, *a, **k)
        meshes.append(self.mesh)

    monkeypatch.setattr(engine.TrifocalPoseEngine, "__init__", recorded)
    out = tmp_path / "out"
    rc = cli.main(["--platform", "cpu", "--hypotheses", "1", "--devices",
                   "2", "--output-dir", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert meshes == [[torch.device("cpu")] * 2]
    assert text.splitlines()[0].endswith(" over 2 devices"), text
    assert any(ln.startswith("view 000 round 0: track")
               for ln in text.splitlines())
    assert sorted(p.name for p in out.iterdir()) == [
        "GPUHC_Steps_of_Actual_Solutions.txt", "GPU_Converged_HC_tracks.txt",
        "GPU_Sols_Statistics.txt", "GPU_Timings.txt"]


@pytest.fixture
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_cli_cross_check_on_the_cpu(tmp_path, monkeypatch, capsys,
                                    _few_threads):
    """--cross-check at one hypothesis: the engine's round and the oracle's
    (backend "xla", on the CPU), the CPU_* files, and the verdict under the
    JAX CLI's rule (its constants) from the two rounds it ran."""
    from trifocal_pose_estimation_using_improved_gpuhc_tpu import cli as jcli
    from trifocal_pose_estimation_using_improved_gpuhc_torch import cli, engine

    rounds = []
    run_round = engine.TrifocalPoseEngine.run_round

    def recorded(self, *a, **k):
        rr = run_round(self, *a, **k)
        rounds.append((self.cfg.hc.backend, str(self.device), rr))
        return rr

    monkeypatch.setattr(engine.TrifocalPoseEngine, "run_round", recorded)
    out = tmp_path / "out"
    rc = cli.main(["--platform", "cpu", "--hypotheses", "1",
                   "--cross-check", "--output-dir", str(out)])
    text = capsys.readouterr().out
    # Warm-up, the timed round, then the cross-check's two rounds.
    assert [(b, d) for b, d, _ in rounds] == [("fused", "cpu")] * 3 + [
        ("xla", "cpu")]
    gpu, cpu = rounds[2][2], rounds[3][2]
    n_paths = len(gpu.converged)
    dis = int((gpu.solutions.converged != cpu.solutions.converged).sum())
    tol_paths = max(3, int(jcli._CC_FLIP_FRAC * n_paths))
    sup_tol = max(5, int(jcli._CC_SUP_FRAC * cpu.num_edgels))
    ok = (dis <= tol_paths
          and abs(gpu.stats.num_converged - cpu.stats.num_converged)
          <= tol_paths
          and abs(gpu.best_support21 - cpu.best_support21) <= sup_tol
          and abs(gpu.best_support31 - cpu.best_support31) <= sup_tol)
    line = (f"[cross-check] converged-flag disagreements: {dis}/{n_paths} "
            f"(tol {tol_paths}); conv totals {gpu.stats.num_converged} vs "
            f"{cpu.stats.num_converged} (tol {tol_paths}); support "
            f"{gpu.best_support21}/{gpu.best_support31} vs "
            f"{cpu.best_support21}/{cpu.best_support31} (tol {sup_tol}) -> "
            f"{'AGREE' if ok else 'MISMATCH'}")
    assert line in text.splitlines()
    assert rc == (0 if ok else 1)
    stats = (out / "CPU_Sols_Statistics.txt").read_text().split()
    assert [int(v) for v in stats] == [cpu.stats.num_converged,
                                       cpu.stats.num_infinity,
                                       cpu.stats.num_real]
    tracks = (out / "CPU_Converged_HC_tracks.txt").read_text()
    assert tracks.startswith(
        "-------------------- RANSAC Iteration 1 --------------------\n")
    assert _listed_paths(tracks) == cpu.stats.num_converged


def _listed_paths(text):
    """The converged paths listed in a *_Converged_HC_tracks.txt."""
    return len(re.findall(r"^\d+$", text, flags=re.M))


def test_cross_check_bands_are_the_jax_clis():
    from trifocal_pose_estimation_using_improved_gpuhc_tpu import cli as jcli
    from trifocal_pose_estimation_using_improved_gpuhc_torch import cli

    assert cli._CC_FLIP_FRAC == jcli._CC_FLIP_FRAC == 0.005
    assert cli._CC_SUP_FRAC == jcli._CC_SUP_FRAC == 0.002


@pytest.mark.parametrize("hyp,full,want", [
    (None, False, 2), (1, False, 1), (5, False, 2), (None, True, 100),
    (5, True, 5)])
def test_cross_check_tiers(hyp, full, want):
    """The fast tier checks min(hypotheses or 2, 2) hypotheses, the full
    tier the whole workload, as the JAX CLI does."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch import cli
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
    )

    args = cli._parser().parse_args(
        [] if hyp is None else ["--hypotheses", str(hyp)])
    assert cli.cross_check_hypotheses(args, config.EngineConfig(),
                                      full) == want


def test_cli_cross_check_without_a_card_exits_nonzero(tmp_path):
    proc = _cli(["--hypotheses", "1", "--cross-check", "--output-dir",
                 str(tmp_path / "out")], timeout=120, no_card=True)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "out").exists()
