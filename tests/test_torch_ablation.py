"""The engine's P2C backend and TrunPaths off, and the CLI's ablation
ladder, on the CPU.

* The P2C engine runs on the card unless asked for the CPU, never falls
  back, and (as the JAX engine) tracks in one call with no abort round.
* Rounds at H = 1 (view 0, seed 0, the full step budget), TrunPaths off:
  the PH round in one launch, the PH round segmented (equal to it path
  for path) and the P2C round.  None prunes a path.  The P2C round is the
  same parameter homotopy evaluated through the coefficient tables, whose
  map is the identity only up to its least-squares noise: per-path flags
  may differ by the 3.2 % band of tests/test_torch_engine.py (two float32
  trackers on this problem's near-singular endings), and do (measured: 6
  converged and 3 inf flags of 307 paths).
* ``run_ablation`` against the JAX CLI's function, both driving a stub
  engine that records its configurations and returns fixed rounds: the
  same five rungs with the same HC and RANSAC overrides, the same header,
  rows and seeds.  Then the port's CLI with ``--ablation --platform cpu
  --hypotheses 1 --times 1`` in-process at a step budget of 2 (the ladder's
  flow; its numbers come from the card): the header and the five rows.
"""

import argparse
import dataclasses
import os
import re
import types

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu import cli as jcli
from trifocal_pose_estimation_using_improved_gpuhc_tpu import engine as jengine
from trifocal_pose_estimation_using_improved_gpuhc_torch import cli, engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_H = 1
_FLIP_FRAC = 0.032
_OFF = dict(truncate_paths=False, compact_survivors=False)
_ROW = re.compile(r"^(.{44}) +([0-9.]+) +(\d+) +(True|False)$")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads, as in the other engine tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(**hc):
    cfg = config.EngineConfig(data_root=DATA)
    return dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc, **hc))


def test_p2c_engine_runs_on_the_card_by_default(monkeypatch):
    """No device means cuda:0, which raises without a card; on the CPU
    only when asked.  One call, no abort round, even with the abort on."""
    cfg = _cfg(backend="p2c")
    cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.TrifocalPoseEngine(cfg)
    e = engine.TrifocalPoseEngine(cfg, device="cpu")
    assert e.device.type == "cpu" and not e._segmented and not e._abort
    assert e.track.constants.q == 34


@pytest.fixture(scope="module")
def rounds():
    out = {}
    for name, hc in (("ph", dict(_OFF)), ("p2c", dict(_OFF, backend="p2c")),
                     ("segmented", dict(truncate_paths=False))):
        e = engine.TrifocalPoseEngine(_cfg(**hc), device="cpu")
        assert e._segmented == (name == "segmented")
        out[name] = e.run_round(e.load_view(0), seed=0, num_hypotheses=_H)
    return out


@pytest.mark.parametrize("name", ["ph", "p2c", "segmented"])
def test_trunpaths_off_prunes_nothing(rounds, name):
    rr = rounds[name]
    assert rr.pruned.shape == (_H * 307,) and not rr.pruned.any()
    assert rr.stats.num_converged > 0 and rr.num_steps.max() == 81


def test_segmented_equals_one_launch_without_trunpaths(rounds):
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(getattr(rounds["segmented"], f),
                              getattr(rounds["ph"], f)), f


@pytest.mark.parametrize("flag", ["converged", "inf_fail", "pruned"])
def test_p2c_round_flags_within_band(rounds, flag):
    a, b = rounds["p2c"], rounds["ph"]
    n = _H * 307
    assert int((getattr(a, flag) != getattr(b, flag)).sum()) \
        <= int(_FLIP_FRAC * n)
    assert abs(a.stats.num_converged - b.stats.num_converged) \
        <= int(_FLIP_FRAC * n)


class _StubEngine:
    """Records each rung's configuration; every round returns fixed
    numbers that depend on the rung and the seed."""

    made = []

    def __init__(self, cfg, device=None):
        self.cfg, self.device = cfg, device or "cpu"
        _StubEngine.made.append(self)
        self.seeds = []

    def load_view(self, i):
        return i

    def run_round(self, view, seed, num_hypotheses=None):
        self.seeds.append((view, seed, num_hypotheses))
        k = len(_StubEngine.made)
        return types.SimpleNamespace(
            track_ms=100.0 * k - 7.5 * seed,
            stats=types.SimpleNamespace(num_converged=10 * k + seed),
            found_pose=bool((k + seed) % 2))


def _knobs(e):
    h, r = e.cfg.hc, e.cfg.ransac
    return (h.backend, h.truncate_paths, h.compact_survivors,
            r.abort_by_good_sol)


def test_run_ablation_is_the_jax_ladder(monkeypatch, capsys):
    """The same rungs, overrides, header, rows and seeds as the JAX
    function, on the same stub rounds (the port adds a launches line per
    rung)."""
    args = argparse.Namespace(hypotheses=3, times=3, start_view=2)
    jcfg = config.config_for_data_root(DATA)
    monkeypatch.setattr(jengine, "TrifocalPoseEngine", _StubEngine)
    _StubEngine.made = []
    assert jcli.run_ablation(jcfg, args) == 0
    ref, ref_made = capsys.readouterr().out, _StubEngine.made
    monkeypatch.setattr(engine, "TrifocalPoseEngine", _StubEngine)
    _StubEngine.made = []
    assert cli.run_ablation(jcfg, args, "cpu") == 0
    got = capsys.readouterr().out
    assert [_knobs(e) for e in _StubEngine.made] == \
        [_knobs(e) for e in ref_made]
    assert [e.seeds for e in _StubEngine.made] == [e.seeds for e in ref_made]
    assert [ln for ln in got.splitlines()
            if not ln.startswith(" - hc_track")] == ref.splitlines()
    assert len(ref.splitlines()) == 7
    assert ref.splitlines()[0].endswith("x 307 paths (last row times to "
                                        "the accepted pose)")


def test_cli_ablation_on_the_cpu(monkeypatch, capsys, tmp_path):
    """The ladder through the CLI on the CPU: the header, five rows in the
    JAX format, and no kernel launch (the plain twin tracks)."""
    base = config.config_for_data_root

    def cheap(*a, **kw):
        cfg = base(*a, **kw)
        return dataclasses.replace(cfg, hc=dataclasses.replace(
            cfg.hc, max_steps=2))

    monkeypatch.setattr(config, "config_for_data_root", cheap)
    rc = cli.main(["--ablation", "--platform", "cpu", "--hypotheses", "1",
                   "--times", "1", "--output-dir", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    head = lines.index("## Strategy ablation: view 0, 1 hypotheses x 307 "
                       "paths (last row times to the accepted pose)")
    assert lines[head + 1] == (f"{'variant':44s} {'best ms':>9} "
                               f"{'conv':>6} {'found':>6}")
    rows = [_ROW.match(ln) for ln in lines[head + 2:]
            if not ln.startswith(" - ")]
    assert [m.group(1).rstrip() for m in rows] == [
        name for name, _, _ in cli.ABLATION_RUNGS]
    assert all(float(m.group(2)) > 0 for m in rows)
    launches = [ln for ln in lines if ln.startswith(" - hc_track")]
    assert launches == [" - hc_track kernel launches in 2 timed rounds: 0 "
                        "on cpu"] * 5
