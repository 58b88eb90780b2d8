"""A cell over four cards, taken through data files alone.

A copy of the benchmark gains a configuration whose engine shards over
``num_devices`` 4, a limits file and a cell of four chips in its
BENCHMARK.json, and nothing else; its run.py loads the cell and runs it on
the CPU at a tiny size, the engine's mesh four CPU shards
(``["cpu"] * 4``).  The sharded run is correct and tracks the paths that
the one-shard cell tracks on the same seed; with one shard's block left
untracked it is not correct.  A cell whose chips differ from its
configuration's shards is refused before it runs.

The tiny size: four hypotheses (one a shard), two segments of 8 steps a
path, a pool of two views of 400 edgels; about a minute a run with two
threads.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL = "full-ransac-4gpu.clean"
SEED = 4_000_000_019


def snapshot(root):
    return {p: p.read_bytes() for p in (root / "hcbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_cell(root, name="full-ransac-4gpu", chips=4, shards=4):
    """A copy of the benchmark under ``root`` with a configuration of
    ``shards`` shards and a cell of ``chips`` chips added as new files and
    entries; the files it had are left as they were."""
    shutil.copytree(os.path.join(ROOT, "hcbench"), root / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "data"), root / "data")
    before = snapshot(root)
    sizes = json.load(open(os.path.join(ROOT, "hcbench", "configs",
                                        "full-ransac.json")))
    sizes["engine"]["num_devices"] = shards
    sizes["deployment"] = "the reference's Num_Of_GPUs split, 25 " \
                          "hypotheses a card"
    (root / "hcbench" / "configs" / f"{name}.json").write_text(
        json.dumps(sizes))
    (root / "hcbench" / "limits" / f"{name}.clean.json").write_text(
        (root / "hcbench" / "limits" / "full-ransac.clean.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    entry = dict({c["name"]: c for c in bench["configs"]}["full-ransac"],
                 name=name, file=f"hcbench/configs/{name}.json",
                 why="the full round sharded over four cards")
    bench["configs"].append(entry)
    bench["workloads"].append({"name": f"{name}.clean", "config": name,
                               "traffic": "clean", "chips": chips,
                               "why": "hypotheses sharded over the cards"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert snapshot(root).items() >= before.items()
    return run.load_module(str(root / "hcbench" / "run.py"))


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield add_cell(tmp_path_factory.mktemp("bench"))
    torch.set_num_threads(n)


def tiny(copy, name):
    cell = copy.load_cell(name)
    eng = cell["config"]["engine"]
    eng["ransac"].update(num_iterations=4)
    eng["hc"].update(max_steps=16)
    cell["traffic"].update(pool_views=2, edgels_per_view=400)
    return cell


def rehearse(copy, monkeypatch, name):
    """(result, compared numbers, the checked request) of a tiny run of
    the copy's cell."""
    records = []

    class Kept(copy.RunRecord):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            records.append(self)

    monkeypatch.setattr(copy, "RunRecord", Kept)
    result, numbers = copy.run_cell(tiny(copy, name), SEED, 0.0, False,
                                    device="cpu")
    return result, numbers, records[0].requests[records[0].checked]


def test_the_copy_takes_the_cell(copy):
    cell = copy.load_cell(CELL)
    assert cell["workload"]["chips"] == 4
    assert cell["config"]["engine"]["num_devices"] == 4
    assert cell["limits"] == run.load_cell("full-ransac.clean")["limits"]
    assert copy.mesh_devices("cpu", 4) == ["cpu"] * 4
    assert copy.mesh_devices("cuda:0", 4) == [f"cuda:{i}" for i in range(4)]


def test_sharded_run_is_correct_and_tracks_the_one_shard_paths(
        copy, monkeypatch):
    result, numbers, four = rehearse(copy, monkeypatch, CELL)
    assert result["correct"], result["checks"]
    assert numbers["paths_differ"][0] == 0.0
    assert result["device"]["count"] == 4
    _, _, one = rehearse(copy, monkeypatch, "full-ransac.clean")
    assert (four.view, four.sample_seed) == (one.view, one.sample_seed)
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(getattr(four, f), getattr(one, f)), f
    assert len(four.num_steps) == 4 * 307 and four.num_steps.max() > 8
    assert run.pose_gap(four.best_pose, one.best_pose) == 0.0


def test_a_shard_left_untracked_is_not_correct(copy, monkeypatch):
    from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
        mesh,
    )

    def advance(self):
        for sh, r in zip(self.shards, self.runs):
            with sh.enter():
                if r is self.runs[-1]:
                    r._boundary()  # its segment never launched
                else:
                    r.advance()

    monkeypatch.setattr(mesh._ShardedRun, "advance", advance)
    result, numbers, req = rehearse(copy, monkeypatch, CELL)
    assert not result["correct"], numbers
    assert (req.num_steps[-307:] == 0).all()


@pytest.mark.parametrize("chips,shards", [(4, 1), (1, 4)])
def test_chips_other_than_the_shards_are_refused(tmp_path, chips, shards):
    add_cell(tmp_path, "mismatch", chips=chips, shards=shards)
    out = subprocess.run(
        [sys.executable, "hcbench/run.py", "--workload", "mismatch.clean",
         "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "num_devices" in out.stderr
