"""The four-card cell ``full-ransac-4card.clean`` and the readers of the
hypothesis mesh's spans.

* ``shard_lag_ms`` and ``mesh_move_ms`` on hand-built span lists: the lag
  of a ``mesh.advance`` that holds three shards' launches, the scatter and
  the gather summed per view, and None for a program that records no
  ``mesh.*`` span (a round on one card, or a mesh without spans).
* The committed cell at the tiny size of ``test_four_cards.py`` (four
  hypotheses, one a shard, 17 steps in the configuration's one segment,
  two views of 400 edgels) on four CPU shards: correct against the plain reference, the
  paths of ``full-ransac.clean``'s tiny run on the same seed, and both
  readers non-null on its requests.  About a minute a run with two
  threads.
"""

import collections
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run  # noqa: E402
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (  # noqa: E402
    spans,
)

CELL = "full-ransac-4card.clean"
SEED = 4_000_000_019
BASE = 1_790_000_000 * 10**9   # CLOCK_REALTIME ns, as the program stamps


def _spans(rows):
    """(name, start ms, end ms, parent) -> the program's ns spans."""
    return [(n, BASE + int(a * 1e6), BASE + int(b * 1e6), p)
            for n, a, b, p in rows]


# Two boundaries over three shards: the launches of the first end at 3,
# 6 and 10 ms (lag 7), of the second at 32, 33 and 35 (lag 3); the
# scatter lasts 2 ms and the gather 4.
MESH = _spans([
    ("round", 0, 60, -1),
    ("round.track", 0, 50, 0),
    ("mesh.scatter", 0, 2, 1),
    ("mesh.advance", 2, 12, 1),
    ("segment.launch", 2, 3, 3),
    ("segment.boundary", 3, 4, 3),
    ("segment.launch", 4, 6, 3),
    ("segment.boundary", 6, 7, 3),
    ("segment.launch", 7, 10, 3),
    ("segment.boundary", 10, 12, 3),
    ("mesh.keep", 12, 30, 1),
    ("segment.wait", 12, 28, 10),
    ("segment.wait", 28, 29, 10),
    ("segment.wait", 29, 30, 10),
    ("mesh.advance", 30, 36, 1),
    ("segment.launch", 30, 32, 14),
    ("segment.boundary", 32, 32, 14),
    ("segment.launch", 32, 33, 14),
    ("segment.boundary", 33, 34, 14),
    ("segment.launch", 34, 35, 14),
    ("segment.boundary", 35, 36, 14),
    ("mesh.keep", 36, 45, 1),
    ("mesh.gather", 45, 49, 1),
    ("round.unpack", 49, 50, 1),
])
# A round on one card: its segment spans directly under round.track.
ONE = _spans([
    ("round", 0, 30, -1),
    ("round.track", 0, 20, 0),
    ("segment.launch", 0, 2, 1),
    ("segment.boundary", 2, 3, 1),
    ("segment.wait", 3, 19, 1),
    ("round.unpack", 19, 20, 1),
])


def _read(name, rec):
    return run.load_module(os.path.join(ROOT, "hcbench", "metrics",
                                        f"{name}.py")).read(rec)


def _record(monkeypatch, rounds):
    """An untraced run of one request per round, the rounds laid in the
    program's log."""
    monkeypatch.setattr(spans, "finished", collections.deque(
        [(sp, {}) for sp in rounds], maxlen=spans.KEEP))
    reqs = [run.Request(i, 0, i, 100.0, track_ms=(
        next(e - s for n, s, e, _ in sp if n == "round.track") * 1e-6))
        for i, sp in enumerate(rounds)]
    return run.RunRecord(setup_s=1.0, window_s=1.0, requests=reqs, failed=0,
                         launches=0)


def test_readers_on_hand_built_spans(monkeypatch):
    rec = _record(monkeypatch, [MESH, ONE])
    assert _read("shard_lag_ms", rec) == pytest.approx((7 + 3) / 2, abs=1e-6)
    assert _read("mesh_move_ms", rec) == pytest.approx((2 + 4) / 2, abs=1e-6)


@pytest.mark.parametrize("name", ["shard_lag_ms", "mesh_move_ms"])
def test_no_mesh_span_reads_nothing(monkeypatch, name):
    assert _read(name, _record(monkeypatch, [ONE, ONE])) is None


@pytest.fixture(scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rehearse(monkeypatch, name):
    """(result, compared numbers, the checked request, the run's record)
    of a tiny run of a committed cell on the CPU."""
    records = []

    class Kept(run.RunRecord):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            records.append(self)

    monkeypatch.setattr(run, "RunRecord", Kept)
    cell = run.load_cell(name)
    eng = cell["config"]["engine"]
    eng["ransac"].update(num_iterations=4)
    eng["hc"].update(max_steps=16)
    cell["traffic"].update(pool_views=2, edgels_per_view=400)
    result, numbers = run.run_cell(cell, SEED, 0.0, False, device="cpu")
    rec = records[0]
    return result, numbers, rec.requests[rec.checked], rec


def test_the_cell_runs_correct_on_four_shards(two_threads, monkeypatch):
    cell = run.load_cell(CELL)
    assert cell["workload"]["chips"] == 4
    assert cell["config"]["engine"]["num_devices"] == 4
    result, numbers, four, rec = rehearse(monkeypatch, CELL)
    assert result["correct"], result["checks"]
    assert numbers["paths_differ"][0] == 0.0
    assert numbers["pose_differ"][0] == 0.0
    assert result["device"]["count"] == 4
    assert _read("shard_lag_ms", rec) >= 0.0
    assert _read("mesh_move_ms", rec) > 0.0
    _, _, one, rec1 = rehearse(monkeypatch, "full-ransac.clean")
    assert _read("shard_lag_ms", rec1) is None
    assert _read("mesh_move_ms", rec1) is None
    assert (four.view, four.sample_seed) == (one.view, one.sample_seed)
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(getattr(four, f), getattr(one, f)), f
    assert len(four.num_steps) == 4 * 307 and four.num_steps.max() > 8
    assert run.pose_gap(four.best_pose, one.best_pose) == 0.0
