"""A run's control flow on the CPU at a tiny size, and its check failing
under each fault a cell can have.

Each run here is ``run.run_cell`` with the card's look skipped
(``device="cpu"``): the program's engine runs its plain tracker, the
reference its frozen copy, so a sound run compares equal path for path.
The sizes are the cells' configurations and traffic with fewer hypotheses
(one chunk of one per abort chunk) and a pool of two views of 400 edgels;
about a minute and a half a run with two threads.  The faults are planted
in the program under the timed path: a tracking step that returns its state
unchanged, half of the batch left untracked, and the returned pose altered
where the round produces it.  The cells run on one chip: there is no
exchange between chips to leave out.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run  # noqa: E402

# (hypotheses, abort chunk, run seed): seeds whose tiny sound run finds the
# pose.
TINY = {"full-ransac.clean": (1, 1, 12_345_678_901),
        "trunransac.clean": (2, 1, 3_000_000_011)}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name, **hc):
    h, chunk, seed = TINY[name]
    cell = run.load_cell(name)
    eng = cell["config"]["engine"]
    eng["ransac"].update(num_iterations=h, abort_chunk=chunk)
    eng["hc"].update(hc)
    cell["traffic"].update(pool_views=2, edgels_per_view=400)
    return cell, seed


def rehearse(name, trace=False, **hc):
    cell, seed = tiny(name, **hc)
    result, numbers = run.run_cell(cell, seed, 0.0, trace, device="cpu")
    return cell, result, numbers


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert run.main(["--workload", "full-ransac.clean", "--seed", "1",
                     "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run(name):
    cell, result, numbers = rehearse(name)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert numbers["paths_differ"][0] == 0.0
    assert set(result["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics():
    # Two steps a path keep the CPU profile small; no path converges, so
    # neither side has a pose, and the two still agree.
    name = "trunransac.clean"
    cell, result, _ = rehearse(name, trace=True, max_steps=2)
    assert result["correct"]
    names = set(result["metrics"])
    # On the CPU the trace holds no kernel, so the kernel's roofline is
    # left out; every other per-layer metric is read.
    assert names == {m["name"] for m in cell["per_layer"]} - {
        "hc_track_roofline"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _unchanged(monkeypatch):
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

    monkeypatch.setattr(fused, "track_plain",
                        lambda c, cfg, x, xl, fl, efg, **kw:
                        (x.clone(), xl.clone(), fl.clone()))


def _half(monkeypatch):
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused

    full = fused.track_plain

    def half(c, cfg, x, xl, fl, efg, **kw):
        n = x.shape[0] // 2
        out = full(c, cfg, x[:n], xl[:n], fl[:n], efg[:n], **kw)
        return tuple(torch.cat([a, b[n:]]) for a, b in zip(out, (x, xl, fl)))

    monkeypatch.setattr(fused, "track_plain", half)


def _altered(monkeypatch):
    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine

    score = engine.TrifocalPoseEngine._score_round

    def altered(self, *a, **kw):
        out = score(self, *a, **kw)
        if out["best_pose"] is not None:
            c, s = np.cos(0.2), np.sin(0.2)
            rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
            r21, r31, t21, t31 = out["best_pose"]
            out["best_pose"] = (rz @ r21, r31, t21, t31)
        return out

    monkeypatch.setattr(engine.TrifocalPoseEngine, "_score_round", altered)


FAULTS = {"unchanged_state": _unchanged, "half_batch": _half,
          "altered_pose": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(TINY))
def test_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    _, result, numbers = rehearse(name)
    assert not result["correct"], numbers


def test_forbidden_module_ends_the_run():
    planted = "flax.planted_by_hcbench_test"
    sys.modules[planted] = types.ModuleType(planted)
    try:
        cell, seed = tiny("full-ransac.clean", max_steps=2)
        with pytest.raises(run.ForbiddenModules) as e:
            run.run_cell(cell, seed, 0.0, False, device="cpu")
        assert e.value.args[0] == [planted]
    finally:
        del sys.modules[planted]
