"""The port's measurement tools (tools/*_torch.py) on the CPU: their pure
helpers on hand-made inputs, the roofline's arithmetic against
ops/bound.py, their refusal without a card, and the float64 oracle that
tools/f64_reconcile_torch.py holds float32 tracking to, against its own
float32 run on 16 flag-stable paths of one hypothesis over a short step
budget (two torch threads).  The tools themselves run on the card
(chip_smoke.py phase 15); tools/f64_reconcile.py, the JAX tool, is not run
here: it turns on jax_enable_x64 for the whole process."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    bound,
    fused,
    ransac,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
    tooling,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "synth_trifocal")
TOOLS = ("f64_reconcile_torch", "reconcile_stats_torch",
         "accuracy_sweep_torch", "roofline_torch")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_real_counts_and_quantiles_on_hand_made_paths():
    x = np.array([[1 + 0j, 2 + 5e-6j],        # real at every tolerance
                  [1 + 2e-4j, 0j],            # real from 3e-4 on
                  [1 + 1e-2j, 0j],            # real at 1e-2 only
                  [0j, 5j],                   # never real
                  [0j, 0j]])                  # real, but not converged
    conv = np.array([True, True, True, True, False])
    got = tooling.real_counts(x, conv)
    assert got == {1e-5: 1, 3e-5: 1, 1e-4: 1, 3e-4: 2, 1e-3: 2, 3e-3: 2,
                   1e-2: 3}
    assert tooling.real_counts(x, conv, (1e-4,)) == {1e-4: 1}
    q = tooling.quantiles([4.0, 1.0, np.nan, 3.0, 2.0, np.inf], (0, 50, 100))
    assert q == {0: 1.0, 50: 2.5, 100: 4.0}
    assert tooling.quantiles([np.nan]) == {}


def test_f64_compare_on_hand_made_runs():
    f64 = _tool("f64_reconcile_torch")
    lo = (np.array([[1 + 0j], [2 + 1e-3j], [3 + 0j], [4 + 0j]]),
          np.array([True, True, True, False]),
          np.array([False, False, False, True]))
    hi = (np.array([[1 + 0j], [2 + 0j], [3.5 + 1e-2j], [4 + 0j]]),
          np.array([True, True, True, True]),
          np.array([False, False, False, False]))
    got = f64.compare(lo, hi)
    assert got["both_converged"] == 3
    assert got["converged_flips"] == 1 and got["inf_flips"] == 1
    assert (got["real_lo_only"], got["real_hi_only"], got["real_both"]) == \
        (1, 1, 1)
    assert got["endpoint_distance"][50] == pytest.approx(1e-3)
    assert got["endpoint_distance"][99] == pytest.approx(
        np.percentile([0.0, 1e-3, abs(0.5 + 1e-2j)], 99))


def test_dist_of_hand_made_timings():
    dist = _tool("accuracy_sweep_torch")._dist
    assert dist([]) == {}
    assert dist([30.0, 10.0, 20.0]) == {"n": 3, "min": 10.0, "median": 20.0,
                                        "mean": 20.0, "p90": 30.0,
                                        "max": 30.0}
    d = dist([float(v) for v in range(1, 11)])
    assert (d["median"], d["p90"], d["max"]) == (6.0, 10.0, 10.0)


@pytest.fixture(scope="module")
def constants():
    cfg = config.config_for_data_root(DATA)
    problem = trifocal.TrifocalProblem.load(cfg)
    return {s: fused.FusedConstants.build(problem, solver=s)
            for s in ("reduced", "schedule")}


@pytest.mark.parametrize("solver", ["reduced", "schedule"])
@pytest.mark.parametrize("iters", [2.0, 3.0, 1.5, 0.0])
def test_roofline_rows_add_up_to_tracker_flops(constants, solver, iters):
    roof = _tool("roofline_torch")
    c = constants[solver]
    rows, work = roof.step_work(c, iters)
    assert work == {"solves": 4 + iters, "steps": 1, "newton": iters}
    assert sum(f for _, f in rows) == pytest.approx(
        bound.tracker_flops(c, work))
    by_name = dict(rows)
    assert by_name["elimination"] == (4 + iters) * bound.forward_flops(c)
    assert by_name["back-substitution"] == (4 + iters) * bound.backsub_flops(c)


def test_roofline_reproduces_the_step_share(constants):
    """The step PERF.md section 6 records (3,743.076 us over 30,700 paths
    on an H100) is about 1.6 % of its bound, which operations set."""
    roof = _tool("roofline_torch")
    c = constants["reduced"]
    rows, work = roof.step_work(c)
    flops = bound.tracker_flops(c, work)
    nbytes = roof.path_step_bytes(c)
    assert nbytes == 4 * 30 * 8 + 2 * 8 * 4 + 3 * 34 * 8
    r = roof.roofline(flops, nbytes, 3743.076, 30700)
    assert r["bound_by"] == "operations"
    assert r["bound_us"] == pytest.approx(flops * 30700 / 67e12 * 1e6)
    assert 0.015 < r["bound_share"] < 0.017
    assert r["flops_share"] == pytest.approx(r["bound_share"])
    assert r["bytes_share"] < r["flops_share"]


def test_roofline_prints_its_table_on_the_cpu(capsys):
    assert _tool("roofline_torch").main(
        ["--platform", "cpu", "--step-us", "3743.076", "--paths",
         "30700"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("device: cpu")
    fig = json.loads(out[-1])["roofline"]
    assert fig["bound_by"] == "operations" and fig["paths"] == 30700
    assert "latency-bound" in "\n".join(out)


@pytest.mark.parametrize("name", TOOLS)
def test_tool_without_a_card_exits_2(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _tool(name).main([]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""


def test_float64_oracle_agrees_with_float32_on_stable_paths():
    """The oracle at float64 against itself at float32: 16 roots of one
    hypothesis (view 0, the reference's sampling), TrunPaths off, 24
    steps.  Paths whose float32 flags four 1e-7 nudges of the start and
    the target leave alone must have the same flags and step counts at
    float64; x within 1e-3 relative where the nudges move it by less
    than 1e-4."""
    cfg = config.config_for_data_root(DATA)
    hc = dataclasses.replace(cfg.hc, truncate_paths=False, max_steps=23)
    problem = trifocal.TrifocalProblem.load(cfg)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    s = ransac.sample_edgel_triplets_reference(
        0, view.edge_locations.shape[0], 1)
    tgt = ransac.build_target_params(view.edge_locations,
                                     view.edge_tangents, s)
    x0 = np.asarray(problem.start_sols)[:16]
    tgt = np.repeat(tgt, 16, axis=0)
    f32 = tracker.make_track_fn(problem, hc)
    f64 = tracker.make_track_fn(problem, hc, dtype=torch.float64)

    def flags(r):
        return np.stack([r.converged.numpy(), r.inf_fail.numpy(),
                         r.pruned.numpy(), r.num_steps.numpy()], axis=1)

    ref = f32(torch.as_tensor(x0), torch.as_tensor(tgt))
    stable = np.ones(16, bool)
    calm = np.isfinite(ref.x.numpy()).all(axis=1)
    scale = np.maximum(np.abs(ref.x.numpy()).max(axis=1), 1.0)
    for seed in range(4):
        rng = np.random.default_rng(seed)

        def nudge(a):
            return (a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
                a.dtype)

        m = f32(torch.as_tensor(nudge(x0)), torch.as_tensor(nudge(tgt)))
        stable &= (flags(m) == flags(ref)).all(axis=1)
        calm &= np.abs(m.x.numpy() - ref.x.numpy()).max(axis=1) / scale < 1e-4
    hi = f64(torch.as_tensor(x0), torch.as_tensor(tgt))
    assert hi.x.dtype == torch.complex128
    assert int(hi.num_steps.max()) == hc.max_steps + 1
    assert stable.sum() >= 12 and (calm & stable).sum() >= 8
    np.testing.assert_array_equal(flags(hi)[stable], flags(ref)[stable])
    err = np.abs(hi.x.numpy() - ref.x.numpy()).max(axis=1) / scale
    assert err[calm & stable].max() < 1e-3
