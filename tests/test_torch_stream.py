"""Streamed recovery (``engine.run_stream``) on the CPU.

The stream runs the engine's tracker on the same inputs as ``run_round``,
so per view it must give that round's result: the four counts, the best
supports, the found flag and the best pose, with the segmented tracker
(the default), with the one-call tracker (``compact_survivors`` off) and
with the oracle (``backend="xla"``).  With ``abort_by_good_sol`` it
must give the abort round's per view: the chunks run, the found flag, the
best supports and the counts over the chunks run.

The rounds are made cheap as tests/test_torch_segmented.py makes its abort
round: sampling is patched so that chosen hypotheses target the start
parameters, whose unpruned paths converge within a few steps
(init_delta_t 0.5), and the imaginary gate is relaxed so that their poses
are candidates; the step budget is 8 (one segment).  The plain stream
keeps one real hypothesis beside the patched one.  The abort cases: a hit
in every view's first chunk (pass ratio 0), and a miss in every chunk
(every hypothesis patched, the pass ratio 0.9), which runs each view's
second chunk after its first was read as a miss.

Sharded over two CPU shards (``num_devices=2``, which the JAX package
never tested in its stream), the stream-abort pipeline gives each view the
sharded abort round's result, the hypotheses padded to whole shards and
the chunks rounded up to them.

The device selection's 39 floats equal the JAX engine's
``_build_device_select`` on the same seeded inputs, padding excluded.  In
the slow tier: the stream-abort pipeline against the JAX engine's, its
Pallas kernel in interpret mode.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu import engine as jengine
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    ransac as jransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import ransac
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_H = 2
_SUP_FRAC = 0.002   # the reference's support band (cli.py _CC_SUP_FRAC)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads (see tests/test_torch_engine.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _patched(monkeypatch, hyps, jax_too=False, **ransac_kw):
    """Make hypotheses ``hyps`` of every round target the start
    parameters; the configuration of the cheap rounds."""
    cfg = config.EngineConfig(data_root=DATA)
    start = trifocal.TrifocalProblem.load(cfg).start_params

    def patch(module):
        build = module.build_target_params

        def build_target_params(*args):
            tgt = build(*args)
            tgt[hyps] = start
            return tgt

        monkeypatch.setattr(module, "build_target_params", build_target_params)

    patch(ransac)
    if jax_too:
        patch(jransac)
    return dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, init_delta_t=0.5, max_steps=8),
        ransac=dataclasses.replace(cfg.ransac, imag_part_tol=1e9,
                                   **ransac_kw))


def _check_view_spans(results):
    """Each view's spans: ``view`` from its first dispatch to its selection
    read, holding its runs' segment spans, all in order; track_ms is
    ``view``'s duration.  The views are dispatched in order."""
    starts = []
    for r in results:
        vn, v0, v1, vp = r.spans[0]
        assert (vn, vp) == ("view", -1) and v0 <= v1
        assert [s[1] for s in r.spans] == sorted(s[1] for s in r.spans)
        for name, s, e, parent in r.spans[1:]:
            assert name.startswith("segment.") and parent == 0
            assert v0 <= s <= e <= v1
        assert abs(r.track_ms - (v1 - v0) * 1e-6) <= 1e-3
        starts.append(v0)
    assert starts == sorted(starts)


def _same_counts(r, rr):
    assert (dataclasses.astuple(r.stats) == dataclasses.astuple(rr.stats))
    assert r.num_candidates == rr.num_candidates
    assert (r.best_support21, r.best_support31) == (rr.best_support21,
                                                    rr.best_support31)
    assert r.found_pose == rr.found_pose
    assert r.num_edgels == rr.num_edgels


@pytest.mark.parametrize("knobs", [
    dict(compact_survivors=True), dict(compact_survivors=False),
    dict(backend="xla")], ids=["segmented", "one_call", "oracle"])
def test_stream_equals_round_per_view(monkeypatch, knobs):
    """The segmented tracker's interleaved runs, the one-call tracker's
    single launches and the oracle's single calls (``_OneCall``)."""
    cfg = _patched(monkeypatch, [0])
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc, **knobs))
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    views = [0, 1, 2]
    results, vps = port.run_stream(views, num_hypotheses=_H)
    assert len(results) == len(views) and vps > 0
    _check_view_spans(results)
    for vi, r in zip(views, results):
        rr = port.run_round(port.load_view(vi), 0, _H)
        _same_counts(r, rr)
        assert rr.num_candidates > 0
        for a, b in zip(r.best_pose, rr.best_pose):
            assert np.array_equal(a, b)
        assert (dataclasses.astuple(r.pose_errors)
                == dataclasses.astuple(rr.pose_errors))
        # The step counts stay on the card: the best path's only.
        assert r.num_steps.size == 0 and r.actual_sol_steps.size == 1
        assert 0 < r.actual_sol_steps[0] <= cfg.hc.max_steps + 1
        assert r.track_ms > 0 and r.total_ms >= r.track_ms


@pytest.mark.parametrize("case", ["hit", "miss"])
def test_stream_abort_equals_abort_round_per_view(monkeypatch, case):
    if case == "hit":
        hyps, views, kw = [0], [0, 1, 2], dict(pass_inlier_support_ratio=0.0)
    else:
        hyps, views, kw = [0, 1], [0, 1], {}
    cfg = _patched(monkeypatch, hyps, abort_by_good_sol=True, abort_chunk=1,
                   stream_abort_chunk=1, **kw)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    results, vps = port.run_stream(views, num_hypotheses=_H)
    assert len(results) == len(views) and vps > 0
    _check_view_spans(results)
    for vi, r in zip(views, results):
        rr = port.run_round(port.load_view(vi), 0, _H)
        assert r.chunks_run == rr.chunks_run == (1 if case == "hit" else 2)
        _same_counts(r, rr)
        assert r.found_pose == (case == "hit")
        assert r.stats.num_paths == _H * port.problem.num_tracks


@pytest.mark.parametrize("case", ["hit", "miss"])
def test_sharded_stream_abort_equals_abort_round_per_view(monkeypatch, case):
    """Two CPU shards, H = 3: each view samples 4 hypotheses (the padding
    to whole shards), both chunk sizes 1 round up to 2 hypotheses, and the
    stream gives each view the sharded abort round's chunks, counts and
    supports, padding excluded.  The miss case also patches the padded
    hypothesis, whose paths run in the last chunk and are not counted."""
    H = 3
    if case == "hit":
        hyps, kw = [0], dict(pass_inlier_support_ratio=0.0)
    else:
        hyps, kw = [0, 1, 2, 3], {}
    cfg = _patched(monkeypatch, hyps, abort_by_good_sol=True, abort_chunk=1,
                   stream_abort_chunk=1, **kw)
    port = engine.TrifocalPoseEngine(dataclasses.replace(cfg, num_devices=2),
                                     device=["cpu", "cpu"])
    assert port._abort and port.track.backend == "segmented"
    views = [0, 1]
    results, vps = port.run_stream(views, num_hypotheses=H)
    assert len(results) == len(views) and vps > 0
    for vi, r in zip(views, results):
        rr = port.run_round(port.load_view(vi), 0, H)
        assert r.chunks_run == rr.chunks_run == (1 if case == "hit" else 2)
        _same_counts(r, rr)
        assert r.found_pose == (case == "hit")
        assert r.stats.num_paths == H * port.problem.num_tracks


@pytest.mark.parametrize("abort", [False, True])
def test_stream_of_no_view(abort):
    cfg = config.EngineConfig(data_root=DATA)
    cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=abort))
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    assert port.run_stream([]) == ([], 0.0)


def test_device_select_matches_jax():
    """Seeded per-path inputs over 600 paths, 550 of them real: the padding
    holds the largest supports and steps, so counting it would change
    every entry.  Max-support ties on both pairs."""
    rng = np.random.default_rng(21)
    B, n = 600, 550
    xr = rng.standard_normal((B, 30)).astype(np.float32)
    conv = rng.random(B) < 0.5
    inf = ~conv & (rng.random(B) < 0.3)
    real = conv & (rng.random(B) < 0.5)
    cand = conv & (rng.random(B) < 0.6)
    n21 = np.where(cand, rng.integers(0, 40, B), -1).astype(np.int32)
    n31 = np.where(cand, rng.integers(0, 40, B), -1).astype(np.int32)
    steps = rng.integers(1, 82, B).astype(np.int32)
    n21[n:], n31[n:], steps[n:], cand[n:], conv[n:] = 99, 99, 99, True, True
    args = (xr, conv, inf, real, cand, n21, n31, steps)
    want = np.asarray(jengine.TrifocalPoseEngine._build_device_select(
        None, n)(*(jnp.asarray(a) for a in args)))
    got = engine.TrifocalPoseEngine._device_select(
        *(torch.as_tensor(a) for a in args), n).numpy()
    assert got.shape == want.shape == (39,) and got.dtype == np.float32
    assert np.array_equal(got, want)
    assert got[7] > 2  # ties counted


@pytest.mark.slow
def test_stream_abort_matches_jax_engine(monkeypatch):
    """The hit case through the JAX engine's stream-abort pipeline, its
    segmented Pallas kernel in interpret mode: per view the same found
    flag and the best supports within the reference's band."""
    cfg = _patched(monkeypatch, [0], jax_too=True, abort_by_good_sol=True,
                   abort_chunk=1, stream_abort_chunk=1,
                   pass_inlier_support_ratio=0.0)
    views = [0, 1]
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    results, _ = port.run_stream(views, num_hypotheses=_H)
    monkeypatch.setenv("TPUHC_FORCE_INTERPRET", "1")
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    jresults, _ = jengine.TrifocalPoseEngine(jcfg).run_stream(
        views, num_hypotheses=_H)
    for r, rj in zip(results, jresults):
        assert r.found_pose == rj.found_pose
        tol = max(5, int(_SUP_FRAC * r.num_edgels))
        assert abs(r.best_support21 - rj.best_support21) <= tol
        assert abs(r.best_support31 - rj.best_support31) <= tol
