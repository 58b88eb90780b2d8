"""The program's spans and counters (``utils/spans``) on the CPU.

Tiny rounds, made cheap as tests/test_torch_stream.py makes its rounds:
hypothesis 0 of every round targets the start parameters, so that its
unpruned paths converge within a few steps (init_delta_t 0.5), the
imaginary gate is relaxed so that their poses are candidates, and the step
budget is 8 in segments of 4 (three segments).  With the pass ratio at
0.9 the abort round (a chunk a hypothesis) misses in chunk 0 and runs
chunk 1 too.

* The span tree of a plain, a one-call, an abort and a sharded round:
  every span inside its parent, the children in order, one
  ``segment.launch``, ``segment.boundary`` and ``segment.wait`` per
  segment, a ``round.chunk`` per chunk run; ``track_ms`` is ``round.track``
  and ``total_ms`` is ``round.track`` + ``round.score``, within 1 us.
* The counters: an abort round's ``scored_paths`` is a recount of the
  runs' scored converged paths and its ``score_slots`` 128 a boundary; a
  plain round records none; nothing is recorded with no request in
  flight.
* The log: every ``run_round``, one that raised too, appends its spans
  and counters to ``spans.finished``, which keeps the last ``KEEP``.
* The clock: a round inside a ``record_function`` range of
  ``torch.profiler`` has every span inside that range's Kineto stamps, and
  no span reaches the profiler's events.
"""

import dataclasses
import os

import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    ransac,
    segmented,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    spans,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_H = 2
_US = 1e-3  # one microsecond, in ms


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads (see tests/test_torch_engine.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(monkeypatch, **ransac_kw):
    cfg = config.EngineConfig(data_root=DATA)
    start = trifocal.TrifocalProblem.load(cfg).start_params
    build = ransac.build_target_params

    def build_target_params(*args):
        tgt = build(*args)
        tgt[0] = start
        return tgt

    monkeypatch.setattr(ransac, "build_target_params", build_target_params)
    return dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, init_delta_t=0.5, max_steps=8,
                                    segment_steps=4),
        ransac=dataclasses.replace(cfg.ransac, imag_part_tol=1e9,
                                   **ransac_kw))


def _runs(monkeypatch):
    """The segmented runs made from now on (a shard's too)."""
    made = []
    init = segmented._Run.__init__

    def spy_init(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(segmented._Run, "__init__", spy_init)
    return made


def _children(sp, i):
    return [j for j, s in enumerate(sp) if s[3] == i]


def _names(sp, idx):
    return [sp[j][0] for j in idx]


def _check_tree(rr, runs: list, abort: bool, shards: int = 1):
    """The nesting and the times of a round's spans, against the round's
    segmented runs.  Over several shards the runs' segment spans
    interleave: each shard's launch and boundary, then each one's wait."""
    sp = rr.spans
    assert sp[0][0] == "round" and sp[0][3] == -1
    for j, (name, s, e, parent) in enumerate(sp):
        assert s <= e, name
        if j:
            assert 0 <= parent < j, name
            assert sp[parent][1] <= s and e <= sp[parent][2], name
    top = _children(sp, 0)
    assert _names(sp, top) == ["round.sample", "round.stage", "round.track",
                               "round.score"]
    for a, b in zip(top, top[1:]):  # in order, apart
        assert sp[a][2] <= sp[b][1]
    track, score = top[2], top[3]
    under = _names(sp, _children(sp, track))
    segs = [n for n in (
        _names(sp, [j for c in _children(sp, track)
                    for j in _children(sp, c)]) if abort else under)
        if n.startswith("segment.")]
    n_seg = sum(r.si for r in runs)
    assert n_seg >= 1
    one = ["segment.launch", "segment.boundary", "segment.wait"]
    if shards == 1:
        assert segs == one * n_seg
    else:
        assert n_seg % shards == 0 and segs[:2 * shards] == (
            one[:2] * shards)
        assert sorted(segs) == sorted(one * n_seg)
    if abort:
        assert under == ["round.chunk"] * rr.chunks_run
    else:
        assert under[-1] == "round.unpack" and "round.chunk" not in under
        assert rr.counts == {}
    score_kids = _names(sp, _children(sp, score))
    assert score_kids[0] == "score.readback"
    assert score_kids[1:] == (["score.supports"] if rr.num_candidates
                              else [])
    ms = [(sp[i][2] - sp[i][1]) * 1e-6 for i in (track, score)]
    assert abs(rr.track_ms - ms[0]) <= _US
    assert abs(rr.total_ms - (ms[0] + ms[1])) <= _US


@pytest.mark.parametrize("abort", [False, True], ids=["plain", "abort"])
def test_round_spans_and_counters(monkeypatch, abort):
    cfg = _cfg(monkeypatch, abort_by_good_sol=abort, abort_chunk=1)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    runs = _runs(monkeypatch)
    rr = port.run_round(port.load_view(0), 0, _H)
    _check_tree(rr, runs, abort)
    if not abort:
        assert len(runs) == 1
        return
    assert rr.chunks_run == len(runs) == 2 and not rr.found_pose
    scored = 0
    for r in runs:
        conv = fused.flags_outputs(cfg.hc, r.fl)[0]
        assert bool(conv[r.scored].all())   # a scored path converged
        scored += int(r.scored.sum())
    assert rr.counts["scored_paths"] == scored > 0
    assert rr.counts["score_slots"] == segmented._SCORE_SLOTS * sum(
        r.si for r in runs)


@pytest.mark.parametrize("case", ["one_call", "sharded", "sharded_abort"])
def test_other_rounds_have_spans(monkeypatch, case):
    """The one-call tracker (no segment spans: round.track holds
    round.unpack alone) and two CPU shards, whose runs each record their
    segment spans."""
    abort = case == "sharded_abort"
    cfg = _cfg(monkeypatch, abort_by_good_sol=abort, abort_chunk=1)
    if case == "one_call":
        cfg = dataclasses.replace(cfg, hc=dataclasses.replace(
            cfg.hc, compact_survivors=False))
        port = engine.TrifocalPoseEngine(cfg, device="cpu")
    else:
        port = engine.TrifocalPoseEngine(
            dataclasses.replace(cfg, num_devices=2), device=["cpu", "cpu"])
    runs = _runs(monkeypatch)
    rr = port.run_round(port.load_view(0), 0, _H)
    if case == "one_call":
        track = [s[0] for s in rr.spans].index("round.track")
        assert _names(rr.spans, _children(rr.spans, track)) == [
            "round.unpack"]
        assert rr.counts == {}
        return
    assert len(runs) == 2 * rr.chunks_run
    _check_tree(rr, runs, abort, shards=2)


def test_nothing_recorded_without_a_request(monkeypatch):
    cfg = _cfg(monkeypatch, abort_by_good_sol=True)
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = port.load_view(0)
    assert spans.span("a") is spans.span("b")   # one shared null context
    spans.count("segments", 5)
    rec = spans.Recorder()
    T = port.problem.num_tracks
    tgt = ransac.build_target_params(
        view.edge_locations, view.edge_tangents,
        ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1))
    res = port.track(port._start, torch.as_tensor(tgt).repeat_interleave(
        T, dim=0), torch.as_tensor(view.edge_locations), port._k)
    assert res.track.num_steps.shape == (T,)
    assert rec.spans == [] and rec.counts == {}
    with spans.recording(rec):
        with spans.span("outer") as i:
            spans.count("segments", 2)
            with spans.span("inner"):
                pass
    assert [s[0] for s in rec.spans] == ["outer", "inner"]
    assert rec.spans[1][3] == i == 0 and rec.counts == {"segments": 2}
    assert spans.span("after") is spans.span("b")


def test_spans_on_the_profilers_clock(monkeypatch):
    """Kineto's stamps of a record_function range around the round hold
    every program span; no program span is a profiler event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cfg = _cfg(monkeypatch)
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc,
                                                          max_steps=2))
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = port.load_view(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("probe.range"):
            rr = port.run_round(view, 0, 1)
    events = prof.profiler.kineto_results.events()
    probe = [e for e in events if e.name() == "probe.range"]
    assert len(probe) == 1
    lo, hi = probe[0].start_ns(), probe[0].end_ns()
    assert rr.spans
    for name, s, e, _ in rr.spans:
        assert lo <= s <= e <= hi, (name, s - lo, hi - e)
    names = {e.name() for e in events}
    assert not names & {s[0] for s in rr.spans}


def test_rounds_kept_in_the_log(monkeypatch):
    """Each round's (spans, counters) are the log's newest entry, the
    RoundResult's own lists; a round that raised keeps its place with the
    spans it had opened, all closed; the log holds the last KEEP."""
    cfg = _cfg(monkeypatch)
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc,
                                                          max_steps=2))
    port = engine.TrifocalPoseEngine(cfg, device="cpu")
    view = port.load_view(0)
    assert spans.finished.maxlen == spans.KEEP
    monkeypatch.setattr(spans, "finished",
                        type(spans.finished)(maxlen=spans.KEEP))
    rr = port.run_round(view, 0, 1)
    assert len(spans.finished) == 1
    assert spans.finished[-1][0] is rr.spans
    assert spans.finished[-1][1] is rr.counts

    def broken(*a, **kw):
        raise RuntimeError("tracker down")

    monkeypatch.setattr(port, "track", broken)
    with pytest.raises(RuntimeError, match="tracker down"):
        port.run_round(view, 1, 1)
    assert len(spans.finished) == 2
    sp, counts = spans.finished[-1]
    assert [s[0] for s in sp] == ["round", "round.sample", "round.stage",
                                  "round.track"]
    assert all(e >= s > 0 for _, s, e, _ in sp) and counts == {}
    for i in range(spans.KEEP):
        spans.keep(spans.Recorder())
    assert len(spans.finished) == spans.KEEP
    assert all(k == ([], {}) for k in spans.finished)
