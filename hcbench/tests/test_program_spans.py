"""The readers of the program's spans and counters (``program_spans`` and
the four metrics on it) on a hand-built run: two requests whose spans and
counters, laid in the program's log of its last rounds, are chosen so
that each metric's value can be worked out by hand; and the idle time by
innermost span of device intervals laid over them (idle time inside a
segment span counts for it, not for ``round.track`` or ``round``)."""

import collections
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import program_spans, run, trace  # noqa: E402
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (  # noqa: E402
    spans,
)

BASE = 1_790_000_000 * 10**9   # CLOCK_REALTIME ns, as the program stamps


def _spans(rows):
    """(name, start ms, end ms, parent) -> the program's ns spans."""
    return [(n, BASE + int(a * 1e6), BASE + int(b * 1e6), p)
            for n, a, b, p in rows]


# Traced: idle by innermost span (ms): sample 5, stage 5, launch 7,
# boundary 10 (its [20, 30]; [30, 35] busy), wait 0, unpack 8, round.track
# itself 10 ([70, 80]), readback 5, supports 5, round.score itself 0,
# round itself 3 ([97, 100]); 58 in all.
TRACED = _spans([
    ("round", 0, 100, -1),
    ("round.sample", 0, 5, 0),
    ("round.stage", 5, 10, 0),
    ("round.track", 10, 80, 0),
    ("segment.launch", 10, 20, 3),
    ("segment.boundary", 20, 35, 3),
    ("segment.wait", 35, 60, 3),
    ("round.unpack", 60, 70, 3),
    ("round.score", 80, 95, 0),
    ("score.readback", 80, 85, 8),
    ("score.supports", 85, 90, 8),
])
BUSY = [[15, 18], [30, 62], [90, 97]]
# After the profiler: host 4 + 6 + 1 + 2 = 13 ms, waits 30 + 5 = 35 ms,
# the score's wait 2 ms.
AFTER = _spans([
    ("round", 200, 260, -1),
    ("round.track", 200, 250, 0),
    ("segment.launch", 200, 204, 1),
    ("segment.boundary", 204, 210, 1),
    ("segment.wait", 210, 240, 1),
    ("segment.launch", 240, 241, 1),
    ("segment.boundary", 241, 243, 1),
    ("segment.wait", 243, 248, 1),
    ("round.unpack", 248, 250, 1),
    ("round.score", 250, 258, 0),
    ("score.readback", 250, 252, 9),
])


# A round before the window (the warm-up) and the one that raised, which
# keeps its place in the log with the spans it had opened.
WARMUP = _spans([("round", -50, -10, -1), ("round.track", -45, -20, 0)])
RAISED = _spans([("round", 300, 301, -1)])
COUNTS = [{"scored_paths": 100, "score_slots": 384},
          {"scored_paths": 28, "score_slots": 128}, {}]


def _record(traced_requests=1):
    """The run: the traced request, the one after the profiler, and one
    that raised; track_ms is each round's ``round.track`` span."""
    reqs = [run.Request(0, 0, 1, 100.0, track_ms=70.0),
            run.Request(1, 1, 2, 60.0, track_ms=50.0),
            run.Request(2, 0, 3, 1.0, error="raised")]
    tr = trace.Trace(requests=traced_requests, window_s=0.3, busy_s=0.042,
                     device_s={}, device_ops=[], idle_gaps=[])
    return run.RunRecord(setup_s=1.0, window_s=0.3, requests=reqs, failed=1,
                         launches=3, trace=tr)


@pytest.fixture
def log(monkeypatch):
    """The program's log holding the warm-up and the run's three rounds."""
    kept = collections.deque(
        [(WARMUP, {}), (TRACED, COUNTS[0]), (AFTER, COUNTS[1]),
         (RAISED, COUNTS[2])], maxlen=spans.KEEP)
    monkeypatch.setattr(spans, "finished", kept)
    return kept


def _read(name, rec):
    return run.load_module(os.path.join(ROOT, "hcbench", "metrics",
                                        f"{name}.py")).read(rec)


# (metric, value on the hand-built run, value when every request was traced)
EXPECTED = [
    ("boundary_host_ms", 13.0, (25.0 + 13.0) / 2),
    ("boundary_wait_ms", 35.0, (25.0 + 35.0) / 2),
    ("score_wait_ms", 2.0, (10.0 + 2.0) / 2),
    ("score_slot_use_pct", 25.0, 25.0),
]
NAMES = [e[0] for e in EXPECTED]


@pytest.mark.parametrize("name,want,_", EXPECTED, ids=NAMES)
def test_reader_values(log, name, want, _):
    assert _read(name, _record()) == pytest.approx(want, abs=1e-2)


@pytest.mark.parametrize("name,_,want", EXPECTED, ids=NAMES)
def test_whole_window_traced_reads_every_request(log, name, _, want):
    assert _read(name, _record(traced_requests=3)) == pytest.approx(
        want, abs=1e-2)


def _no_log(monkeypatch, log):
    monkeypatch.delattr(spans, "finished")


def _unpaired(monkeypatch, log):
    log.append((WARMUP, {}))      # a round after the window's last


def _empty(monkeypatch, log):
    log.clear()


@pytest.mark.parametrize("fault", [_no_log, _unpaired, _empty],
                         ids=["no_log", "unpaired", "empty"])
@pytest.mark.parametrize("name", NAMES)
def test_program_without_a_paired_log_reads_nothing(monkeypatch, log, name,
                                                    fault):
    fault(monkeypatch, log)
    assert _read(name, _record()) is None


def test_rounds_pair_the_log_tail_with_the_requests(log):
    rec = _record()
    assert program_spans.rounds(rec) == [(TRACED, COUNTS[0]),
                                         (AFTER, COUNTS[1]),
                                         (RAISED, COUNTS[2])]
    while len(log) > 2:           # a log that holds the last two alone
        log.popleft()
    assert program_spans.rounds(rec) == [None, (AFTER, COUNTS[1]),
                                         (RAISED, COUNTS[2])]
    assert _read("score_slot_use_pct", rec) == pytest.approx(100 * 28 / 128)


def test_self_idle_gives_each_instant_to_the_innermost_span():
    """TRACED's idle time by innermost span, in its order; the 3 ms left to
    ``round`` itself are the idle time no child span covers."""
    busy = [[(BASE + a * 1e6) * 1e-9, (BASE + b * 1e6) * 1e-9]
            for a, b in BUSY]
    own = program_spans.self_idle(TRACED, program_spans.Busy(busy))
    assert [o * 1e3 for o in own] == pytest.approx(
        [3, 5, 5, 10, 7, 10, 0, 8, 0, 5, 5], abs=1e-2)


def test_busy_within_clips_at_both_ends():
    busy = program_spans.Busy([[1.0, 2.0], [3.0, 5.0], [6.0, 7.0]])
    assert busy.within(0.0, 8.0) == pytest.approx(4.0)
    assert busy.within(1.5, 4.0) == pytest.approx(1.5)
    assert busy.within(3.5, 4.5) == pytest.approx(1.0)
    assert busy.within(2.0, 3.0) == 0.0
    assert busy.within(7.5, 9.0) == 0.0
    assert program_spans.Busy([]).within(0.0, 1.0) == 0.0
