"""``trace.read`` and the trace's readers on hand-built profiler events.

One card: the events of a traced window on card 0 (and one on a card the
cell does not have) read exactly the numbers that the harness read before
it grouped events by card (commit 8f037d6a5339), frozen below.  Several
cards: each card's intervals are merged on their own, ``busy_s`` is the
mean card's, a card with no event counts as idle, the idle gaps are summed
over the cards by host activity, and the kernels' time is the mean
card's."""

import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run, trace  # noqa: E402

MS = 1_000_000  # ns
KERNEL = "_anonymous_namespace_::hc_track_kernel_float2___float2___float__"
LONG = "void_at::native::elementwise_kernel_128__2__at::native::gpu_kernel_" \
       "impl_nocast_at::native::direct_copy_kernel_cuda"


class Event:
    """What ``read`` asks of one of Kineto's events; ``card`` None is the
    host's."""

    def __init__(self, name, start_ms, end_ms, card=None):
        self._name, self._card = name, card
        self._s, self._e = round(start_ms * MS), round(end_ms * MS)

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._card is None
                else torch.autograd.DeviceType.CUDA)

    def device_index(self):
        return -1 if self._card is None else self._card


def session(events, requests):
    """A stopped ``trace.Session`` whose profile holds ``events``."""
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(requests=requests, prof=types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results)))


# A traced window of 200 ms with two requests on card 0: overlapping
# kernels, a kernel across a request's end, kernels between requests and
# outside the window, the device's mirror of a request's range, and a
# kernel on card 3, which a one-card run keeps.
ONE_CARD = [
    Event("hcbench.window", 0.0, 200.0),
    Event("hcbench.request.0", 1.0, 90.0),
    Event("hcbench.request.1", 95.0, 180.0),
    Event("hcbench.request.0", 2.0, 89.0, card=0),
    Event("aten::mul", 3.0, 20.0),
    Event("aten::mul", 5.0, 8.0),
    Event("cudaLaunchKernel", 20.5, 22.25),
    Event("aten::add", 40.0, 88.0),
    Event("cudaStreamSynchronize", 100.0, 175.0),
    Event(KERNEL, 10.0, 30.125, card=0),
    Event(KERNEL, 25.0, 45.0, card=0),
    Event(LONG, 46.0, 47.0625, card=0),
    Event(LONG, 85.0, 92.0, card=0),
    Event("Memset (Device)", 93.0, 93.5, card=0),
    Event(KERNEL, 100.0, 150.0, card=0),
    Event("Memcpy DtoH (Device -> Pinned)", 150.0, 151.0, card=0),
    Event("hc_score_kernel", 152.0, 152.017, card=0),
    Event(KERNEL, 160.0, 170.0, card=3),
    Event(KERNEL, -5.0, 1.0, card=0),
    Event(KERNEL, 199.0, 205.0, card=0),
]

# What the harness at commit 8f037d6a5339 read from ONE_CARD (repr of
# each float), and its readers from ``record``'s run.
FROZEN_TRACE = dict(
    requests=2, window_s=0.2, busy_s=0.10457950000000005,
    device_s={0: {KERNEL: 0.04012500000000001, LONG: 0.001062499999999994},
              1: {KERNEL: 0.060000000000000026,
                  "Memcpy DtoH (Device -> Pinned)": 0.0010000000000000009,
                  "hc_score_kernel": 1.7000000000017e-05}},
    device_ops=[[KERNEL, 0.10012500000000003],
                [LONG[:96], 0.0080625],
                ["Memcpy DtoH (Device -> Pinned)", 0.0010000000000000009],
                ["Memset (Device)", 0.0005000000000000004],
                ["hc_score_kernel", 1.7000000000017e-05]],
    idle_gaps=[["aten::add", 0.03893750000000001],
               ["python", 0.03749999999999999], ["aten::mul", 0.01],
               ["cudaStreamSynchronize", 0.008982999999999963]])
FROZEN_METRICS = dict(device_idle_pct=47.710249999999974,
                      hc_track_ms=50.062500000000014,
                      boundary_gap_ms=25.187499999999982,
                      hc_track_roofline=8.722741433021806)


def record(tr, chips=1):
    """A run whose first two requests were traced; the reference checked
    request 0, whose tracking's bound is 3.5 ms."""
    reqs = [run.Request(0, 0, 1, 95.0, track_ms=80.0, total_ms=88.0),
            run.Request(1, 1, 2, 90.0, track_ms=70.5, total_ms=80.0),
            run.Request(2, 0, 3, 60.0, track_ms=50.0, total_ms=55.0)]
    return run.RunRecord(setup_s=1.0, window_s=0.3, requests=reqs, failed=0,
                         launches=6, trace=tr, checked=0, bound_ms=3.5,
                         chips=chips)


def readers(rec):
    return {name: run.load_module(os.path.join(
        ROOT, "hcbench", "metrics", f"{name}.py")).read(rec)
        for name in ("device_idle_pct", "hc_track_ms", "boundary_gap_ms",
                     "hc_track_roofline")}


def fields(tr):
    return dict(requests=tr.requests, window_s=tr.window_s,
                busy_s=tr.busy_s, device_s=tr.device_s,
                device_ops=tr.device_ops, idle_gaps=tr.idle_gaps)


@pytest.mark.parametrize("chips", [None, 1])
def test_one_card_reads_as_before(chips):
    s = session(ONE_CARD, 2)
    tr = trace.read(s) if chips is None else trace.read(s, chips)
    assert fields(tr) == FROZEN_TRACE
    assert readers(record(tr)) == FROZEN_METRICS
    # The card's merged intervals: the window's operations, card 3's too.
    assert len(tr.busy) == 1
    assert sum(e - s for s, e in tr.busy[0]) == pytest.approx(tr.busy_s)
    assert tr.busy[0][-1] == pytest.approx([0.160, 0.170])


# A traced window of 100 ms, one request, on two cards: card 0's kernels
# overlap each other (a union of 30 ms), card 1's overlap card 0's (20 ms
# of its own).
TWO_CARDS = [
    Event("hcbench.window", 0.0, 100.0),
    Event("hcbench.request.0", 0.5, 99.0),
    Event("aten::mul", 0.0, 45.0),
    Event("cudaLaunchKernel", 45.0, 100.0),
    Event(KERNEL, 10.0, 30.0, card=0),
    Event(KERNEL, 20.0, 40.0, card=0),
    Event("Memset (Device)", 25.0, 35.0, card=1),
    Event(KERNEL, 50.0, 60.0, card=1),
]


def test_two_cards_read_apart():
    tr = trace.read(session(TWO_CARDS, 1), 2)
    assert tr.busy == [[pytest.approx([0.010, 0.040])],
                       [pytest.approx([0.025, 0.035]),
                        pytest.approx([0.050, 0.060])]]
    assert tr.busy_s == pytest.approx((0.030 + 0.020) / 2)
    # Card 0 idles 10 ms under aten::mul and 60 under cudaLaunchKernel,
    # card 1 25 + 15 and 40.
    assert dict(tr.idle_gaps) == pytest.approx(
        {"cudaLaunchKernel": 0.100, "aten::mul": 0.050})
    assert dict(tr.device_ops) == pytest.approx(
        {KERNEL: 0.050, "Memset (Device)": 0.010})
    assert tr.device_s == {0: pytest.approx({KERNEL: 0.050,
                                             "Memset (Device)": 0.010})}
    got = readers(record(tr, chips=2))
    assert got == pytest.approx(dict(
        device_idle_pct=75.0, hc_track_ms=25.0, boundary_gap_ms=80.0 - 25.0,
        hc_track_roofline=100.0 * 3.5 / 50.0))


def test_a_card_without_operations_is_idle():
    """The same events in a cell of three cards: the third card idles the
    whole window, under cudaLaunchKernel at its midpoint."""
    tr = trace.read(session(TWO_CARDS, 1), 3)
    assert len(tr.busy) == 3 and tr.busy[2] == []
    assert tr.busy_s == pytest.approx((0.030 + 0.020 + 0.0) / 3)
    assert dict(tr.idle_gaps) == pytest.approx(
        {"cudaLaunchKernel": 0.200, "aten::mul": 0.050})
    got = readers(record(tr, chips=3))
    assert got["device_idle_pct"] == pytest.approx(100.0 * (1 - 0.05 / 0.3))
    assert got["hc_track_ms"] == pytest.approx(50.0 / 3)


def test_one_card_keeps_every_card_index():
    """Read as one card, the two cards' operations are one card's: their
    union, and no event is dropped for its card's index."""
    tr = trace.read(session(TWO_CARDS, 1))
    assert tr.busy == [[pytest.approx([0.010, 0.040]),
                        pytest.approx([0.050, 0.060])]]
    assert tr.busy_s == pytest.approx(0.040)
    assert readers(record(tr))["hc_track_ms"] == pytest.approx(50.0)
