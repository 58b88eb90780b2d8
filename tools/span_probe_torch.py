#!/usr/bin/env python3
"""The program's span recorder (``utils/spans``) on the card: its clock,
its cost, and one benchmark run broken down by span.

    python3 tools/span_probe_torch.py clock
    python3 tools/span_probe_torch.py cell <workload> <seed> <seconds> <trace>

``clock`` prints the card's name and power limit, then where a program span
falls against the Kineto stamps of a ``record_function`` range around it
and against the device events it queued (microseconds; the range must hold
the span, and the span the events), and the recorder's cost: ns per span
pair (open and close), per counter bump and per span with no request in
flight, three trials of 200,000 each.

``cell`` runs one benchmark run of ``hcbench/run.py``'s cell and prints,
besides the run's result line, from the program's log of its last rounds
(``hcbench/program_spans``) and the trace's merged device intervals: the
mean span count per request, the mean duration per request of every span
name over the requests after the profiler stopped (all of them in an
untraced run), the mean ``track_ms`` of those and of the traced requests,
and, with ``trace`` 1, the share of the device's idle time inside the
traced requests' ``round`` spans that no child span covers.  Without a card it runs a tiny configuration on the
CPU, as a dry run.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (  # noqa: E402
    spans,
)


def card() -> None:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("card:", out, "| torch", torch.__version__, torch.version.cuda,
          sys.version.split()[0], flush=True)


def clock() -> None:
    from torch.profiler import ProfilerActivity, profile, record_function
    a = torch.randn(2048, 2048, device="cuda")
    (a @ a).sum().item()
    rec = spans.Recorder()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        with record_function("probe.range"):
            with spans.recording(rec), spans.span("prog"):
                for _ in range(5):
                    a @ a
                torch.cuda.synchronize()
        t1 = time.time_ns()
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    probe = [e for e in events if e.name() == "probe.range"
             and e.device_type() != cuda][0]
    dev = [e for e in events if e.device_type() == cuda
           and not e.name().startswith("probe")]
    _, s, e, _ = rec.spans_out()[0]
    print("clock:", json.dumps(dict(
        range_start_after_time_ns_us=(probe.start_ns() - t0) / 1e3,
        time_ns_after_range_end_us=(t1 - probe.end_ns()) / 1e3,
        span_start_after_range_start_us=(s - probe.start_ns()) / 1e3,
        range_end_after_span_end_us=(probe.end_ns() - e) / 1e3,
        first_device_after_span_start_us=(
            min(d.start_ns() for d in dev) - s) / 1e3,
        span_end_after_last_device_us=(e - max(d.end_ns() for d in dev)) / 1e3,
        span_names_among_events=sorted({x.name() for x in events} & {"prog"}),
        device_events=len(dev))), flush=True)


def cost(n: int = 200_000) -> None:
    out = {"span_pair_ns": [], "count_ns": [], "null_span_ns": []}

    def loop(body) -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            body()
        return (time.perf_counter_ns() - t) / n

    def pair():
        with spans.span("segment.launch"):
            pass

    for _ in range(3):
        empty = loop(lambda: None)
        with spans.recording(spans.Recorder()):
            out["span_pair_ns"].append(loop(pair) - empty)
            out["count_ns"].append(
                loop(lambda: spans.count("scored_paths")) - empty)
        out["null_span_ns"].append(loop(pair) - empty)
    print("cost:", json.dumps(out), flush=True)


def cell(name: str, seed: int, seconds: float, trace: bool) -> None:
    from hcbench import program_spans
    from hcbench import run as hrun
    from hcbench import trace as htrace

    records, merged = [], []

    class Kept(hrun.RunRecord):   # the run's record, for the breakdown
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            records.append(self)

    def keep_merged(intervals):   # the trace's merged device intervals
        merged.append(merge(intervals))
        return merged[-1]

    merge = htrace._merged
    hrun.RunRecord, htrace._merged = Kept, keep_merged
    c = hrun.load_cell(name)
    device = "cuda:0"
    if not torch.cuda.is_available():
        torch.set_num_threads(2)
        device = "cpu"
        c["config"]["engine"]["ransac"].update(num_iterations=2,
                                               abort_chunk=1)
        c["config"]["engine"]["hc"].update(max_steps=8)
        c["traffic"].update(pool_views=2, edgels_per_view=400)
    result, _ = hrun.run_cell(c, seed, seconds, trace, device=device)
    rec = records[0]
    kept = program_spans.rounds(rec)
    n = rec.trace.requests if trace else 0
    after = program_spans.untraced(rec)
    traced = [k for k in kept[:n] if k is not None]
    names = sorted({s[0] for sp, _ in after for s in sp})

    def track_ms(ks):
        return float(np.mean([(e - s) * 1e-6 for sp, _ in ks
                              for nm, s, e, _ in sp if nm == "round.track"]))

    out = dict(
        requests=len(rec.requests), traced=len(traced), after=len(after),
        spans_per_request=float(np.mean([len(sp) for sp, _ in after])),
        track_ms_after=track_ms(after),
        track_ms_traced=track_ms(traced) if traced else None,
        latency_ms_median=float(np.median(
            [r.latency_ms for r in rec.requests])),
        span_ms_after={k: program_spans.ms_per_view(after, (k,))
                       for k in names})
    if traced:
        busy = program_spans.Busy(merged[-1])
        own = total = 0.0
        for sp, _ in traced:
            mine = program_spans.self_idle(sp, busy)
            for i, (nm, s, e, _) in enumerate(sp):
                if nm == "round":
                    own += mine[i]
                    total += (e - s) * 1e-9 - busy.within(s * 1e-9, e * 1e-9)
        out["round_idle_uncovered_pct"] = (100.0 * own / total if total
                                           else None)
    print("spans:", json.dumps(out), flush=True)
    print(json.dumps(result), flush=True)


def main(argv) -> int:
    if argv[:1] == ["clock"]:
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 1
        card()
        clock()
        cost()
        return 0
    if argv[:1] == ["cell"] and len(argv) == 5:
        cell(argv[1], int(argv[2]), float(argv[3]), bool(int(argv[4])))
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
