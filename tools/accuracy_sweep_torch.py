#!/usr/bin/env python3
"""Accuracy over every view of a data root: TrunRANSAC abort rounds with
seed retries, an exhaustive sweep over the misses, and the wall-to-pose
distributions.

    python3 tools/accuracy_sweep_torch.py [--views N] [--hypotheses 100]
        [--retries 4] [--exhaustive 2000] [--platform gpu|cpu]
        [--data-root DIR]

The port of tools/accuracy_sweep.py.  For each view an abort round
(``abort_by_good_sol``) runs with seed 0, 1, ... until it finds a pose
(both supports at least 90 % of the edgels) or ``--retries`` retries are
spent.  A view still missed gets an exhaustive sweep of ``--exhaustive``
hypotheses (rounds of ``--hypotheses`` with seeds from 1000), which tells
a tracker failure from a view on which no sampled triplet meets the
acceptance rule.  It prints a line per view, the recovered count (and how
many within the ground-truth tolerances), the attempt histogram, the
distributions of each recovered view's first-round and cumulative
total_ms (wall to pose), and last one JSON line.  ``--views`` defaults to
the views in the data root (3 in data/synth_trifocal).  Runs on cuda:0
unless given --platform cpu, and exits 2 without a card.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dist(ms):
    """min / median / mean / p90 / max of a list of millisecond timings,
    with their count; {} for none."""
    if not ms:
        return {}
    s = sorted(ms)
    n = len(s)
    return {"n": n, "min": s[0], "median": s[n // 2], "mean": sum(s) / n,
            "p90": s[min(n - 1, int(0.9 * n))], "max": s[-1]}


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        tooling,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=None,
                    help="views 0..N-1 (default: all of the data root's)")
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--retries", type=int, default=4)
    ap.add_argument("--exhaustive", type=int, default=2000)
    tooling.add_arguments(ap)
    args = ap.parse_args(argv)

    from trifocal_pose_estimation_using_improved_gpuhc_torch.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
        data_io,
    )

    dev = tooling.device(args.platform, "accuracy_sweep_torch")
    if dev is None:
        return 2
    print(tooling.card_line(dev), flush=True)
    cfg = config.config_for_data_root(args.data_root)
    cfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True))
    n_views = (args.views if args.views is not None else
               data_io.num_ransac_views(config.ransac_data_dir(cfg)))
    eng = TrifocalPoseEngine(cfg, device=dev)
    eng.warmup(num_hypotheses=args.hypotheses)

    t0 = time.perf_counter()
    found, within, misses = 0, 0, []
    attempts_hist = {}
    first_ms, cum_ms = [], []  # per recovered view: 1st round / to the pose
    for vi in range(n_views):
        view = eng.load_view(vi)
        view_ms = view_first_ms = 0.0
        for attempt in range(1 + args.retries):
            rr = eng.run_round(view, seed=attempt,
                               num_hypotheses=args.hypotheses)
            view_ms += rr.total_ms
            if attempt == 0:
                view_first_ms = rr.total_ms
            if rr.found_pose:
                break
        attempts_hist[attempt] = attempts_hist.get(attempt, 0) + 1
        if rr.found_pose:
            found += 1
            first_ms.append(view_first_ms)
            cum_ms.append(view_ms)
            if rr.pose_errors is not None and rr.pose_errors.within(
                    cfg.ransac):
                within += 1
        else:
            misses.append(vi)
        print(f"view {vi:03d}: attempts {attempt + 1}, "
              f"{'FOUND' if rr.found_pose else 'miss'} support "
              f"{rr.best_support21}/{rr.best_support31} of {rr.num_edgels}, "
              f"chunks {rr.chunks_run}, wall {view_ms:.3f} ms", flush=True)
    secs = time.perf_counter() - t0
    print(f"\n## {found}/{n_views} views recovered ({within} within the GT "
          f"tolerances) with <= {args.retries} retries at "
          f"H={args.hypotheses}; {secs:.1f} s ({n_views / secs:.2f} views/s)")
    print(f"attempt histogram: {dict(sorted(attempts_hist.items()))}")
    print("wall-to-pose ms (first round, recovered views): "
          + json.dumps(_dist(first_ms)))
    print("wall-to-pose ms (cumulative over retries):      "
          + json.dumps(_dist(cum_ms)), flush=True)

    sweep = {}
    if misses and args.exhaustive:
        print(f"\n## Exhaustive sweep on the misses (H={args.exhaustive}):")
        for vi in misses:
            view = eng.load_view(vi)
            best21 = best31 = 0
            for seed in range(max(1, args.exhaustive // args.hypotheses)):
                rr = eng.run_round(view, seed=1000 + seed,
                                   num_hypotheses=args.hypotheses)
                best21 = max(best21, rr.best_support21)
                best31 = max(best31, rr.best_support31)
                if rr.found_pose:
                    break
            need = int(cfg.ransac.pass_inlier_support_ratio * rr.num_edgels)
            sweep[vi] = {"best21": best21, "best31": best31,
                         "recoverable": bool(rr.found_pose)}
            print(f"view {vi:03d}: best support {best21}/{best31} of "
                  f"{rr.num_edgels} (need {need}) over {args.exhaustive} "
                  f"hypotheses -> "
                  f"{'recoverable' if rr.found_pose else 'below criterion'}",
                  flush=True)
    print(json.dumps({"accuracy_sweep": {
        "views": n_views, "found": found, "within_gt": within,
        "misses": misses, "attempts": attempts_hist,
        "first_round_ms": _dist(first_ms), "to_pose_ms": _dist(cum_ms),
        "exhaustive": sweep, "seconds": secs, "device": str(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
