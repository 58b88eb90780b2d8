#!/usr/bin/env python3
"""Profile one RANSAC round, or a stream of views, of the PyTorch/CUDA port
on the card.

    python3 tools/profile_torch_round.py [--hypotheses 100] [--view 0] [--seed 0]
                                         [--abort] [--stream N] [--shards K]

Runs a warm-up round of the engine's default configuration (or, with
``--abort``, of the TrunRANSAC abort round), then one round under
``torch.profiler`` (with ``--stream N``, ``run_stream`` over N views,
the data root's views in turn, in the abort pipeline with ``--abort``),
and prints: the card's name and power limit as nvidia-smi gives them,
the round's host-clock spans (track_ms, total_ms; for a stream, views/s
and the mean per-view latency), the device's busy time (the union of all
kernel intervals) and idle share over the profiled span, and the ten
kernels with the most device time.  ``--shards K`` shards the hypotheses
over K shards that share the first card (``num_devices=K``).  Needs a CUDA card; exits nonzero
without one.
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--view", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--abort", action="store_true",
                    help="profile the abort round (abort_by_good_sol)")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="profile run_stream over N views instead")
    ap.add_argument("--shards", type=int, default=1, metavar="K",
                    help="shard the hypotheses over K shards on cuda:0")
    ap.add_argument("--data-root",
                    default=os.path.join(ROOT, "data", "synth_trifocal"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_round: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        data_io,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
        ransac_data_dir,
    )

    cfg = EngineConfig(data_root=args.data_root)
    if args.abort:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
            cfg.ransac, abort_by_good_sol=True))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])
    if args.shards > 1:
        eng = engine.TrifocalPoseEngine(
            dataclasses.replace(cfg, num_devices=args.shards),
            device=["cuda:0"] * args.shards)
    else:
        eng = engine.TrifocalPoseEngine(cfg)
    view = eng.load_view(args.view)
    eng.run_round(view, args.seed, args.hypotheses)  # warm-up
    n_views = data_io.num_ransac_views(ransac_data_dir(cfg))
    views = [(args.view + i) % n_views for i in range(args.stream)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if args.stream:
            results, vps = eng.run_stream(views, args.hypotheses, args.seed)
        else:
            rr = eng.run_round(view, args.seed, args.hypotheses)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels]) / 1e3
    if args.stream:
        lat = [r.track_ms for r in results]
        span = (f"stream of {len(views)} views wall {wall_ms:.3f} ms "
                f"(profiled), {vps:.3f} views/s, per-view latency mean "
                f"{sum(lat) / len(lat):.3f} ms, found "
                f"{sum(r.found_pose for r in results)}/{len(results)}"
                + (f", chunks run {sum(r.chunks_run for r in results)}"
                   if args.abort else ""))
    else:
        span = (f"round wall {wall_ms:.3f} ms (profiled), track_ms "
                f"{rr.track_ms:.3f}, total_ms {rr.total_ms:.3f}"
                + (f", chunks run {rr.chunks_run}" if args.abort else ""))
    print(f"{torch.cuda.get_device_name(0)}: H={args.hypotheses}, "
          f"{args.shards} shard(s) on cuda:0, {span}; "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}; {len(kernels)} device events")
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {ms:10.3f} ms {n:7d}x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
