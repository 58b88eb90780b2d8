#!/usr/bin/env python3
"""Time the port's tracker kernel on the card, and compare two trees of the
repository in one run.

    python3 tools/time_torch_tracker.py [--tree DIR] [--json OUT]
    python3 tools/time_torch_tracker.py --against DIR

With ``--tree`` (default: this repository) it imports that tree's PyTorch
package, builds its kernel's default build and every variant build, and
times on one RANSAC round's paths (view 0, seed 0, H=100 hypotheses) by
CUDA events, median of 3 after a warm-up: the segmented tracker (the
engine's default: segments of 8 steps with survivor compaction) and one
launch for both solve programs ("reduced", K1; "schedule", K1e), the
segmented tracker of each step and evaluation variant (the handoff per
tile of 128, "cph128", the tiled tracker, also in one launch), and one engine
round's track_ms and total_ms (after a warm-up round).  It prints one
line per measurement and, with ``--json``, writes them.

With ``--against DIR`` (another tree, e.g. an earlier commit unpacked by
``git archive`` into an ignored directory) it runs the measurement above
in child processes in turns, DIR, this tree, this tree, DIR, one process
each, and prints a table of both trees' medians over
their runs beside the card's name and power limit.  Needs a CUDA card;
exits nonzero without one.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, VIEW, SEED = 100, 0, 0
# Variant builds, as chip_smoke.py names them.
VARIANTS = {"rk2": dict(predictor="rk2"), "rk3": dict(predictor="rk3"),
            "cjr1": dict(corrector_jacobian_reuse=1),
            "cjr2": dict(corrector_jacobian_reuse=2),
            "cph": dict(predictor_handoff=True, tile=1),
            # The handoff per tile of 128 paths: the tiled tracker.
            "cph128": dict(predictor_handoff=True, tile=128),
            "rkj": dict(rk_jacobian_reuse=True),
            "split2": dict(eval_precision="split3_rk2"),
            "abc": dict(pair_coef_basis="abc")}
# The builds also timed in one launch.
ONE_LAUNCH = ("reduced", "schedule", "cph128")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def measure(tree: str) -> dict:
    """The measurements of one tree, in this process."""
    import torch

    sys.path.insert(0, tree)
    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine as eng
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
        fused,
        ransac,
        segmented,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
        resolve_data_root,
    )

    if not _kernels.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {_kernels.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    cfg = resolve_data_root(EngineConfig(
        data_root=os.path.join(tree, "data", "synth_trifocal")))
    hc = cfg.hc
    builds = {"reduced": hc, "schedule": dataclasses.replace(
        hc, solver="schedule")}
    builds.update({k: dataclasses.replace(hc, **v)
                   for k, v in VARIANTS.items()})
    _kernels.build_hc_track(list(builds.values()))
    engine = eng.TrifocalPoseEngine(cfg)
    problem = engine.problem
    view = engine.load_view(VIEW)
    T = problem.num_tracks
    s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0], H)
    tgt = torch.as_tensor(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s), device=dev)
    tgt = tgt.repeat_interleave(T, dim=0)
    x0 = engine._start.repeat(H, 1)

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def median3(fn):
        fn()  # warm-up
        return statistics.median(timed(fn) for _ in range(3))

    out = {"card": _card(), "torch_device": torch.cuda.get_device_name(0),
           "paths": H * T, "blocks_per_sm": {}, "segmented_ms": {},
           "one_launch_ms": {}}
    query = getattr(_kernels, "hc_track_blocks_per_sm", None)
    for name, c in builds.items():
        out["blocks_per_sm"][name] = query(c) if query else None
        seg = segmented.make_segmented_track_fn(problem, c)
        out["segmented_ms"][name] = median3(lambda: seg(x0, tgt))
        if name in ONE_LAUNCH:
            one = fused.make_track_fn(problem, c)
            out["one_launch_ms"][name] = median3(lambda: one(x0, tgt))
        print(f"{name}: segmented {out['segmented_ms'][name]:.3f} ms"
              + (f", one launch {out['one_launch_ms'][name]:.3f} ms"
                 if name in out["one_launch_ms"] else "")
              + f", blocks per SM {out['blocks_per_sm'][name]}", flush=True)
    engine.run_round(view, SEED, H)  # warm-up
    rr = engine.run_round(view, SEED, H)
    out["round"] = dict(track_ms=rr.track_ms, total_ms=rr.total_ms,
                        converged=rr.stats.num_converged,
                        found_pose=bool(rr.found_pose))
    print(f"round H={H}: track_ms {rr.track_ms:.3f}, total_ms "
          f"{rr.total_ms:.3f}, converged {rr.stats.num_converged}", flush=True)
    return out


def compare(other: str) -> int:
    runs = {"against": [], "this": []}
    order = [("against", other), ("this", ROOT), ("this", ROOT),
             ("against", other)]
    with tempfile.TemporaryDirectory() as tmp:
        for i, (key, tree) in enumerate(order):
            path = os.path.join(tmp, f"{i}.json")
            print(f"--- run {i}: {key} ({tree})", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", tree, "--json", path], check=True)
            with open(path) as fh:
                runs[key].append(json.load(fh))
    print(runs["this"][0]["card"])
    print(f"{'build':10s} {'against seg':>12s} {'this seg':>10s} "
          f"{'change':>8s} {'against one':>12s} {'this one':>10s}  "
          f"blocks/SM")

    def med(key, field, name):
        vals = [r[field][name] for r in runs[key] if name in r[field]]
        return statistics.median(vals) if vals else None

    table = {}
    for name in runs["this"][0]["segmented_ms"]:
        a, b = med("against", "segmented_ms", name), med(
            "this", "segmented_ms", name)
        a1, b1 = med("against", "one_launch_ms", name), med(
            "this", "one_launch_ms", name)
        table[name] = dict(against_segmented_ms=a, segmented_ms=b,
                           against_one_launch_ms=a1, one_launch_ms=b1,
                           blocks_per_sm=runs["this"][0]["blocks_per_sm"][name])
        one = (f"{a1:12.3f} {b1:10.3f}" if a1 is not None else " " * 23)
        print(f"{name:10s} {a:12.3f} {b:10.3f} {100 * (b / a - 1):+7.1f}% "
              f"{one}  {table[name]['blocks_per_sm']}")
    for key in ("against", "this"):
        r = [x["round"] for x in runs[key]]
        print(f"round ({key}): track_ms "
              + ", ".join(f"{x['track_ms']:.3f}" for x in r) + "; total_ms "
              + ", ".join(f"{x['total_ms']:.3f}" for x in r))
    print(json.dumps({"card": runs["this"][0]["card"], "builds": table,
                      "runs": runs}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--json")
    ap.add_argument("--against")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_torch_tracker: no CUDA device", file=sys.stderr)
        return 2
    if args.against:
        return compare(os.path.abspath(args.against))
    out = measure(os.path.abspath(args.tree))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
