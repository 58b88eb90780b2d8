#!/usr/bin/env python3
"""Hypotheses/s against the shard count on the hypothesis mesh: the
PyTorch/CUDA port's counterpart of tools/scaling_table.py.

    python3 tools/scaling_torch.py [--devices cuda:0 ...] [--shards 1 2 4]
                                   [--hypotheses 100] [--rounds 3] [--abort]
                                   [--grid whole|divided]

For each shard count k, an engine with num_devices = k over the device
list taken in turn (shard i on ``devices[i % len(devices)]``; k = 1 is the
unsharded engine on the first device) runs a warm-up round and then
``--rounds`` rounds of view 0, seed 0; the row is the best track_ms (time
to the pose with ``--abort``), hypotheses/s = H / that, the speed-up over
k = 1 and the tracker kernel's launches per round.  When shards share a
device, as they must on a host with one card, the output says so: the
numbers are then shards sharing that device, not a multi-GPU scaling.
``--grid divided`` launches the tracker kernel with its persistent grid
(SMs x resident blocks per SM, what the port always launches: "whole")
divided by the number of the mesh's shards on the launch's card, by
wrapping ``_kernels.hc_track`` for this run; the results do not depend on
the grid, only the times.
The default device list is the first card, and a card is needed unless
the list names only ``cpu`` (plain twin, minutes at H = 100).  Prints the
card's name and power limit as nvidia-smi gives them, the table and one
JSON line.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", nargs="+", default=["cuda:0"])
    ap.add_argument("--shards", nargs="+", type=int, default=[1, 2, 4])
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--abort", action="store_true",
                    help="time the TrunRANSAC abort round")
    ap.add_argument("--grid", choices=("whole", "divided"), default="whole",
                    help="the kernel's persistent grid per shard")
    ap.add_argument("--data-root",
                    default=os.path.join(ROOT, "data", "synth_trifocal"))
    args = ap.parse_args(argv)

    import torch

    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
        resolve_data_root,
    )

    cuda = any(torch.device(d).type == "cuda" for d in args.devices)
    if cuda and not torch.cuda.is_available():
        print("scaling_torch: no CUDA device (pass --devices cpu for the "
              "CPU)", file=sys.stderr)
        return 2
    if args.grid == "divided" and not cuda:
        print("scaling_torch: --grid divided needs a card", file=sys.stderr)
        return 2
    if cuda:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
    base = resolve_data_root(EngineConfig(data_root=args.data_root))
    if args.abort:
        base = dataclasses.replace(base, ransac=dataclasses.replace(
            base.ransac, abort_by_good_sol=True))
    H = args.hypotheses
    print(f"# {H} hypotheses, view 0, seed 0, best of {args.rounds} rounds "
          f"({'time to pose' if args.abort else 'track_ms'}), kernel grid "
          f"{args.grid}")
    whole = _kernels.hc_track
    print(f"{'shards':>6} {'devices':<32} {'best_ms':>10} {'hyp/s':>10} "
          f"{'speedup':>8} {'launches':>9}")
    rows, ref = [], None
    for k in args.shards:
        mesh = [args.devices[i % len(args.devices)] for i in range(k)]
        if args.grid == "divided":
            _kernels.hc_track = _divided(whole, _kernels, mesh)
        if k == 1:
            eng = engine.TrifocalPoseEngine(base, device=mesh[0])
        else:
            eng = engine.TrifocalPoseEngine(
                dataclasses.replace(base, num_devices=k), device=mesh)
        view = eng.load_view(0)
        eng.run_round(view, 0, H)  # warm-up: builds and loads the kernel
        best, launches = None, []
        for _ in range(args.rounds):
            _kernels.hc_track.launches = 0
            rr = eng.run_round(view, 0, H)
            launches.append(_kernels.hc_track.launches)
            best = rr.track_ms if best is None else min(best, rr.track_ms)
        ref = ref or best
        shared = sorted({d for d in mesh if mesh.count(d) > 1})
        rows.append(dict(shards=k, devices=mesh, best_ms=best,
                         hyp_per_s=H / (best / 1e3), speedup=ref / best,
                         launches_per_round=sum(launches) / len(launches),
                         shared=shared))
        r = rows[-1]
        print(f"{k:>6} {','.join(mesh):<32} {best:>10.3f} "
              f"{r['hyp_per_s']:>10.1f} {r['speedup']:>8.3f} "
              f"{r['launches_per_round']:>9.1f}", flush=True)
    shared = sorted({d for r in rows for d in r["shared"]})
    if shared:
        print(f"note: shards share {', '.join(shared)}: these are shards "
              f"sharing one device, not a multi-GPU scaling")
    _kernels.hc_track = whole
    print(json.dumps({"device": (torch.cuda.get_device_name(0) if cuda
                                 else "cpu"), "hypotheses": H,
                      "abort": args.abort, "grid": args.grid, "rows": rows}))
    return 0


def _divided(whole, _kernels, mesh):
    """``whole`` (``_kernels.hc_track``) launching the card's persistent
    grid divided by the number of ``mesh``'s shards on the launch's card."""
    import torch

    on_card = {}
    for d in mesh:
        d = torch.device(d)
        if d.index is None:
            d = torch.device(d.type, torch.cuda.current_device())
        on_card[d] = on_card.get(d, 0) + 1

    def hc_track(x, xl, flags, efg, plan, niter, cfg, blocks=None):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per_sm = _kernels.hc_track_blocks_per_sm(cfg, x.device)
        return whole(x, xl, flags, efg, plan, niter, cfg,
                     blocks=max(1, sms * per_sm // on_card[x.device]))

    # ``whole`` counts each launch on the module's ``hc_track``: this one.
    hc_track.launches = 0
    return hc_track


if __name__ == "__main__":
    sys.exit(main())
