#!/usr/bin/env python3
"""Time the tiled handoff tracker (hc_track_tile_kernel) under each cluster
size and block layout on the card, bit for bit against its own geometry.

    python3 tools/tile_sweep_torch.py [--clusters 1 2 4 8] [--warps 4 8 16]
                                      [--tree DIR ...] [--hypotheses 100]

On one RANSAC round's paths (view 0, seed 0, H hypotheses) under
predictor_handoff at tile 128 (cph128), by CUDA events, median of 3 after
a warm-up: one launch and the segmented tracker (the engine's default) at
the geometry ``_kernels.tile_launch`` chooses, then with each cluster size
of ``--clusters`` forced (every tile's cluster that size, as many tiles in
flight as the card holds), each run's paths compared with the chosen
geometry's bit for bit; and the per-path kernel under the handoff at tile 1
(cph) segmented, before and after, as the yardstick.  It prints the
resident clusters of each size, the blocks per SM and each launch's
(tiles, cluster, blocks).

``--warps`` also times blocks of other warp counts: for each count it
copies this tree's package under build/tile_sweep/w<N>/ with the tiled
tracker's TILE_WARPS set to N and runs there, in a child process.
``--tree DIR`` adds another tree (an earlier commit unpacked by ``git
archive``, or a variant of this one) run the same way.  The trees run in
turns, one process each; every tree's paths must equal this tree's.  The
card's name and power limit come first, a JSON line of every tree's
numbers last.  Needs a CUDA card; exits nonzero without one.
"""

import argparse
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "trifocal_pose_estimation_using_improved_gpuhc_torch"
VIEW, SEED, TILE = 0, 0, 128


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def measure(tree: str, clusters, hypotheses: int, save: str) -> dict:
    """This tree's numbers, in this process; its paths saved to ``save``."""
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
        data_root=os.path.join(ROOT, "data", "synth_trifocal")))
    tiled = dataclasses.replace(cfg.hc, predictor_handoff=True, tile=TILE)
    per_path = dataclasses.replace(cfg.hc, predictor_handoff=True, tile=1)
    _kernels.build_hc_track([tiled])
    engine = eng.TrifocalPoseEngine(cfg)
    problem = engine.problem
    view = engine.load_view(VIEW)
    T = problem.num_tracks
    s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0],
                                     hypotheses)
    tgt = torch.as_tensor(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s), device=dev)
    tgt = tgt.repeat_interleave(T, dim=0)
    x0 = engine._start.repeat(hypotheses, 1)
    one = fused.make_track_fn(problem, tiled)
    seg = segmented.make_segmented_track_fn(problem, tiled)
    seg1 = segmented.make_segmented_track_fn(problem, per_path)

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

    pick = _kernels.tile_launch

    def run(force=None):
        """(one launch, segmented) results and their launches' (tiles,
        cluster, blocks), every tile's cluster ``force`` if given."""
        chosen = []

        def geometry(n_paths, tile, warps, resident, *a, **kw):
            if force is None:
                c, grid = pick(n_paths, tile, warps, resident, *a, **kw)
            else:
                r = _kernels._resident_clusters(
                    _kernels._hc_track_lib(tiled), dev, [force])[force]
                c, grid = force, force * min(-(-n_paths // tile), r)
            chosen.append((-(-n_paths // tile), c, grid))
            return c, grid

        _kernels.tile_launch = geometry
        try:
            out = (one(x0, tgt), seg(x0, tgt).track)
            torch.cuda.synchronize()
            launches = list(chosen)
            times = (median3(lambda: one(x0, tgt)),
                     median3(lambda: seg(x0, tgt)))
        finally:
            _kernels.tile_launch = pick
        return out, launches, times

    def bits(r):
        return [torch.view_as_real(r.x).view(torch.int32).cpu(),
                r.converged.cpu(), r.inf_fail.cpu(), r.pruned.cpu(),
                r.num_steps.cpu()]

    warps = _kernels._occupancy_of(_kernels._hc_track_lib(tiled), dev,
                                   TILE)[1]
    out = {"tree": tree, "warps": warps, "paths": hypotheses * T,
           "blocks_per_sm": _kernels.hc_track_blocks_per_sm(tiled, dev),
           "resident": _kernels.hc_track_tile_clusters(tiled, dev),
           "cph_segmented_ms": [median3(lambda: seg1(x0, tgt))]}
    ref, geo, (ms_one, ms_seg) = run()
    out["chosen"] = dict(one_launch_ms=ms_one, segmented_ms=ms_seg,
                         launches=geo)
    torch.save([bits(r) for r in ref], save)
    for c in clusters:
        res, geo, (ms_one, ms_seg) = run(c)
        same = all(all(torch.equal(u, v) for u, v in zip(bits(a), bits(b)))
                   for a, b in zip(res, ref))
        if not same:
            raise AssertionError(f"cluster {c}: paths differ from the "
                                 f"chosen geometry's")
        out[f"cluster_{c}"] = dict(one_launch_ms=ms_one, segmented_ms=ms_seg,
                                   launches=geo)
    out["cph_segmented_ms"].append(median3(lambda: seg1(x0, tgt)))
    print(f"{tree}: {warps} warps a block, {out['blocks_per_sm']} per SM; "
          f"resident clusters {out['resident']}", flush=True)
    for key in ["chosen"] + [f"cluster_{c}" for c in clusters]:
        r = out[key]
        print(f"  {key:10s} one launch {r['one_launch_ms']:9.3f} ms, "
              f"segmented {r['segmented_ms']:9.3f} ms; launches (tiles, "
              f"cluster, blocks) {r['launches']}", flush=True)
    print(f"  cph (tile 1) segmented "
          + ", ".join(f"{t:.3f}" for t in out["cph_segmented_ms"]) + " ms",
          flush=True)
    return out


def layout_tree(warps: int) -> str:
    """A copy of this tree's package with the tiled tracker's TILE_WARPS
    set to ``warps``, under build/tile_sweep/w<warps>/."""
    dst = os.path.join(ROOT, "build", "tile_sweep", f"w{warps}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, PKG, "csrc", "hc_track.cu")
    with open(src) as fh:
        text = fh.read()
    text, n = re.subn(r"constexpr int TILE_WARPS = \d+;",
                      f"constexpr int TILE_WARPS = {warps};", text)
    if n != 1:
        raise RuntimeError(f"{src}: no TILE_WARPS to set")
    with open(src, "w") as fh:
        fh.write(text)
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--warps", type=int, nargs="*", default=[])
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--child", nargs=2, metavar=("TREE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tile_sweep_torch: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        tree, path = args.child
        result = measure(tree, args.clusters, args.hypotheses,
                         path + ".pt")
        with open(path, "w") as fh:
            json.dump(result, fh)
        return 0
    print(_card(), flush=True)
    trees = ([ROOT] + [layout_tree(w) for w in args.warps]
             + [os.path.abspath(t) for t in args.tree])
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            path = os.path.join(tmp, f"{i}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", tree, path, "--hypotheses",
                            str(args.hypotheses), "--clusters",
                            *map(str, args.clusters)], check=True)
            with open(path) as fh:
                results.append(json.load(fh))
            if i:
                same = all(torch.equal(u, v) for a, b in zip(
                    torch.load(path + ".pt"),
                    torch.load(os.path.join(tmp, "0.json.pt")))
                    for u, v in zip(a, b))
                print(f"{tree}: paths equal to this tree's: {same}",
                      flush=True)
                if not same:
                    return 1
    print(json.dumps({"card": _card(), "trees": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
