#!/usr/bin/env python3
"""Converged, real, infinity and pruned counts of the reference's sampled
workload, with TrunPaths off and on, through the engine's tracker.

    python3 tools/reconcile_stats_torch.py [--hypotheses 100]
        [--platform gpu|cpu] [--data-root DIR]

The port of tools/reconcile_stats.py.  The workload is the reference's own
sampling (view 0, glibc srand(0) with its duplicate-check quirk,
``ops/ransac.sample_edgel_triplets_reference``), ``--hypotheses`` triplets
times every root, tracked by the engine's tracker (the segmented kernel
K1 on the card, its plain twin with --platform cpu) with TrunPaths off and
then on.  Per setting it prints the counts and the summed step counts,
the real count over a tolerance sweep and the quantiles of max|imag| over
the converged paths, and last one JSON line.  The reference's committed
counts belong to the reference's problem (312 roots) and its view 0,
which this repository does not have: they are printed once, labelled as
the reference's, and are no target here.  Exits 2 without a card unless
given --platform cpu (about half an hour per setting at H = 100 there).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference's committed sample runs (converged / real / infinity; its
# writers swap the real and infinity columns), on its own problem and view.
REFERENCE = {"TrunPaths off (its CPU solver)": "11098 / 521 / 6577",
             "TrunPaths on (its GPU kernel)": "272 / 5 / 495"}


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        tooling,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hypotheses", type=int, default=100)
    tooling.add_arguments(ap)
    args = ap.parse_args(argv)

    import torch

    from trifocal_pose_estimation_using_improved_gpuhc_torch.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
        ransac,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        evaluation as evl,
    )

    dev = tooling.device(args.platform, "reconcile_stats_torch")
    if dev is None:
        return 2
    print(tooling.card_line(dev), flush=True)
    print("the reference's committed counts (converged / real / infinity), "
          "on its own problem and view 0, not comparable here: "
          + "; ".join(f"{k} {v}" for k, v in REFERENCE.items()), flush=True)
    H = args.hypotheses
    out = {"hypotheses": H, "device": str(dev)}
    for trun in (False, True):
        base = config.config_for_data_root(args.data_root)
        cfg = dataclasses.replace(
            base, hc=dataclasses.replace(base.hc, truncate_paths=trun))
        eng = TrifocalPoseEngine(cfg, device=dev)
        view = eng.load_view(0)
        T = eng.problem.num_tracks
        samples = ransac.sample_edgel_triplets_reference(
            0, view.edge_locations.shape[0], H)
        tgt = torch.as_tensor(ransac.build_target_params(
            view.edge_locations, view.edge_tangents, samples),
            device=dev).repeat_interleave(T, dim=0)
        _kernels.hc_track.launches = 0
        t0 = time.perf_counter()
        res = eng.track(eng._start.repeat(H, 1), tgt)
        if eng._segmented:
            res = res.track
        tooling.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        x = res.x.cpu().numpy()
        conv = res.converged.cpu().numpy()
        stats = evl.collect_stats(x, conv, res.inf_fail.cpu().numpy(),
                                  cfg.ransac)
        mi = np.abs(x.imag).max(axis=-1)[conv]
        key = "trunpaths_on" if trun else "trunpaths_off"
        fig = {"converged": stats.num_converged, "real": stats.num_real,
               "inf": stats.num_infinity,
               "pruned": int(res.pruned.sum()),
               "steps": int(res.num_steps.sum()),
               "real_by_tol": tooling.real_counts(x, conv),
               "max_imag_quantiles": tooling.quantiles(
                   mi, (10, 25, 50, 75, 90)),
               "launches": _kernels.hc_track.launches, "track_ms": ms}
        out[key] = fig
        print(f"TrunPaths {'on' if trun else 'off'}: converged "
              f"{fig['converged']} real {fig['real']} inf {fig['inf']} "
              f"pruned {fig['pruned']} of {H * T} paths, steps "
              f"{fig['steps']}, K1 launches {fig['launches']}, "
              f"{ms:.3f} ms\n"
              f"  real count by imag tol: {fig['real_by_tol']}\n"
              f"  max|imag| over converged ({int(np.isfinite(mi).sum())} "
              f"finite of {mi.size}), p10/25/50/75/90: "
              f"{fig['max_imag_quantiles']}", flush=True)
    print(json.dumps({"reconcile_stats": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
