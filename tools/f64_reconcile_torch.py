#!/usr/bin/env python3
"""Float32 against float64 tracking of one workload: where the real count
lands and how many flags are float32 noise.

    python3 tools/f64_reconcile_torch.py [--hypotheses 100] [--chunk 10]
        [--tracker oracle|k1] [--platform gpu|cpu] [--data-root DIR]

The port of tools/f64_reconcile.py.  A solution is "real" when it
converged and every |imag(x_v)| <= 1e-4 (the reference's
ZERO_IMAG_PART_TOL), a cliff that float32 rounding can straddle.  This
tool tracks the same workload (view 0, the reference's glibc sampling of
``--hypotheses`` triplets, every root, TrunPaths off) at float32 and at
float64 through the port's full-pivot oracle (``ops/tracker.py``,
``backend="xla"``); with ``--tracker k1`` the float32 side is the tracker
kernel K1 instead (``fused.make_track_fn``, one launch), so that K1's flags
are held to the float64 oracle's.  It prints, per precision, the converged
and infinity counts, the real count over a tolerance sweep (1e-5 to 1e-2)
and the quantiles of max|imag| over the converged paths; then the float32
against float64 endpoint distance where both converge, the converged and
infinity flag flips between them, and the real@1e-4 flips; and last one
JSON line of these figures.  It runs on cuda:0 unless given --platform cpu
(minutes per hypothesis there), and exits 2 without a card.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_TOL = 1e-4


def compare(lo, hi, tol=REAL_TOL):
    """Figures of a low-precision run against a high-precision one, each
    (x, converged, inf_fail) numpy: paths both converge, the quantiles of
    their endpoint distance max_v |x_lo - x_hi|, the flag flips and the
    real@tol flips among the paths both converge."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        tooling,
    )

    (xa, ca, ia), (xb, cb, ib) = lo, hi
    both = ca & cb
    d = np.abs(xa[both].astype(np.complex128) - xb[both]).max(axis=-1) \
        if both.any() else np.zeros(0)
    ra = np.abs(xa.imag).max(axis=-1) <= tol
    rb = np.abs(xb.imag).max(axis=-1) <= tol
    return {"both_converged": int(both.sum()),
            "endpoint_distance": tooling.quantiles(d),
            "converged_flips": int((ca != cb).sum()),
            "inf_flips": int((ia != ib).sum()),
            "real_lo_only": int((both & ra & ~rb).sum()),
            "real_hi_only": int((both & ~ra & rb).sum()),
            "real_both": int((both & ra & rb).sum())}


def track_chunks(track, x0, tgt, T, chunk, dev):
    """Track hypotheses ``chunk`` at a time: x0 (T, V) the start roots on
    dev, tgt (H, P+1) numpy; returns (x, converged, inf_fail) numpy over
    H x T paths, in complex128."""
    import torch

    xs, cs, fs = [], [], []
    for h0 in range(0, len(tgt), chunk):
        t = torch.as_tensor(tgt[h0:h0 + chunk], device=dev)
        res = track(x0.repeat(t.shape[0], 1), t.repeat_interleave(T, dim=0))
        xs.append(res.x.cpu().numpy().astype(np.complex128))
        cs.append(res.converged.cpu().numpy())
        fs.append(res.inf_fail.cpu().numpy())
    return np.concatenate(xs), np.concatenate(cs), np.concatenate(fs)


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        tooling,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hypotheses", type=int, default=100)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--tracker", choices=("oracle", "k1"), default="oracle",
                    help="the float32 side: the oracle, or the kernel K1")
    tooling.add_arguments(ap)
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        fused,
        ransac,
        tracker,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
        data_io,
    )

    dev = tooling.device(args.platform, "f64_reconcile_torch")
    if dev is None:
        return 2
    print(tooling.card_line(dev), flush=True)
    cfg = config.config_for_data_root(args.data_root)
    hc = dataclasses.replace(cfg.hc, truncate_paths=False)
    problem = trifocal.TrifocalProblem.load(cfg)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    samples = ransac.sample_edgel_triplets_reference(
        0, view.edge_locations.shape[0], args.hypotheses)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     samples)
    T = problem.num_tracks
    x0 = torch.as_tensor(np.asarray(problem.start_sols), device=dev)
    f32 = (fused.make_track_fn(problem, hc) if args.tracker == "k1"
           else tracker.make_track_fn(problem, hc))
    runs = {"f32": (f"float32 {'K1' if args.tracker == 'k1' else 'oracle'}",
                    f32),
            "f64": ("float64 oracle",
                    tracker.make_track_fn(problem, hc, dtype=torch.float64))}
    out = {"tracker": args.tracker, "hypotheses": args.hypotheses,
           "paths": args.hypotheses * T, "device": str(dev)}
    results = {}
    for key, (label, track) in runs.items():
        t0 = time.perf_counter()
        res = track_chunks(track, x0, tgt, T, args.chunk, dev)
        tooling.synchronize(dev)
        secs = time.perf_counter() - t0
        results[key] = res
        x, conv, inf = res
        mi = np.abs(x.imag).max(axis=-1)[conv]
        fig = {"converged": int(conv.sum()), "inf": int(inf.sum()),
               "real_by_tol": tooling.real_counts(x, conv),
               "max_imag_quantiles": tooling.quantiles(mi), "seconds": secs}
        out[key] = fig
        print(f"== {label}: converged {fig['converged']} inf {fig['inf']} "
              f"of {out['paths']} ({secs:.1f} s)\n"
              f"   real count by tol: {fig['real_by_tol']}\n"
              f"   max|imag| over converged ({int(np.isfinite(mi).sum())} "
              f"finite of {mi.size}), percentiles: "
              f"{fig['max_imag_quantiles']}", flush=True)
    cmp = compare(results["f32"], results["f64"])
    out["f32_vs_f64"] = cmp
    print(f"== float32 vs float64: both converged {cmp['both_converged']}; "
          f"endpoint max_v |x32 - x64| percentiles "
          f"{cmp['endpoint_distance']}\n"
          f"   flag flips: converged {cmp['converged_flips']}, inf "
          f"{cmp['inf_flips']} of {out['paths']}\n"
          f"   real@{REAL_TOL:g} among both converged: float32 only "
          f"{cmp['real_lo_only']}, float64 only {cmp['real_hi_only']}, both "
          f"{cmp['real_both']}", flush=True)
    print(json.dumps({"f64_reconcile": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
