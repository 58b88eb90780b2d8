"""Command line: RANSAC rounds (or a stream of views) on the card, and the
reference-format output files.

Counterpart of the JAX package's ``cli.py``: the same flags, defaults,
printed lines and output files, apart from the output directory, which is
``build/cli_out`` unless ``--output-dir`` names another.  ``--platform`` is
``gpu`` (the default: the first CUDA card, an error without one) or
``cpu`` (an explicit request to run on the CPU).  ``--profile DIR`` writes a ``torch.profiler`` Chrome
trace of the timed rounds into DIR.  ``--cross-check`` (2 hypotheses) and
``--cross-check-full`` (the whole workload) then run round 0 again through
the engine and through the full-pivot oracle tracker on the CPU
(``backend="xla"``), write ``CPU_Sols_Statistics.txt`` and
``CPU_Converged_HC_tracks.txt``, and exit 1 when the two disagree beyond
the JAX package's bands.  ``--ablation`` prints the strategy-ablation
ladder instead of the rounds: P2C, PH, +TrunPaths, +compaction,
+TrunRANSAC, each the best track_ms of several seeds after a warm-up.
``--devices N`` with N > 1 shards the hypotheses over N devices
(``parallel/mesh.py``): the first N cards, or with ``--platform cpu`` N
CPU shards; the data root's ``Num_Of_GPUs`` sets it when the flag is
absent.  ``--ablation`` refuses it before any tracking: its P2C rung does
not shard.

Usage:
  python -m trifocal_pose_estimation_using_improved_gpuhc_torch.cli \\
      [--views 1] [--hypotheses 100] [--times 1] [--platform gpu|cpu] \\
      [--stream] [--abort] [--cross-check | --cross-check-full] \\
      [--ablation] [--devices N] [--output-dir build/cli_out]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

# The JAX package's cross-check bands (its cli.py): converged-flag
# disagreements and converged totals within 0.5 % of the paths (floor 3),
# best supports within 0.2 % of the edgels (floor 5).
_CC_FLIP_FRAC = 0.005
_CC_SUP_FRAC = 0.002


# The JAX CLI writes into Output_Write_Files/ by default, which holds the
# reference's committed outputs; the port writes under build/.
DEFAULT_OUTPUT_DIR = os.path.join("build", "cli_out")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-p", "--problem", default="trifocal_2op1p_30x30")
    ap.add_argument("--views", type=int, default=1, help="number of dataset views")
    ap.add_argument("--start-view", type=int, default=0)
    ap.add_argument("--hypotheses", type=int, default=None,
                    help="RANSAC iterations per round (default: config, 100)")
    ap.add_argument("--times", type=int, default=1,
                    help="TEST_RANSAC_TIMES: repeat rounds for timing stats")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu: the first CUDA card (an error without one); "
                         "cpu: run on the CPU")
    ap.add_argument("--cross-check", action="store_true",
                    help="run round 0 (2 hypotheses) again through the "
                         "full-pivot oracle on the CPU and compare")
    ap.add_argument("--cross-check-full", action="store_true",
                    help="the cross-check over the whole hypothesis "
                         "workload (minutes of CPU)")
    ap.add_argument("--dedup-mode", default="batch",
                    choices=["batch", "reference"],
                    help="unique-solution semantics: 'batch' dedups all "
                         "H x tracks solutions; 'reference' reproduces the "
                         "reference's count (RANSAC iteration 0 only)")
    ap.add_argument("--abort", action="store_true",
                    help="Abort_RANSAC_by_Good_Sol: stop once a pose with "
                         ">=90%% inlier support is found on-device")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard hypotheses over the first N devices (N CPU "
                         "shards with --platform cpu; default: the data "
                         "root's Num_Of_GPUs, else 1)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--output-dir", default=DEFAULT_OUTPUT_DIR)
    ap.add_argument("--ablation", action="store_true",
                    help="emit the strategy-ablation timing table "
                         "(P2C, PH, TrunPaths, compaction, TrunRANSAC)")
    ap.add_argument("--stream", action="store_true",
                    help="streamed recovery: two views in flight on the card, "
                         "one selection read back per view")
    ap.add_argument("--eval-structure", default=None,
                    choices=["classic", "gathered", "merged"],
                    help="evaluator op structure (HCConfig.eval_structure)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the timed "
                         "rounds into DIR")
    ap.add_argument("--debug-gt-deviation", action="store_true",
                    help="print the best pose's ground-truth deviation "
                         "report per round")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from trifocal_pose_estimation_using_improved_gpuhc_torch.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        evaluation as evl,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        config_for_data_root,
    )

    # The flags override the data root's settings.
    cfg = config_for_data_root(args.data_root, args.problem)
    if args.devices is not None:
        cfg = dataclasses.replace(
            cfg, num_devices=args.devices if args.devices > 1 else None)
    ndev = cfg.num_devices or 1
    if args.ablation and ndev > 1:
        print(f"--ablation does not shard: its P2C rung runs on one device "
              f"(the JAX engine would track it with its oracle over "
              f"{ndev} devices); run it with --devices 1", file=sys.stderr)
        return 2
    if args.abort:
        cfg = dataclasses.replace(
            cfg,
            ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True),
        )
    if args.eval_structure is not None:
        cfg = dataclasses.replace(
            cfg,
            hc=dataclasses.replace(cfg.hc, eval_structure=args.eval_structure),
        )

    if args.platform == "gpu" and not torch.cuda.is_available():
        print("no CUDA device; pass --platform cpu to run on the CPU",
              file=sys.stderr)
        return 2
    device = cpu_devices(ndev) if args.platform == "cpu" else None
    os.makedirs(args.output_dir, exist_ok=True)
    if args.ablation:
        return run_ablation(cfg, args, device)
    engine = TrifocalPoseEngine(cfg, device=device)
    print(f"[torch-hc] problem: {args.problem}, "
          f"{engine.problem.num_tracks} tracks x "
          f"{args.hypotheses or cfg.ransac.num_iterations} hypotheses on "
          f"{engine.device}"
          + (f" ({torch.cuda.get_device_name(engine.device)})"
             if engine.device.type == "cuda" else "")
          + (f" over {ndev} devices" if ndev > 1 else ""))

    timings, all_stats, found_count, err_lines = [], [], 0, []
    view0 = engine.load_view(args.start_view)
    engine.run_round(view0, seed=0, num_hypotheses=args.hypotheses)  # warm-up
    _kernels.hc_track.launches = 0

    def print_launches():
        # None on the CPU, where the plain version tracks.
        print(f" - hc_track kernel launches after the warm-up round: "
              f"{_kernels.hc_track.launches} on {engine.device}")

    if args.stream:
        # One selection per view comes back: per-path HC step counts stay
        # on the card, so the HC-steps files are not written.
        print("[stream] note: per-path HC step counts stay on device in "
              "stream mode; HC-steps output files will be empty (use a "
              "non-stream run for them)")
        vis = list(range(args.start_view, args.start_view + args.views))
        results, vps = engine.run_stream(vis, num_hypotheses=args.hypotheses)
        ok = sum(1 for r in results
                 if r.pose_errors is not None and r.pose_errors.within(cfg.ransac))
        print(f"[stream] {len(vis)} views at {vps:.2f} views/s; "
              f"found {sum(r.found_pose for r in results)}/{len(vis)}; "
              f"within GT tolerance {ok}/{len(vis)}")
        evl.write_sols_statistics(
            os.path.join(args.output_dir, "GPU_Sols_Statistics.txt"),
            [r.stats for r in results],
        )
        print_launches()
        return 0

    prof_ctx = contextlib.nullcontext()
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof_ctx = torch.profiler.profile(activities=activities)
    last_rr = None
    with prof_ctx as prof:
        for vi in range(args.start_view, args.start_view + args.views):
            view = engine.load_view(vi)
            for ti in range(args.times):
                rr = engine.run_round(
                    view, seed=ti, num_hypotheses=args.hypotheses,
                    collect_solutions=True,
                )
                last_rr = rr
                timings.append(rr.track_ms)
                all_stats.append(rr.stats)
                if rr.found_pose:
                    found_count += 1
                pe = rr.pose_errors
                status = "FOUND" if rr.found_pose else "no-pass"
                line = (
                    f"view {vi:03d} round {ti}: track {rr.track_ms:8.2f} ms, "
                    f"conv {rr.stats.num_converged}, cand {rr.num_candidates}, "
                    f"support {rr.best_support21}/{rr.best_support31} of {rr.num_edgels} "
                    f"[{status}]"
                )
                if pe is not None:
                    line += (
                        f" rot ({pe.rot21:.4f}, {pe.rot31:.4f})"
                        f" transl ({pe.transl21:.4f}, {pe.transl31:.4f})"
                    )
                    err_lines.append(pe)
                print(line)
                if args.debug_gt_deviation and rr.best_pose is not None:
                    print(evl.format_gt_deviation(
                        *rr.best_pose, view.gt_pose21, view.gt_pose31))
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"[profile] Chrome trace of the timed rounds: {trace}")

    ts = evl.timing_summary(timings)
    n_rounds = len(timings)
    print(f"\n## {n_rounds} round(s) of RANSAC (path tracking wall-clock):")
    print(f" - [Average Computation Time] {ts['avg_ms']:9.2f} (ms)")
    print(f" - [Maximal Computation Time] {ts['max_ms']:9.2f} (ms)")
    print(f" - [Minimal Computation Time] {ts['min_ms']:9.2f} (ms)")
    print(f" - [Std dev Computation Time] {ts['std_ms']:9.2f} (ms)")
    print(f" - Poses with >=90% inlier support: {found_count}/{n_rounds}")
    if err_lines:
        ok = sum(1 for p in err_lines if p.within(cfg.ransac))
        print(f" - Best poses within GT tolerance (rot/transl < 0.1): {ok}/{len(err_lines)}")

    evl.write_timings(os.path.join(args.output_dir, "GPU_Timings.txt"), timings)
    evl.write_sols_statistics(
        os.path.join(args.output_dir, "GPU_Sols_Statistics.txt"), all_stats
    )
    # The final round's converged tracks and the HC steps of its
    # max-support solutions.
    if last_rr is not None:
        sols = last_rr.solutions
        evl.write_converged_sols(
            os.path.join(args.output_dir, "GPU_Converged_HC_tracks.txt"),
            sols.x, sols.converged, engine.problem.num_tracks,
        )
        evl.write_hc_steps(
            os.path.join(args.output_dir,
                         "GPUHC_Steps_of_Actual_Solutions.txt"),
            last_rr.actual_sol_steps,
        )
        if args.dedup_mode == "reference":
            uniq = evl.find_unique_solutions_reference(
                sols.x, sols.converged, engine.problem.num_tracks,
                tol=cfg.ransac.duplicate_sol_tol,
            )
        else:
            uniq = evl.find_unique_solutions(
                sols.x, sols.converged, tol=cfg.ransac.duplicate_sol_tol
            )
        print(f" - Unique converged solutions (final round, "
              f"{args.dedup_mode} mode): {uniq.size}"
              f" of {int(sols.converged.sum())}")
        st = dataclasses.replace(last_rr.stats, num_unique=int(uniq.size))
        print(f" - Percentage of convergence {st.pct_converged:.4f}, "
              f"infinity {st.pct_infinity:.4f}, real {st.pct_real:.4f}, "
              f"unique {st.pct_unique:.4f}")
        if last_rr.min_residuals is not None:
            mr = last_rr.min_residuals
            print(f" - Min residuals over all candidate sols: "
                  f"rot ({mr.rot21:.4f}, {mr.rot31:.4f}) "
                  f"transl ({mr.transl21:.4f}, {mr.transl31:.4f}); "
                  f"any pose within GT tolerance: {last_rr.any_within_gt}")
    print_launches()
    if args.cross_check or args.cross_check_full:
        return run_cross_check(engine, cfg, args, view0,
                               full=args.cross_check_full)
    return 0


# The ablation ladder's rungs, the JAX CLI's: (name, HCConfig overrides,
# RansacConfig overrides).
ABLATION_RUNGS = [
    ("P2C baseline (coefficient tables)",
     dict(backend="p2c", truncate_paths=False, compact_survivors=False),
     dict()),
    ("PH (direct parameter homotopy)",
     dict(backend="fused", truncate_paths=False, compact_survivors=False),
     dict()),
    ("PH + TrunPaths (depth pruning)",
     dict(backend="fused", truncate_paths=True, compact_survivors=False),
     dict()),
    ("PH + TrunPaths + compaction (production)",
     dict(backend="fused", truncate_paths=True, compact_survivors=True),
     dict()),
    ("PH + TrunPaths + compaction + TrunRANSAC",
     dict(backend="fused", truncate_paths=True, compact_survivors=True),
     dict(abort_by_good_sol=True)),
]


def cpu_devices(ndev: int):
    """The engine's device argument for ndev shards on the CPU."""
    return "cpu" if ndev == 1 else ["cpu"] * ndev


def run_ablation(cfg, args, device=None) -> int:
    """The incremental-strategy ladder in one invocation, as the JAX CLI's
    ``run_ablation`` prints it: each rung a configuration of the one
    tracker kernel, warmed up on seed 0, then the best track_ms (the
    tracking span) of max(2, --times) seeds with that round's converged
    count and found flag; the last rung times to the accepted pose.  After
    each row, the kernel's launches in the rung's timed rounds (0 on the
    CPU, where the plain twin tracks)."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
    )

    H = args.hypotheses or cfg.ransac.num_iterations
    seeds = max(2, args.times)
    print(f"## Strategy ablation: view {args.start_view}, {H} hypotheses "
          f"x {cfg.problem.num_tracks} paths "
          f"(last row times to the accepted pose)")
    print(f"{'variant':44s} {'best ms':>9} {'conv':>6} {'found':>6}")
    for name, hc_over, rc_over in ABLATION_RUNGS:
        vcfg = dataclasses.replace(
            cfg,
            hc=dataclasses.replace(cfg.hc, **hc_over),
            ransac=dataclasses.replace(cfg.ransac, **rc_over),
        )
        eng = TrifocalPoseEngine(vcfg, device=device)
        view = eng.load_view(args.start_view)
        eng.run_round(view, seed=0, num_hypotheses=H)  # warm-up
        _kernels.hc_track.launches = 0
        best, conv, found = 1e30, 0, False
        for seed in range(seeds):
            rr = eng.run_round(view, seed=seed, num_hypotheses=H)
            if rr.track_ms < best:
                best, conv, found = (rr.track_ms, rr.stats.num_converged,
                                     rr.found_pose)
        print(f"{name:44s} {best:9.1f} {conv:6d} {str(found):>6}",
              flush=True)
        print(f" - hc_track kernel launches in {seeds} timed rounds: "
              f"{_kernels.hc_track.launches} on {eng.device}", flush=True)
    return 0


def cross_check_hypotheses(args, cfg, full: bool) -> int:
    """The cross-check's hypotheses: the whole workload for the full tier,
    else at most 2 (the JAX CLI's fast tier)."""
    if full:
        return args.hypotheses or cfg.ransac.num_iterations
    return min(args.hypotheses or 2, 2)


def run_cross_check(engine, cfg, args, view0, full: bool) -> int:
    """The reference's correctness story: round 0 (view ``view0``, seed 0)
    through the engine and through an oracle engine (``backend="xla"``)
    on the CPU (sharded over cfg.num_devices CPU shards, as the JAX CLI's
    oracle engine is), compared under the JAX package's bands.  Writes the
    oracle's statistics and converged tracks into the output directory;
    returns 1 on MISMATCH."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.engine import (
        TrifocalPoseEngine,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        evaluation as evl,
    )

    h_cc = cross_check_hypotheses(args, cfg, full)
    print(f"\n[cross-check] re-running round 0 ({h_cc} hypotheses) on the "
          "CPU backend ...")
    cpu_cfg = dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, backend="xla"))
    launches = _kernels.hc_track.launches
    rr_gpu = engine.run_round(view0, seed=0, num_hypotheses=h_cc,
                              collect_solutions=True)
    print(f"[cross-check] hc_track kernel launches in the {engine.device} "
          f"round: {_kernels.hc_track.launches - launches}")
    cpu_engine = TrifocalPoseEngine(cpu_cfg,
                                    device=cpu_devices(cfg.num_devices or 1))
    rr = cpu_engine.run_round(view0, seed=0, num_hypotheses=h_cc,
                              collect_solutions=True)
    print(f"cpu-hc: conv {rr.stats.num_converged}, cand {rr.num_candidates}, "
          f"support {rr.best_support21}/{rr.best_support31} of "
          f"{rr.num_edgels}")
    evl.write_sols_statistics(
        os.path.join(args.output_dir, "CPU_Sols_Statistics.txt"), [rr.stats])
    evl.write_converged_sols(
        os.path.join(args.output_dir, "CPU_Converged_HC_tracks.txt"),
        rr.solutions.x, rr.solutions.converged,
        cpu_engine.problem.num_tracks)
    n_paths = h_cc * engine.problem.num_tracks
    dis = int((rr_gpu.solutions.converged != rr.solutions.converged).sum())
    tol_paths = max(3, int(_CC_FLIP_FRAC * n_paths))
    sup_tol = max(5, int(_CC_SUP_FRAC * rr.num_edgels))
    ok = (dis <= tol_paths
          and abs(rr_gpu.stats.num_converged - rr.stats.num_converged)
          <= tol_paths
          and abs(rr_gpu.best_support21 - rr.best_support21) <= sup_tol
          and abs(rr_gpu.best_support31 - rr.best_support31) <= sup_tol)
    print(f"[cross-check] converged-flag disagreements: {dis}/{n_paths} "
          f"(tol {tol_paths}); conv totals "
          f"{rr_gpu.stats.num_converged} vs {rr.stats.num_converged} "
          f"(tol {tol_paths}); support "
          f"{rr_gpu.best_support21}/{rr_gpu.best_support31} vs "
          f"{rr.best_support21}/{rr.best_support31} (tol {sup_tol}) -> "
          f"{'AGREE' if ok else 'MISMATCH'}")
    if not ok:
        print("[cross-check] FAILED: device and CPU-HC results diverge")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
