#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the kernel builds (csrc/hc_track.cu with nvcc, the default and each
     variant build of phases 8 and 9, all at once), their seconds, and per
     build its resident blocks per SM (the occupancy query that sizes the
     kernel's persistent grid) and ptxas's resource lines (the phase
     kernels' too for the default and the replaying build);
  3. the kernel against its plain PyTorch twin (ops/fused.track_plain) on
     the card, condensed solve ("reduced"): 1 hypothesis x all paths;
  4. the main path: one RANSAC round (view 0, seed 0, H=100 hypotheses)
     through the engine's default tracker (segments of 8 steps with
     survivor compaction) after a warm-up round, with the kernel's launch
     count and the best pose against ground truth; the same round with a
     one-call track_plain; then kernel and plain timed alone on that
     round's inputs;
  5. the static-schedule solve (K1e, solver="schedule"): kernel against
     plain at 1 x all paths and at the H=100 round's paths, and a round
     through the engine with it;
  6. segmented against one launch: the round's paths through the
     segmented tracker and one kernel launch, bit for bit, for both solve
     programs, and the engine round without compaction (one launch)
     beside the main path's;
  7. the TrunRANSAC abort round (abort_chunk=12, H=100): the chunks it ran,
     the time to the pose and the pose against ground truth;
  8. the step variants (predictor rk2 and rk3, corrector_jacobian_reuse
     1 and 2, predictor_handoff at tile 1 and at tile 128, where the
     handoff build's tiled kernel decides it per tile, rk_jacobian_reuse),
     each its own build of the kernel: kernel against plain on the H=10
     round's paths with the plain run's full solves and replays and the
     bound from them (at tile 128 bit for bit, in one launch, whose last
     tile an active copy of path 0 pads, and segmented), an H=100 engine
     round, the segmented tracker alone on the H=100 inputs against
     track_plain over the same segments (at tile 128 also one launch
     timed, with the cluster size, the resident clusters, each launch's
     tiles and the tiled kernel's ptxas line), and an abort round under
     corrector_jacobian_reuse=2;
  9. the evaluation variants: eval_precision "split3_rk2" (the RK stages
     at 2-term bf16 splits) and pair_coef_basis "abc", each a build of its
     own, as in phase 8 and bit for bit against their plain twins, with
     the abc round's real solutions beside the default's; eval_structure
     "gathered" and "merged", which run the default build, through an
     H=100 engine round whose launches are counted and whose paths equal
     the default round's;
 10. K1's phases alone (ops/phases.py, the port of the JAX round's
     microbenchmark kernel in tools/microbench_fused.py): for both solve
     programs, on one hypothesis over the round's 30,700 paths, every
     phase kernel (and the step, hc_track) at one iteration against its
     plain version, bit for bit on every path; then, the launch counts
     from 0, the timed table (PHASE_ITERS iterations, the step
     PHASE_STEP_ITERS): per iteration over the batch, per path-iteration,
     the share of a step, the bound and the share of it reached, blocks per
     SM; the plain versions per iteration; and the step beside phase 4's
     segmented ms over the round's largest step count (a sanity line);
 11. the serving surface, each path's hc_track launches counted from 0:
     (a) a collect_solutions round (view 0, seed 0, H=100), whose per-path
     flags and steps equal phase 4's round, whose candidates, fundamental
     matrices and residual minima are checked, with the unique-solution
     counts in both dedup modes; (b) run_stream over STREAM_VIEWS after
     warmup(), each view's counts and best supports equal to run_round's
     on that view, views/s and per-view latency beside sequential rounds
     over the same views; (c) the stream-abort pipeline
     (stream_abort_chunk=STREAM_CHUNK) over the same views, each view's
     found_pose and best supports equal to an abort round's at
     abort_chunk=STREAM_CHUNK; (d) the command line in subprocesses (H=100
     rounds with --times 2 and a --stream --abort run over 3 views), with
     --output-dir under build/cli_out;
 12. the oracle tracker (ops/tracker.py, backend="xla") and what stands on
     it: (a) the oracle engine's H=100 round on the card beside a
     collecting K1 round of the same inputs (per-flag flip rates,
     converged totals, best supports, x error where both converge,
     track_ms, against the JAX bands: printed, not gated), and the gate:
     the oracle on the card against the oracle on the CPU at H=2 (flags
     within 3.2 % of the paths, x within 1e-3 where both converge on the
     paths that four 1e-7 nudges do not move by 1e-3); (b)
     the CLI's fast cross-check (--hypotheses 2) in a subprocess, whose
     printed counts, supports and exit code must equal the JAX rule
     applied here to the same two rounds (K1's H=2 round and the CPU
     oracle's); (c) monodromy: one leg of the committed roots from the
     start parameters to view 0's first hypothesis with per-path starts and
     TrunPaths off, K1 bit for bit with track_plain; monodromy_solve on K1
     from the first MONO_SEEDS roots (3 loops), each root's residual at
     the start parameters recomputed in float64 numpy, and the roots
     matched to the committed ones; the module's command line in a
     subprocess, its files read back;
 13. P2C and the ablation ladder: (a) the kernel on the P2C coefficient
     plan (ops/p2c.py, TrunPaths off, one launch) against its track_plain
     at H=2, bit for bit; (b) the P2C rung's engine round against the PH
     rung's (both TrunPaths off, one launch) at H=100, per-flag flips
     gated at 3.2 % of the paths, each round's launches counted from 0;
     (c) the CLI's --ablation --hypotheses 100 --times 2 in a subprocess,
     its five rows parsed (track_ms, converged, found, K1 launches); (d)
     the P2C plan's kernel alone on the round's paths (median of 3), the
     PH plan's under the same knobs, and its plain twin, bit for bit, with
     the work it counts for the bound;
 14. hypothesis sharding (parallel/mesh.py) on the one card, the shards
     sharing cuda:0, each on its own stream: (a) the engine's sharded
     default round (num_devices k = 2, 4 and (b) 3, whose H = 100 pads to
     102, over ["cuda:0"] * k) against phase 4's on the real paths, flags
     and steps bit for bit and x bit for bit through a collecting round
     of both, with its launches, track_ms and total_ms; the sharded
     tracker alone on the round's (padded) inputs, bit for bit with one
     launch, median of 3, with each shard's launches; (c) the sharded
     abort round (k = 2, abort_chunk=12) beside phase 7's: chunks run, the
     pose, time to pose, launches; (d) the cross-shard abort on the card:
     shard 0 of 4 gets a hypothesis that targets the start parameters
     (pass ratio 0, imaginary tolerance 1e9, TrunPaths off), whose hit
     must stop the other shards before their budget; (e) both streams
     over two shards against phase 11's, per view, with views/s and
     latency beside phase 11's; (f) two processes in a gloo group over
     tcp://127.0.0.1, each one shard on cuda:0 (this script with
     --shard-worker RANK PORT): each rank's block of H=8 hypotheses bit
     for bit with the unsharded launch's slice, and a hit on rank 1 that
     stops rank 0;
 15. the measurement tools on the card, each in a subprocess that must
     exit 0 (outputs under build/tools_out/): f64_reconcile_torch at H=2
     with the oracle and with K1 as the float32 side, reconcile_stats_torch
     at H=100 (TrunPaths off and on, on K1), accuracy_sweep_torch over the
     3 views (--retries 1 --exhaustive 0, every view found) and
     roofline_torch on phase 10's measured step.
Then a JSON line of per-kernel numbers (one entry per solve program of
hc_track: launches in the engine's round, ms of the segmented tracker that
round runs, ms_one_launch of one launch, plain_ms of track_plain, all on
the round's 30,700 paths; and one per variant, with its segmented
tracker's ms, the plain run over the same segments and plain_paths
(cph128 also with ms_one_launch, its tile, its kernel, the cluster of
its one launch, the resident clusters by size and each segment launch's
tiles, cluster and blocks); the two
structures repeat the reduced entry's numbers with their own launches;
one hc_phase entry per phase and program of phase 10, ms and plain_ms per
iteration over the 30,700 paths, launches in the timed table and
launches_per_round counted in that program's round of phase 4/5; the step's
entry is named hc_track, phase "step", its launches_per_round the round's
hc_track launches; the reduced entry also carries phase 11's launches:
per collecting round, per stream view and per stream-abort chunk;
and phase 12's: per cross-check and per monodromy leg, and the oracle
round's track_ms beside K1's; and phase 13's entry of K1 on the P2C plan,
plan "p2c": its launches in the P2C rung's round, per rung of the CLI's
ladder, ms, the PH plan's ms under the same knobs, plain_ms and bound;
the reduced entry also carries phase 14's launches and times per sharded
round, per shard, of the sharded tracker alone, of the streams and of the two processes),
and as the last line {"ok": true, "device": {...}}.  Needs a CUDA card; exits nonzero without.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import torch

H_ROUND = 100
VIEW, SEED = 0, 0
ABORT_CHUNK = 12
FLIP_FRAC, SUP_FRAC = 0.005, 0.002  # the reference's cross-check bands
REL_TOL = 1e-3                      # x on paths both versions converge
# Phase 10's iterations: fewer than tools/microbench_torch.py's 500 (64
# for the step), to keep the script short.
PHASE_ITERS, PHASE_STEP_ITERS = 100, 32
# Phase 11: the generated data root's 3 views, four times over.
STREAM_VIEWS = [0, 1, 2] * 4
STREAM_CHUNK = 10
# Phase 12: the cross-check's fast tier, monodromy's seeds and loops.
H_CROSS = 2
ORACLE_FLIP_FRAC = 0.032   # tests/test_torch_engine.py's band
PERTURBATIONS = 4          # 1e-7 relative nudges (tests/test_torch_tracker.py)
MONO_SEEDS, MONO_LOOPS = 150, 3
# Phase 13: the P2C plan's bit-for-bit check.
H_P2C = 2
# Phase 15: the float64 reconciliation's hypotheses.
H_TOOLS_F64 = 2
# Phase 14: shards sharing the one card (3 pads H=100 to 102), the
# two-process run's hypotheses and its worker's command-line flag.
DEVICE = "cuda:0"
SHARDS = (2, 3, 4)
H_WORKER = 8
WORKER_FLAG = "--shard-worker"
CLI = "trifocal_pose_estimation_using_improved_gpuhc_torch.cli"
MONODROMY = "trifocal_pose_estimation_using_improved_gpuhc_torch.models.monodromy"
ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "trifocal_pose_estimation_using_improved_gpuhc_torch/csrc/hc_track.cu"
REPLACES = {
    "reduced": "trifocal_pose_estimation_using_improved_gpuhc_tpu/ops/"
               "fused.py:1494",
    "schedule": "trifocal_pose_estimation_using_improved_gpuhc_tpu/ops/"
                "fused.py:873",
}
REPLACES_PHASE = "tools/microbench_fused.py:45"
# The step variants of phase 8 and the branches of the JAX kernel they port.
VARIANTS = {"rk2": dict(predictor="rk2"), "rk3": dict(predictor="rk3"),
            "cjr1": dict(corrector_jacobian_reuse=1),
            "cjr2": dict(corrector_jacobian_reuse=2),
            "cph": dict(predictor_handoff=True, tile=1),
            # The handoff decided per tile of 128 paths (the JAX default),
            # the handoff build's tiled kernel.
            "cph128": dict(predictor_handoff=True, tile=128),
            "rkj": dict(rk_jacobian_reuse=True)}
# The evaluation variants of phase 9: two builds of their own, and two
# structures that run the default build.
EVAL_BUILDS = {"split2": dict(eval_precision="split3_rk2"),
               "abc": dict(pair_coef_basis="abc")}
EVAL_STRUCTURES = {"gathered": dict(eval_structure="gathered"),
                   "merged": dict(eval_structure="merged")}
_JAX_FUSED = "trifocal_pose_estimation_using_improved_gpuhc_tpu/ops/fused.py"
REPLACES_VARIANT = {"rk2": f"{_JAX_FUSED}:1743", "rk3": f"{_JAX_FUSED}:1747",
                    "cjr1": f"{_JAX_FUSED}:1784", "cjr2": f"{_JAX_FUSED}:1784",
                    "cph": f"{_JAX_FUSED}:1703", "cph128": f"{_JAX_FUSED}:1839",
                    "rkj": f"{_JAX_FUSED}:1699",
                    "split2": f"{_JAX_FUSED}:140", "abc": f"{_JAX_FUSED}:743",
                    "gathered": f"{_JAX_FUSED}:783",
                    "merged": f"{_JAX_FUSED}:816"}


def flips(a, b):
    """Per-path flag disagreements in converged, inf-fail and pruned."""
    return int(((a.converged != b.converged) | (a.inf_fail != b.inf_fail)
                | (a.pruned != b.pruned)).sum())


def identical(a, b):
    """Paths whose x (as bits) and step count agree."""
    def bits(x):
        return torch.view_as_real(x).view(torch.int32).flatten(1)

    same = (bits(a.x) == bits(b.x)).all(dim=1) & (a.num_steps == b.num_steps)
    return int(same.sum())


def x_errors(a, b):
    """(max abs, relative) x error on the paths both versions converge."""
    both = a.converged & b.converged
    if not bool(both.any()):
        raise AssertionError("no path converged in both versions")
    d = (a.x[both] - b.x[both]).abs().max().item()
    return d, d / max(b.x[both].abs().max().item(), 1.0)


def timed(fn):
    """(result, ms) of fn() on the current stream, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tile_geometry(_kernels, fn):
    """[(tiles, cluster, blocks)] of each launch of the tiled tracker in
    fn(), as _kernels.tile_launch chose them."""
    chosen, pick = [], _kernels.tile_launch

    def recording(n_paths, tile, *args, **kw):
        cluster, grid = pick(n_paths, tile, *args, **kw)
        chosen.append((-(-n_paths // tile), cluster, grid))
        return cluster, grid

    _kernels.tile_launch = recording
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        _kernels.tile_launch = pick
    return chosen


def ptxas_lines(log):
    """{kernel: ptxas's resource lines (registers, shared memory, spills)}
    of one build's log; a phase kernel is named hc_phase_kernel<phase>,
    the handoff build's tiled tracker hc_track_tile_kernel."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops._kernels import (
        PHASES,
    )

    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"hc_phase_kernelILi(\d+)E", line)
            fn = (f"hc_phase_kernel<{PHASES[int(m.group(1))]}>" if m
                  else "hc_track_kernel" if "hc_track_kernel" in line
                  else "hc_track_tile_kernel"
                  if "hc_track_tile_kernel" in line
                  else "solve_replay_kernel")
            out[fn] = []
        elif fn and ("registers" in line or "spill" in line):
            out[fn].append(line.split(":", 1)[-1].strip())
    return out


def serving(cfg, engine, view, rr, round_line, eng, _kernels):
    """Phase 11 (see the module docstring); returns the launch counts for
    the reduced entry of the kernels line, and the streams' (results,
    views/s) for phase 14."""
    import shutil

    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        evaluation as evl,
    )

    def counted(fn):
        _kernels.hc_track.launches = 0
        out = fn()
        return out, _kernels.hc_track.launches

    # (a) A collecting round against phase 4's round on the same inputs.
    rc, launches_c = counted(lambda: engine.run_round(
        view, SEED, H_ROUND, collect_solutions=True))
    round_line(f"collecting round H={H_ROUND}", rc, launches_c)
    assert launches_c > 0, "the collecting round did not launch the kernel"
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert (getattr(rc, f) == getattr(rr, f)).all(), f
    sols, rcfg = rc.solutions, cfg.ransac
    cand = (sols.converged
            & (np.abs(sols.x[:, 24:30].imag) < rcfg.imag_part_tol).all(axis=1)
            & (sols.x[:, 0:8].real >= 0).all(axis=1))
    n_cand = int(cand.sum())
    assert rc.num_candidates == n_cand == rr.num_candidates, (
        rc.num_candidates, n_cand, rr.num_candidates)
    for f in (rc.cand_f21, rc.cand_f31):
        assert f.shape == (n_cand, 3, 3) and np.isfinite(f).all(), f.shape
    mr, pe = rc.min_residuals, rc.pose_errors
    for a, b in zip(dataclasses.astuple(mr), dataclasses.astuple(pe)):
        assert a <= b, (mr, pe)
    tol = rcfg.duplicate_sol_tol
    batch = evl.find_unique_solutions(sols.x, sols.converged, tol=tol)
    ref = evl.find_unique_solutions_reference(
        sols.x, sols.converged, engine.problem.num_tracks, tol=tol)
    print(f"collecting round: {n_cand} candidates, F matrices "
          f"{rc.cand_f21.shape} finite; min residuals rot ({mr.rot21:.3e}, "
          f"{mr.rot31:.3e}) transl ({mr.transl21:.3e}, {mr.transl31:.3e}), "
          f"any within GT {rc.any_within_gt}; unique converged solutions: "
          f"batch {batch.size}, reference {ref.size} of "
          f"{int(sols.converged.sum())}; actual-solution steps "
          f"{rc.actual_sol_steps.tolist()}", flush=True)

    def stream_phase(label, e, seq_round):
        """Sequential rounds over STREAM_VIEWS (the per-view reference and
        the rate to beat), then the stream with its launches counted."""
        t0 = time.perf_counter()
        seq = [seq_round(e.load_view(vi)) for vi in STREAM_VIEWS]
        seq_s = time.perf_counter() - t0
        (results, vps), launches = counted(
            lambda: e.run_stream(STREAM_VIEWS, H_ROUND, SEED))
        assert launches > 0, f"the {label} did not launch the kernel"
        lat = [r.track_ms for r in results]
        print(f"{label} over {len(STREAM_VIEWS)} views: {vps:.3f} views/s, "
              f"per-view latency mean {sum(lat) / len(lat):.3f} ms, max "
              f"{max(lat):.3f} ms; launches {launches}; sequential "
              f"run_round over the same views {len(seq) / seq_s:.3f} views/s "
              f"(1000 / mean total_ms "
              f"{1000 / (sum(r.total_ms for r in seq) / len(seq)):.3f})",
              flush=True)
        return seq, results, launches, vps

    # (b) The stream, against run_round per view.
    engine.warmup(H_ROUND)
    seq, results, launches_s, vps_s = stream_phase(
        "run_stream", engine, lambda v: engine.run_round(v, SEED, H_ROUND))
    for vi, r, q in zip(STREAM_VIEWS, results, seq):
        got = (*dataclasses.astuple(r.stats)[:3], r.num_candidates,
               r.best_support21, r.best_support31)
        want = (*dataclasses.astuple(q.stats)[:3], q.num_candidates,
                q.best_support21, q.best_support31)
        assert got == want, (vi, got, want)
        assert r.found_pose == q.found_pose, vi
    print(f"run_stream: every view's counts and best supports equal "
          f"run_round's; found {sum(r.found_pose for r in results)}/"
          f"{len(results)}", flush=True)

    # (c) The stream-abort pipeline, against the abort round per view.
    cfg_sa = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=STREAM_CHUNK,
        stream_abort_chunk=STREAM_CHUNK))
    engine_sa = eng.TrifocalPoseEngine(cfg_sa)
    engine_sa.warmup(H_ROUND)
    seq_a, results_a, launches_a, vps_a = stream_phase(
        f"stream-abort (chunk {STREAM_CHUNK})", engine_sa,
        lambda v: engine_sa.run_round(v, SEED, H_ROUND))
    for vi, r, q in zip(STREAM_VIEWS, results_a, seq_a):
        got = (r.found_pose, r.best_support21, r.best_support31)
        want = (q.found_pose, q.best_support21, q.best_support31)
        assert got == want, (vi, got, want)
    chunks = sum(r.chunks_run for r in results_a)
    print(f"stream-abort: every view's found_pose and best supports equal "
          f"the abort round's; chunks run {chunks} (abort rounds "
          f"{sum(q.chunks_run for q in seq_a)}), launches per chunk "
          f"{launches_a / chunks:.2f}", flush=True)

    # (d) The command line, in subprocesses, writing under build/cli_out.
    env = dict(os.environ, PYTHONPATH=ROOT)
    for name, flags in (("rounds", ["--views", "3", "--hypotheses",
                                    str(H_ROUND), "--times", "2"]),
                        ("stream", ["--stream", "--abort", "--views", "3"])):
        out = os.path.join(ROOT, "build", "cli_out", name)
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", CLI, *flags, "--output-dir", out], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            print(f"cli {name}| {line}", flush=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        summary = ("[stream] 3 views at" if name == "stream"
                   else " - [Average Computation Time]")
        assert summary in proc.stdout, name
        m = re.search(r"hc_track kernel launches after the warm-up round: "
                      r"(\d+) on cuda", proc.stdout)
        assert m and int(m.group(1)) > 0, name
        files = sorted(os.listdir(out))
        want = (["GPU_Sols_Statistics.txt"] if name == "stream" else
                ["GPUHC_Steps_of_Actual_Solutions.txt",
                 "GPU_Converged_HC_tracks.txt", "GPU_Sols_Statistics.txt",
                 "GPU_Timings.txt"])
        assert files == want and all(
            os.path.getsize(os.path.join(out, f)) for f in files), files
        print(f"cli {name}: rc 0 in {secs:.1f} s, {m.group(1)} hc_track "
              f"launches after its warm-up, files {files} in {out}",
              flush=True)
    return dict(launches_collecting_round=launches_c,
                launches_stream=launches_s,
                launches_per_stream_view=launches_s / len(STREAM_VIEWS),
                launches_stream_abort=launches_a,
                launches_per_abort_chunk=launches_a / chunks), dict(
        plain=(results, vps_s), abort=(results_a, vps_a))


def h_residual(problem, x, p):
    """max_e |H_e(x, p)| per row, in float64 numpy: eval_H_direct's sum
    over the dHdt table's terms."""
    import numpy as np

    tbl = np.asarray(problem.ht_table)
    xp = np.concatenate([x.astype(np.complex128),
                         np.ones((len(x), 1), np.complex128)], axis=1)
    p = p.astype(np.complex128)
    c = tbl[:, 0, :].astype(np.float64)
    h = (c * p[tbl[:, 1, :]] * p[tbl[:, 2, :]] * xp[:, tbl[:, 3, :]]
         * xp[:, tbl[:, 4, :]] * xp[:, tbl[:, 5, :]]).sum(axis=1)
    return np.abs(h).max(axis=1)


def oracle_rounds(cfg, engine, view, round_line, eng, _kernels):
    """Phase 12 (a) (see the module docstring); returns the numbers for the
    reduced entry of the kernels line and the CPU oracle's H_CROSS round."""
    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        ransac,
        tracker,
    )

    T = engine.problem.num_tracks
    n = H_ROUND * T
    cfg_x = dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc,
                                                            backend="xla"))

    # The oracle engine at H=100 beside K1's collecting round of the same
    # inputs.  The oracle never launches the kernel.
    engine_x = eng.TrifocalPoseEngine(cfg_x)
    assert engine_x.device == engine.device, engine_x.device
    engine_x.run_round(view, SEED, H_CROSS)  # warm-up
    _kernels.hc_track.launches = 0
    rx = engine_x.run_round(view, SEED, H_ROUND, collect_solutions=True)
    assert _kernels.hc_track.launches == 0, _kernels.hc_track.launches
    round_line(f"oracle round H={H_ROUND} (backend xla, on the card)", rx, 0)
    rk = engine.run_round(view, SEED, H_ROUND, collect_solutions=True)
    ks, xs = rk.solutions, rx.solutions
    rates = {f: int((getattr(ks, f) != getattr(xs, f)).sum()) / n
             for f in ("converged", "inf_fail", "pruned")}
    both = ks.converged & xs.converged
    scale = np.maximum(np.abs(xs.x[both]).max(axis=1), 1.0)
    x_rel = float((np.abs(ks.x[both] - xs.x[both]).max(axis=1)
                   / scale).max())
    x_bad = int(((np.abs(ks.x[both] - xs.x[both]).max(axis=1) / scale)
                 >= REL_TOL).sum())
    sup_tol = max(5, int(SUP_FRAC * rk.num_edgels))
    print(f"oracle vs K1 at H={H_ROUND}: flag flip rates "
          + ", ".join(f"{f} {v:.5f}" for f, v in rates.items())
          + f" (JAX band {FLIP_FRAC}); converged {rx.stats.num_converged} vs "
          f"{rk.stats.num_converged}; best support "
          f"{rx.best_support21}/{rx.best_support31} vs "
          f"{rk.best_support21}/{rk.best_support31} (delta "
          f"{abs(rx.best_support21 - rk.best_support21)}/"
          f"{abs(rx.best_support31 - rk.best_support31)}, JAX band "
          f"{sup_tol}); x rel err on {int(both.sum())} paths both converge: "
          f"max {x_rel:.3e}, {x_bad} at or above {REL_TOL}; track_ms oracle "
          f"{rx.track_ms:.3f}, K1 {rk.track_ms:.3f}", flush=True)

    # The gate: the oracle on the card against itself on the CPU at H=2.
    # Some converged endpoints of this problem are not determined to 1e-3
    # in float32: on the CPU alone a 1e-7 relative nudge of the inputs
    # moves one H=2 path's converged x by 35-48 % and a few others by more
    # than 1e-3.  So x is held to REL_TOL on the paths both converge whose
    # x no PERTURBATIONS nudges move by REL_TOL (on the card, base and
    # nudged copies in one batch), as tests/test_torch_tracker.py holds x
    # on its calm paths; the flags on every path.
    t0 = time.perf_counter()
    engine_cpu = eng.TrifocalPoseEngine(cfg_x, device="cpu")
    rcpu = engine_cpu.run_round(view, SEED, H_CROSS, collect_solutions=True)
    cpu_s = time.perf_counter() - t0
    m = H_CROSS * T
    s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0],
                                     H_CROSS)
    tgt = np.repeat(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s), T, axis=0)
    x0 = np.tile(np.asarray(engine.problem.start_sols), (H_CROSS, 1))
    runs = [(x0, tgt)] + [tuple(
        (a * (1 + 1e-7 * np.random.default_rng(k).standard_normal(
            a.shape))).astype(a.dtype) for a in (x0, tgt))
        for k in range(PERTURBATIONS)]
    track = tracker.make_track_fn(engine.problem, cfg_x.hc)
    out, card_ms = timed(lambda: track(*(
        torch.as_tensor(np.concatenate(parts), device=engine.device)
        for parts in zip(*runs))))
    gx = out.x.cpu().numpy().reshape(len(runs), m, -1)
    g = {f: getattr(out, f).cpu().numpy().reshape(len(runs), m)[0]
         for f in ("converged", "inf_fail", "pruned")}
    scale = np.maximum(np.abs(gx[0]).max(axis=1), 1.0)
    calm = (np.abs(gx[1:] - gx[0]).max(axis=2) / scale < REL_TOL).all(
        axis=0)
    c = rcpu.solutions
    flips_x = {f: int((g[f] != getattr(c, f)).sum()) for f in g}
    both = g["converged"] & c.converged
    err = np.abs(gx[0] - c.x).max(axis=1) / np.maximum(
        np.abs(c.x).max(axis=1), 1.0)
    rel_x = float(err[both & calm].max())
    print(f"oracle card vs CPU at H={H_CROSS}: flag flips {flips_x} of {m} "
          f"(band {int(ORACLE_FLIP_FRAC * m)}); converged "
          f"{g['converged'].sum()}/{c.converged.sum()}; x rel err "
          f"{rel_x:.3e} on the {int((both & calm).sum())} calm paths both "
          f"converge ({int((both & ~calm).sum())} moved by the nudges, "
          f"worst over all {int(both.sum())} both converge "
          f"{float(err[both].max()):.3e}); CPU round {cpu_s:.1f} s "
          f"(track_ms {rcpu.track_ms:.3f}), card {card_ms:.3f} ms for "
          f"{len(runs)} x {m} paths", flush=True)
    assert max(flips_x.values()) <= int(ORACLE_FLIP_FRAC * m), flips_x
    assert (both & calm).sum() >= 0.75 * both.sum(), (both & calm).sum()
    assert rel_x < REL_TOL, rel_x
    return dict(oracle_round_track_ms=rx.track_ms,
                oracle_round_total_ms=rx.total_ms,
                k1_collecting_round_track_ms=rk.track_ms), rcpu


def cross_check(engine, view, rcpu) -> int:
    """Phase 12 (b): the CLI's fast cross-check in a subprocess, against
    the JAX rule applied here to K1's H_CROSS round and the CPU oracle's
    (rcpu); returns the kernel's launches in the cross-check."""
    import shutil

    m = H_CROSS * engine.problem.num_tracks
    c = rcpu.solutions
    rg = engine.run_round(view, SEED, H_CROSS, collect_solutions=True)
    dis = int((rg.solutions.converged != c.converged).sum())
    tol_paths = max(3, int(FLIP_FRAC * m))
    cc_sup = max(5, int(SUP_FRAC * rcpu.num_edgels))
    ok = (dis <= tol_paths
          and abs(rg.stats.num_converged - rcpu.stats.num_converged)
          <= tol_paths
          and abs(rg.best_support21 - rcpu.best_support21) <= cc_sup
          and abs(rg.best_support31 - rcpu.best_support31) <= cc_sup)
    want = (f"[cross-check] converged-flag disagreements: {dis}/{m} (tol "
            f"{tol_paths}); conv totals {rg.stats.num_converged} vs "
            f"{rcpu.stats.num_converged} (tol {tol_paths}); support "
            f"{rg.best_support21}/{rg.best_support31} vs "
            f"{rcpu.best_support21}/{rcpu.best_support31} (tol {cc_sup}) -> "
            f"{'AGREE' if ok else 'MISMATCH'}")
    out = os.path.join(ROOT, "build", "cli_out", "cross_check")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", CLI, "--hypotheses", str(H_CROSS),
         "--cross-check", "--output-dir", out], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    cc_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"cli cross-check| {line}", flush=True)
    assert want in proc.stdout.splitlines(), (want, proc.stderr[-4000:])
    assert proc.returncode == (0 if ok else 1), (proc.returncode,
                                                 proc.stderr[-4000:])
    mm = re.search(r"\[cross-check\] hc_track kernel launches in the "
                   r"\S+ round: (\d+)", proc.stdout)
    assert mm and int(mm.group(1)) > 0, "the cross-check did not launch"
    launches_cc = int(mm.group(1))
    files = sorted(os.listdir(out))
    assert {"CPU_Sols_Statistics.txt",
            "CPU_Converged_HC_tracks.txt"} <= set(files), files
    print(f"cli cross-check: rc {proc.returncode} in {cc_s:.1f} s, verdict "
          f"{'AGREE' if ok else 'MISMATCH'} (the JAX rule on the same two "
          f"rounds gives the same line), {launches_cc} hc_track launches in "
          f"its device round, files {files}", flush=True)
    return launches_cc


def monodromy_checks(cfg, engine, view, _kernels) -> float:
    """Phase 12 (c) (see the module docstring); returns the kernel's
    launches per monodromy leg."""
    import shutil

    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
        monodromy,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        data_io,
    )

    problem = engine.problem
    T = problem.num_tracks
    # One leg, K1 against track_plain, per-path starts and TrunPaths off.
    hc_m = dataclasses.replace(cfg.hc, truncate_paths=False)
    dev = engine.device
    tgt1 = torch.as_tensor(ransac_target(view), device=dev).expand(T, -1)
    tgt1 = tgt1.contiguous()
    diff1 = tgt1 - torch.as_tensor(problem.start_params, device=dev)
    x_roots = torch.as_tensor(problem.start_sols, device=dev)
    _kernels.hc_track.launches = 0
    leg_k = fused.make_track_fn(problem, hc_m, dynamic_start=True)(
        x_roots, tgt1, diff1)
    assert _kernels.hc_track.launches == 1
    leg_p = fused.make_plain_track_fn(problem, hc_m, dynamic_start=True)(
        x_roots, tgt1, diff1)
    same = identical(leg_k, leg_p)
    print(f"monodromy leg ({T} committed roots -> view {VIEW}'s first "
          f"hypothesis, dynamic start, TrunPaths off): K1 vs plain "
          f"bit-identical paths {same}/{T}, flag flips {flips(leg_k, leg_p)}"
          f", converged {int(leg_k.converged.sum())}, pruned "
          f"{int(leg_k.pruned.sum())}", flush=True)
    assert same == T and not bool(leg_k.pruned.any()), same

    seeds = np.asarray(problem.start_sols)[:MONO_SEEDS]
    _kernels.hc_track.launches = 0
    t0 = time.perf_counter()
    res = monodromy.monodromy_solve(problem, cfg.hc, seed_sols=seeds,
                                    max_loops=MONO_LOOPS, rng_seed=0)
    mono_ms = (time.perf_counter() - t0) * 1e3
    launches_m = _kernels.hc_track.launches
    legs = 3 * res.loops_run
    resid = h_residual(problem, res.solutions, np.asarray(
        problem.start_params))
    ship = np.asarray(problem.start_sols)
    dist = np.array([np.abs(ship - s[None]).max(axis=1).min()
                     for s in res.solutions])
    matched = int((dist < 1e-2).sum())
    print(f"monodromy_solve on K1 from {MONO_SEEDS} roots, {MONO_LOOPS} "
          f"loops, rng_seed 0: history {res.history}, {res.loops_run} loops "
          f"in {mono_ms:.3f} ms; {launches_m} hc_track launches "
          f"({launches_m / legs:.2f} per leg); residual at the start "
          f"parameters (float64) max {resid.max():.3e}; {matched} of "
          f"{len(res.solutions)} roots match a committed root within 1e-2 "
          f"(unmatched: {len(res.solutions) - matched}, nearest "
          f"{dist.max():.3e})", flush=True)
    assert launches_m == legs, (launches_m, legs)
    assert res.history[-1] >= MONO_SEEDS
    assert float(resid.max()) < 1e-3, resid.max()

    out_m = os.path.join(ROOT, "build", "monodromy_out")
    shutil.rmtree(out_m, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", MONODROMY, "--seeds", str(MONO_SEEDS),
         "--max-loops", "2", "--out-dir", out_m], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    mono_cli_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"monodromy cli| {line}", flush=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mm = re.search(r"solutions: (\d+) / ", proc.stdout)
    assert mm, proc.stdout
    sols = data_io._load_complex(os.path.join(out_m, "start_sols.txt"))
    params = data_io._load_complex(os.path.join(out_m, "start_params.txt"))
    assert sols.shape == (int(mm.group(1)) * problem.num_vars,), sols.shape
    assert np.array_equal(params, problem.start_params[:-1].astype(
        np.complex64))
    assert np.isfinite(sols).all()
    print(f"monodromy cli: rc 0 in {mono_cli_s:.1f} s, {mm.group(1)} roots "
          f"read back from {out_m}", flush=True)
    return launches_m / legs


def p2c_ladder(cfg, problem, view, inputs, round_line, eng, _kernels,
               blocks_per_sm) -> dict:
    """Phase 13 (see the module docstring); returns the kernels line's
    entry of K1 on the P2C plan."""
    import shutil

    from trifocal_pose_estimation_using_improved_gpuhc_torch.cli import (
        ABLATION_RUNGS,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        fused,
        p2c,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops.bound import (
        tracker_bound,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        problem_dir,
    )

    off = dict(truncate_paths=False, compact_survivors=False)
    hc_p = dataclasses.replace(cfg.hc, backend="p2c", **off)
    t0 = time.perf_counter()
    tables = p2c.derive_coeff_map(problem, problem_dir(cfg))
    kernel = p2c.make_fused_p2c_track_fn(problem, tables, hc_p)
    plain = p2c.make_fused_p2c_track_fn(problem, tables, hc_p, plain=True)
    c = kernel.constants
    print(f"p2c: {tables.n_coeffs} coefficient slots, map "
          f"{tables.coeff_map.shape} derived in "
          f"{time.perf_counter() - t0:.2f} s on the CPU; plan Q'={c.q}, "
          f"{len(c.monomials())} monomials, {c.kernel_plan().size} ints, "
          f"solver {c.solver}", flush=True)

    # (a) K1 on the P2C plan against its track_plain, bit for bit.
    x2, tgt2 = inputs(H_P2C)
    m2 = x2.shape[0]
    _kernels.hc_track.launches = 0
    rk = kernel(x2, tgt2)
    launches_a = _kernels.hc_track.launches
    rp = plain(x2, tgt2)
    torch.cuda.synchronize()
    same, nf = identical(rk, rp), flips(rk, rp)
    print(f"p2c kernel vs plain at H={H_P2C}: bit-identical paths {same}/{m2}"
          f", flag flips {nf}, converged {int(rk.converged.sum())}, pruned "
          f"{int(rk.pruned.sum())}, launches {launches_a}", flush=True)
    assert launches_a == 1 and same == m2 and nf == 0, (launches_a, same, nf)

    # (b) The P2C rung against the PH rung, both TrunPaths off in one launch.
    rungs = {}
    for name, knobs in (("p2c", dict(off, backend="p2c")), ("ph", off)):
        e = eng.TrifocalPoseEngine(dataclasses.replace(
            cfg, hc=dataclasses.replace(cfg.hc, **knobs)))
        e.run_round(view, SEED, H_ROUND)  # warm-up
        _kernels.hc_track.launches = 0
        rr = e.run_round(view, SEED, H_ROUND)
        launches = _kernels.hc_track.launches
        round_line(f"{name} rung H={H_ROUND} (TrunPaths off, one launch)", rr,
                   launches)
        assert launches == 1, (name, launches)
        assert not rr.pruned.any(), name
        rungs[name] = (rr, launches)
    a, b = rungs["p2c"][0], rungs["ph"][0]
    n = a.converged.shape[0]
    band = int(ORACLE_FLIP_FRAC * n)
    per = {f: int((getattr(a, f) != getattr(b, f)).sum())
           for f in ("converged", "inf_fail", "pruned")}
    print(f"p2c rung vs ph rung on {n} paths: flag flips "
          + ", ".join(f"{f} {v} ({100 * v / n:.3f} %)" for f, v in per.items())
          + f" (band {band}); converged {a.stats.num_converged} / "
          f"{b.stats.num_converged}; step counts differ on "
          f"{int((a.num_steps != b.num_steps).sum())} paths; best support "
          f"{a.best_support21}/{a.best_support31} / {b.best_support21}/"
          f"{b.best_support31}; track_ms {a.track_ms:.3f} / {b.track_ms:.3f}",
          flush=True)
    assert all(v <= band for v in per.values()), per
    assert abs(a.stats.num_converged - b.stats.num_converged) <= band

    # (c) The command line's ladder in a subprocess.
    out = os.path.join(ROOT, "build", "cli_out", "ablation")
    shutil.rmtree(out, ignore_errors=True)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", CLI, "--ablation", "--hypotheses",
         str(H_ROUND), "--times", "2", "--output-dir", out], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print(f"cli ablation| {line}", flush=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = re.findall(r"^(.{44}) +([0-9.]+) +(\d+) +(True|False)\n - hc_track "
                      r"kernel launches in 2 timed rounds: (\d+) on cuda",
                      proc.stdout, re.M)
    assert [r[0].rstrip() for r in rows] == [r[0] for r in ABLATION_RUNGS], \
        rows
    ladder = [dict(rung=name.rstrip(), track_ms=float(ms), converged=int(cv),
                   found=found == "True", launches=int(k))
              for name, ms, cv, found, k in rows]
    for r in ladder:
        print(f"ladder: {r['rung']:44s} track_ms {r['track_ms']:9.1f}, "
              f"converged {r['converged']:6d}, found {r['found']}, K1 "
              f"launches {r['launches']} in 2 rounds", flush=True)
        assert r["launches"] > 0, r
    assert ladder[0]["launches"] == 2, ladder[0]
    print(f"cli ablation: rc 0 in {time.perf_counter() - t1:.1f} s",
          flush=True)

    # (d) K1 on the P2C plan alone on the round's paths (median of 3),
    # beside the PH plan under the same knobs, and its plain twin, which
    # counts the work for the bound.
    x0, tgt = inputs(H_ROUND)
    ph_kernel = fused.make_track_fn(problem, dataclasses.replace(
        cfg.hc, **off))
    runs, ph_runs = [], []
    for _ in range(3):
        runs.append(timed(lambda: kernel(x0, tgt)))
        ph_runs.append(timed(lambda: ph_kernel(x0, tgt))[1])
    ms, ph_ms = sorted(t for _, t in runs)[1], sorted(ph_runs)[1]
    work = {}
    rp, plain_ms = timed(lambda: plain(x0, tgt, work=work))
    rk = runs[0][0]
    same = identical(rk, rp)
    abs_err, _ = x_errors(rk, rp)
    bound_ms, bound_by = tracker_bound(c, work, n)
    print(f"p2c kernel alone {ms:.3f} ms (median of 3; the PH plan, same "
          f"knobs, {ph_ms:.3f} ms), plain {plain_ms:.3f} ms on {n} paths; "
          f"bit-identical paths {same}/{n}; work {work['steps']} path-steps, "
          f"{work['newton']} corrector iterations, {work['solves']} full "
          f"solves; bound {bound_ms:.3f} ms ({bound_by}, "
          f"{100 * bound_ms / ms:.3f} %)", flush=True)
    assert same == n, same
    return dict(program="reduced", plan="p2c", blocks_per_sm=blocks_per_sm,
                launches=rungs["p2c"][1],
                launches_per_rung={r["rung"]: r["launches"] / 2
                                   for r in ladder},
                ladder=ladder, max_abs_err=abs_err, ms=ms, ph_plan_ms=ph_ms,
                plain_ms=plain_ms, plain_paths=n, bound_ms=bound_ms,
                bound_by=bound_by,
                note="K1 on the P2C coefficient plan, TrunPaths off, one "
                     "launch (the ladder's first rung); ms and ph_plan_ms "
                     "include the pair coefficients, plain_ms is "
                     "track_plain on the card")


def sharding(cfg, engine, view, rr, ra, streams, inputs, round_line, eng,
             _kernels) -> dict:
    """Phase 14 (see the module docstring); returns the numbers for the
    reduced entry of the kernels line."""
    import socket

    import numpy as np

    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
    from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
        mesh as pmesh,
    )

    problem, hc = engine.problem, cfg.hc
    T = problem.num_tracks
    n = H_ROUND * T
    out = {}

    def same_flags(label, r, ref, paths):
        for f in ("converged", "inf_fail", "pruned", "num_steps"):
            got, want = getattr(r, f)[:paths], getattr(ref, f)[:paths]
            assert (got == want).all(), (label, f)

    def sharded_engine(k, c=cfg):
        e = eng.TrifocalPoseEngine(dataclasses.replace(c, num_devices=k),
                                   device=[DEVICE] * k)
        assert e.mesh == [torch.device(DEVICE)] * k, e.mesh
        return e

    def counted(fn):
        _kernels.hc_track.launches = 0
        res = fn()
        return res, _kernels.hc_track.launches

    # (a) Sharded default rounds, each against phase 4's round path for
    # path (x from a collecting round of both), and the sharded tracker
    # alone against one launch on the round's inputs,
    # padded to whole shards; (b) is k = 3, whose H = 100 pads to 102.
    ref_x = engine.run_round(view, SEED, H_ROUND,
                             collect_solutions=True).solutions.x
    for k in SHARDS:
        hp = -(-H_ROUND // k) * k
        x0, tgt = inputs(hp)
        one = fused.make_track_fn(problem, hc)(x0, tgt)
        e = sharded_engine(k)
        e.run_round(view, SEED, H_ROUND)  # warm-up
        r, launches = counted(lambda: e.run_round(view, SEED, H_ROUND))
        round_line(f"sharded round k={k} on {DEVICE} (segmented, "
                   f"compaction; H={H_ROUND} padded to {hp})", r, launches)
        assert r.stats.num_paths == n
        same_flags(f"k={k}", r, rr, n)
        rx = e.run_round(view, SEED, H_ROUND, collect_solutions=True)
        assert np.array_equal(rx.solutions.x.view(np.int32),
                              ref_x.view(np.int32)), k
        track = pmesh.make_sharded_track_fn(problem, hc, [DEVICE] * k)
        times = []
        for _ in range(3):
            run = track.begin(x0, tgt)

            def drive():
                run.advance()
                while run.keep():
                    run.advance()
                return run.result()

            res, t = timed(drive)
            assert identical(res.track, one) == hp * T and flips(
                res.track, one) == 0, k
            per_shard = [s.launches for s in run.runs]
            assert all(per_shard), (k, per_shard)
            times.append(t)
        med = sorted(times)[1]
        print(f"sharded round k={k}: flags, steps and x bit for bit with "
              f"phase 4's round on all {n} real paths; track_ms "
              f"{r.track_ms:.3f} (phase 4: {rr.track_ms:.3f}), total_ms "
              f"{r.total_ms:.3f} (phase 4: {rr.total_ms:.3f}), launches "
              f"{launches}; tracker alone on {hp * T} paths, bit for bit "
              f"with one launch, median of 3: {med:.3f} ms, launches per "
              f"shard {per_shard}", flush=True)
        out[f"sharded_k{k}"] = dict(
            launches_per_round=launches, track_ms=r.track_ms,
            total_ms=r.total_ms, launches_per_shard=per_shard,
            ms_tracker=med)

    # (c) The sharded abort round beside phase 7's.
    cfg_a = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=ABORT_CHUNK))
    ea = sharded_engine(2, cfg_a)
    ea.run_round(view, SEED, H_ROUND)  # warm-up
    rab, launches_a = counted(lambda: ea.run_round(view, SEED, H_ROUND))
    print(f"sharded abort round k=2, chunk {ABORT_CHUNK}: chunks run "
          f"{rab.chunks_run} (phase 7: {ra.chunks_run}), found_pose "
          f"{rab.found_pose}, best support {rab.best_support21}/"
          f"{rab.best_support31}, launches {launches_a}, time to pose "
          f"{rab.track_ms:.3f} ms (phase 7: {ra.track_ms:.3f}), total_ms "
          f"{rab.total_ms:.3f}", flush=True)
    assert rab.found_pose and rab.pose_errors.within(cfg.ransac)
    assert rab.chunks_run == ra.chunks_run and launches_a > 0
    out["sharded_abort_k2"] = dict(launches_per_round=launches_a,
                                   time_to_pose_ms=rab.track_ms,
                                   chunks_run=rab.chunks_run)

    # (d) The cross-shard abort on the card: shard 0's hypothesis targets
    # the start parameters; its hit must stop the other shards.
    k = max(SHARDS)
    xd, td = inputs(k)
    td[:T] = torch.as_tensor(problem.start_params, device=td.device)
    hc_d = dataclasses.replace(hc, segment_steps=2, init_delta_t=0.5,
                               truncate_paths=False)
    rc_d = dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                               pass_inlier_support_ratio=0.0,
                               imag_part_tol=1e9)
    edgels = torch.as_tensor(view.edge_locations[:64], device=td.device)
    track_d = pmesh.make_sharded_track_fn(problem, hc_d, [DEVICE] * k,
                                          ransac_cfg=rc_d)
    rd, launches_d = counted(lambda: track_d(
        xd, td, edgels, torch.eye(3, device=td.device), 64))
    others = rd.track.num_steps[T:]
    print(f"cross-shard abort k={k}: found {rd.found}, found_path "
          f"{rd.found_path} (shard 0 holds 0..{T - 1}), other shards' "
          f"steps at most {int(others.max())} of {hc_d.max_steps + 1}, "
          f"converged {int(rd.track.converged[T:].sum())}, launches "
          f"{launches_d}", flush=True)
    assert rd.found and 0 <= rd.found_path < T, rd.found_path
    assert int(others.max()) < hc_d.max_steps
    assert not bool(rd.track.converged[T:].any())

    # (e) Both streams over two shards, against phase 11's streams.
    def stream(label, e, ref):
        e.warmup(H_ROUND)
        (res, vps), launches = counted(
            lambda: e.run_stream(STREAM_VIEWS, H_ROUND, SEED))
        ref_res, ref_vps = ref
        for vi, a, b in zip(STREAM_VIEWS, res, ref_res):
            got = (*dataclasses.astuple(a.stats)[:3], a.num_candidates,
                   a.best_support21, a.best_support31, a.found_pose,
                   a.chunks_run)
            want = (*dataclasses.astuple(b.stats)[:3], b.num_candidates,
                    b.best_support21, b.best_support31, b.found_pose,
                    b.chunks_run)
            assert got == want, (label, vi, got, want)
        lat = [r.track_ms for r in res]
        ref_lat = [r.track_ms for r in ref_res]
        print(f"sharded {label} k=2 over {len(STREAM_VIEWS)} views: every "
              f"view's counts, supports and chunks equal phase 11's; "
              f"{vps:.3f} views/s (phase 11: {ref_vps:.3f}), latency mean "
              f"{sum(lat) / len(lat):.3f} ms (phase 11: "
              f"{sum(ref_lat) / len(ref_lat):.3f}), launches {launches}",
              flush=True)
        assert launches > 0
        return dict(views_per_s=vps, latency_ms=sum(lat) / len(lat),
                    launches=launches)

    out["sharded_stream_k2"] = stream("run_stream", sharded_engine(2),
                                      streams["plain"])
    cfg_sa = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=STREAM_CHUNK,
        stream_abort_chunk=STREAM_CHUNK))
    out["sharded_stream_abort_k2"] = stream(
        f"stream-abort (chunk {STREAM_CHUNK})", sharded_engine(2, cfg_sa),
        streams["abort"])

    # (f) Two processes on the one card, gloo on the host.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), WORKER_FLAG,
         str(rank), str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = []
    for rank, (p, text) in enumerate(zip(procs, texts)):
        for line in text.splitlines():
            print(f"rank {rank}| {line}", flush=True)
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}"
        reports.append(json.loads(text.strip().splitlines()[-1]))
    r0, r1 = reports
    for r in reports:
        assert r["identical"] == r["paths"] and r["launches"] > 0, r
        lo, hi = r["rank1_block"]
        assert r["found"] and lo <= r["found_path"] < hi, r
    assert r0["own_converged"] == 0 and r0["own_max_steps"] < r0["budget"], r0
    print(f"two processes (gloo, one shard each on {DEVICE}): each rank's "
          f"{r0['paths']} paths bit for bit with the unsharded launch's "
          f"slice ({r0['launches']} and {r1['launches']} launches); rank 1's "
          f"hit reached rank 0 (found_path {r0['found_path']}, rank 0 "
          f"stopped at {r0['own_max_steps']} of {r0['budget'] + 1} steps)",
          flush=True)
    out["two_processes"] = dict(launches=[r0["launches"], r1["launches"]])
    return out


def shard_worker(rank: int, port: int) -> int:
    """Phase 14 (f)'s rank: one shard on the card in a gloo group of two
    processes.  Prints one JSON line: its block of H_WORKER hypotheses
    against the unsharded launch's slice, and the abort raised on rank 1."""
    import numpy as np
    import torch.distributed as dist

    from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
        fused,
        ransac,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
        mesh as pmesh,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        data_io,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
        ransac_data_dir,
    )

    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        cfg = EngineConfig(data_root=os.path.join(ROOT, "data",
                                                  "synth_trifocal"))
        problem = trifocal.TrifocalProblem.load(cfg)
        view = data_io.load_ransac_view(ransac_data_dir(cfg), VIEW)
        T = problem.num_tracks
        s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0],
                                         H_WORKER)
        tgt = torch.as_tensor(np.repeat(ransac.build_target_params(
            view.edge_locations, view.edge_tangents, s), T, axis=0),
            device=DEVICE)
        x0 = torch.as_tensor(problem.start_sols, device=DEVICE).repeat(
            H_WORKER, 1)
        B = H_WORKER * T // 2
        lo, hi = rank * B, (rank + 1) * B
        mesh = pmesh.make_mesh(devices=[DEVICE])
        one = fused.make_track_fn(problem, cfg.hc)(x0, tgt)
        _kernels.hc_track.launches = 0
        local = pmesh.make_sharded_track_fn(
            problem, cfg.hc, mesh, group=dist.group.WORLD)(x0[lo:hi],
                                                           tgt[lo:hi])
        launches = _kernels.hc_track.launches
        sliced = fused.TrackResult(**{
            f.name: getattr(one, f.name)[lo:hi]
            for f in dataclasses.fields(one)})
        same = identical(local.track, sliced) if flips(local.track,
                                                       sliced) == 0 else 0

        # The abort: rank 1's first hypothesis targets the start parameters.
        hc = dataclasses.replace(cfg.hc, segment_steps=2, init_delta_t=0.5,
                                 truncate_paths=False)
        rc = dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                                 pass_inlier_support_ratio=0.0,
                                 imag_part_tol=1e9)
        ta = tgt.clone()
        ta[B:B + T] = torch.as_tensor(problem.start_params, device=DEVICE)
        res = pmesh.make_sharded_track_fn(
            problem, hc, mesh, ransac_cfg=rc, group=dist.group.WORLD)(
                x0[lo:hi], ta[lo:hi],
                torch.as_tensor(view.edge_locations[:64], device=DEVICE),
                torch.eye(3, device=DEVICE), 64)
        print(json.dumps(dict(
            rank=rank, paths=B, identical=same, launches=launches,
            found=res.found, found_path=res.found_path, rank1_block=[B, 2 * B],
            budget=hc.max_steps,
            own_converged=int(res.track.converged.sum()),
            own_max_steps=int(res.track.num_steps.max()))), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_tool(name, *args):
    """tools/<name>.py with ``args`` in a subprocess on the card: asserts
    that it exits 0 and prints the card's line, saves its output under
    build/tools_out/ and returns its last line's JSON object."""
    out_dir = os.path.join(ROOT, "build", "tools_out")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join("tools", f"{name}.py"),
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    tag = "_".join([name, *(a.strip("-") for a in args)])
    with open(os.path.join(out_dir, f"{tag}.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    assert proc.returncode == 0, (name, args, proc.returncode,
                                  proc.stderr[-2000:])
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("device: cuda:0 "), lines[0]
    print(f"tool {name} {' '.join(args)}: rc 0 in {secs:.1f} s; "
          f"{lines[0]}", flush=True)
    return json.loads(lines[-1])


def tools_phase(step_us, paths):
    """Phase 15 (see the module docstring): the four tools on cuda:0 at a
    small size, each in a subprocess that must exit 0 and print its
    figures; the roofline on phase 10's measured step."""
    for tracker in ("oracle", "k1"):
        f = run_tool("f64_reconcile_torch", "--hypotheses", str(H_TOOLS_F64),
                     "--chunk", str(H_TOOLS_F64), "--tracker",
                     tracker)["f64_reconcile"]
        c = f["f32_vs_f64"]
        print(f"f64_reconcile ({tracker}) H={H_TOOLS_F64}, {f['paths']} "
              f"paths, TrunPaths off: converged f32 {f['f32']['converged']} "
              f"/ f64 {f['f64']['converged']}, inf {f['f32']['inf']} / "
              f"{f['f64']['inf']}, real@1e-4 {f['f32']['real_by_tol']['0.0001']}"
              f" / {f['f64']['real_by_tol']['0.0001']}; flag flips converged "
              f"{c['converged_flips']}, inf {c['inf_flips']}; real flips "
              f"f32-only {c['real_lo_only']}, f64-only {c['real_hi_only']}, "
              f"both {c['real_both']}; endpoint distance p50 "
              f"{c['endpoint_distance'].get('50', float('nan')):.3e}",
              flush=True)
        assert f["f32"]["converged"] > 0 and f["f64"]["converged"] > 0, f
    r = run_tool("reconcile_stats_torch", "--hypotheses",
                 str(H_ROUND))["reconcile_stats"]
    for key in ("trunpaths_off", "trunpaths_on"):
        g = r[key]
        print(f"reconcile_stats H={H_ROUND} {key}: converged "
              f"{g['converged']} real {g['real']} inf {g['inf']} pruned "
              f"{g['pruned']} steps {g['steps']}, K1 launches "
              f"{g['launches']}, {g['track_ms']:.3f} ms", flush=True)
        assert g["launches"] > 0 and g["converged"] > 0, g
    a = run_tool("accuracy_sweep_torch", "--retries", "1", "--exhaustive",
                 "0")["accuracy_sweep"]
    print(f"accuracy_sweep: {a['found']}/{a['views']} views recovered "
          f"({a['within_gt']} within GT), attempts {a['attempts']}, first "
          f"round ms {a['first_round_ms']}", flush=True)
    assert a["views"] == 3 and a["found"] == 3, a
    f = run_tool("roofline_torch", "--step-us", repr(step_us), "--paths",
                 str(paths))["roofline"]
    print(f"roofline: phase 10's step {step_us:.3f} us over {paths} paths, "
          f"{f['flops_per_path_step']:.0f} FLOP per path-step, "
          f"{f['gflops']:.3f} GFLOP/s, {100 * f['bound_share']:.3f} % of "
          f"its bound ({f['bound_by']})", flush=True)
    assert f["bound_by"] == "operations" and f["bound_share"] < 0.25, f


def ransac_target(view):
    """View ``view``'s first hypothesis's target parameters (seed SEED),
    (1, P+1) complex64."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import ransac

    s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0], 1)
    return ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                      s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine as eng
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
        fused,
        phases,
        ransac,
        segmented,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops.bound import (
        tracker_bound,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
        resolve_data_root,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_smoke = time.perf_counter()

    # 1. The card: nvidia-smi's line as it prints it, then torch's view.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)

    # 2. The kernel builds: the default and every variant build of phases
    # 8 and 9, one nvcc each, all started together.
    cfg = resolve_data_root(
        EngineConfig(data_root=os.path.join(ROOT, "data", "synth_trifocal")))
    hc = cfg.hc
    variants = {name: dataclasses.replace(hc, **knobs)
                for name, knobs in {**VARIANTS, **EVAL_BUILDS}.items()}
    t0 = time.perf_counter()
    _kernels.build_hc_track([hc, *variants.values()])
    print(f"build: {len(_kernels.build_seconds)} builds of hc_track.cu in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {v:.2f} s" for k, v in
                      _kernels.build_seconds.items()) + ")", flush=True)
    # Per build: its resident blocks per SM (the occupancy query its
    # persistent grid is sized by) and ptxas's lines for the tracker; for
    # the default and the corrector_jacobian_reuse build (phase 10's), also
    # for each phase kernel.
    occupancy, phase_ptxas = {}, {}
    phase_labels = {_kernels.hc_track_label(phases.phase_config(hc, p))
                    for p in _kernels.PHASES}
    for c_ in [hc, *variants.values()]:
        label = _kernels.hc_track_label(c_)
        if label in occupancy:
            continue
        occupancy[label] = _kernels.hc_track_blocks_per_sm(c_, dev)
        ptxas = ptxas_lines(_kernels.build_logs.get(label, ""))
        phase_ptxas[(label, "step")] = "; ".join(
            ptxas.get("hc_track_kernel", []))
        print(f"build {label}: blocks_per_sm {occupancy[label]} "
              f"({torch.cuda.get_device_properties(dev).multi_processor_count}"
              f" SMs); ptxas hc_track_kernel: "
              f"{phase_ptxas[(label, 'step')]}", flush=True)
        if label in phase_labels:
            for p in _kernels.PHASES:
                line = "; ".join(ptxas.get(f"hc_phase_kernel<{p}>", []))
                phase_ptxas[(label, p)] = line
                print(f"build {label}: ptxas hc_phase_kernel<{p}>: {line}",
                      flush=True)

    engine = eng.TrifocalPoseEngine(cfg)
    assert engine.device == dev, engine.device
    problem = engine.problem
    view = engine.load_view(VIEW)
    T = problem.num_tracks
    n = H_ROUND * T
    kernel_track = fused.make_track_fn(problem, hc)
    plain_track = fused.make_plain_track_fn(problem, hc)

    def inputs(h):
        s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0], h)
        tgt = ransac.build_target_params(view.edge_locations,
                                         view.edge_tangents, s)
        tgt = torch.as_tensor(tgt, device=dev).repeat_interleave(T, dim=0)
        return engine._start.repeat(h, 1), tgt

    def parity(label, kernel, plain, x0, tgt, m):
        rk, rp = kernel(x0, tgt), plain(x0, tgt)
        torch.cuda.synchronize()
        nf = flips(rk, rp)
        abs_err, rel = x_errors(rk, rp)
        print(f"{label} parity 1x{T}: flag flips {nf}/{m}, converged "
              f"{int(rk.converged.sum())}/{int(rp.converged.sum())}, "
              f"bit-identical paths {identical(rk, rp)}/{m}, x max abs err "
              f"{abs_err:.3e}, rel {rel:.3e}", flush=True)
        assert nf <= max(1, int(FLIP_FRAC * m)), nf
        assert rel < REL_TOL, rel

    def round_line(label, rr, launches):
        print(f"{label}: converged {rr.stats.num_converged}, inf "
              f"{rr.stats.num_infinity}, real {rr.stats.num_real}, candidates "
              f"{rr.num_candidates}, found_pose {rr.found_pose}, best support "
              f"{rr.best_support21}/{rr.best_support31} of {rr.num_edgels}, "
              f"launches {launches}, track_ms {rr.track_ms:.3f}, "
              f"{n / (rr.track_ms / 1e3):.1f} paths/s, total_ms "
              f"{rr.total_ms:.3f}", flush=True)

    def pose_line(rr):
        # The views are noiseless: the best pose must pass the support test
        # and sit within the reference's residual tolerances.
        assert rr.found_pose, "the round found no pose"
        pe = rr.pose_errors
        print(f"best pose vs ground truth: rot21 {pe.rot21:.3e}, rot31 "
              f"{pe.rot31:.3e}, transl21 {pe.transl21:.3e}, transl31 "
              f"{pe.transl31:.3e}", flush=True)
        assert pe.within(cfg.ransac), pe

    def counted_round(e):
        """One round through engine e, the launches (hc_track's returned,
        hc_phase's in hc_phase.phase_launches) counted from 0."""
        _kernels.hc_track.launches = 0
        _kernels.hc_phase.phase_launches = {}
        rr = e.run_round(view, SEED, H_ROUND)
        return rr, _kernels.hc_track.launches

    def alone(kernel, plain, x0, tgt, plain_runs):
        """Kernel (median of 3) and plain (mean of plain_runs) alone on the
        same inputs, in turns: plain, kernel x 3, plain...; the first plain
        run counts the work."""
        work = {}
        rp, first = timed(lambda: plain(x0, tgt, work=work))
        runs = [timed(lambda: kernel(x0, tgt)) for _ in range(3)]
        plain_ms = [first] + [timed(lambda: plain(x0, tgt))[1]
                              for _ in range(plain_runs - 1)]
        rk = runs[0][0]
        for r in (rk, rp):
            assert r.x.shape == (x0.shape[0], problem.num_vars)
            assert bool(torch.isfinite(r.x[r.converged]).all()), \
                "non-finite converged x"
        return (rk, rp, sorted(t for _, t in runs)[1],
                sum(plain_ms) / len(plain_ms), work)

    # 3. Kernel against track_plain, 1 hypothesis x all paths.
    parity("reduced", kernel_track, plain_track, *inputs(1), T)

    # 4. The main path: one RANSAC round through the engine.
    engine.run_round(view, SEED, H_ROUND)  # warm-up
    rr, launches = counted_round(engine)
    phase_round = {"reduced": sum(_kernels.hc_phase.phase_launches.values())}
    round_line(f"round H={H_ROUND} (segmented, compaction)", rr, launches)
    print(f"round H={H_ROUND}: hc_phase launches {phase_round['reduced']}",
          flush=True)
    assert launches > 0, "the round did not launch the kernel"
    pose_line(rr)
    plain_engine = eng.TrifocalPoseEngine(cfg, track_fn=plain_track)
    rp_round = plain_engine.run_round(view, SEED, H_ROUND)
    dis = int(((rr.converged != rp_round.converged)
               | (rr.inf_fail != rp_round.inf_fail)
               | (rr.pruned != rp_round.pruned)).sum())
    sup_tol = max(5, int(SUP_FRAC * rr.num_edgels))
    print(f"round H={H_ROUND} plain: converged "
          f"{rp_round.stats.num_converged}, best support "
          f"{rp_round.best_support21}/{rp_round.best_support31}, track_ms "
          f"{rp_round.track_ms:.3f} (kernel {rr.track_ms:.3f}); flag flips "
          f"{dis}/{n}", flush=True)
    assert dis <= max(3, int(FLIP_FRAC * n)), dis
    assert abs(rr.best_support21 - rp_round.best_support21) <= sup_tol
    assert abs(rr.best_support31 - rp_round.best_support31) <= sup_tol

    x0, tgt = inputs(H_ROUND)
    rk, rp, ms, plain_ms_reduced, work = alone(kernel_track, plain_track, x0,
                                               tgt, 1)
    abs_err, rel = x_errors(rk, rp)
    nf = flips(rk, rp)
    bound_ms, bound_by = tracker_bound(kernel_track.constants, work, n)
    print(f"kernel alone {ms:.3f} ms, plain {plain_ms_reduced:.3f} ms on {n} "
          f"paths; "
          f"flag flips {nf}, bit-identical paths {identical(rk, rp)}/{n}, x max "
          f"abs err {abs_err:.3e}, rel {rel:.3e}; work {work['steps']} "
          f"path-steps, {work['newton']} corrector iterations; bound "
          f"{bound_ms:.3f} ms ({bound_by})", flush=True)
    assert nf <= max(3, int(FLIP_FRAC * n)), nf
    assert rel < REL_TOL, rel
    k_reduced = dict(program="reduced", launches=launches,
                     blocks_per_sm=occupancy[_kernels.hc_track_label(hc)],
                     max_abs_err=abs_err, ms_one_launch=ms,
                     plain_ms=plain_ms_reduced,
                     bound_ms=bound_ms, bound_by=bound_by)

    # 5. The static-schedule solve (K1e).
    hc_s = dataclasses.replace(hc, solver="schedule")
    cfg_s = dataclasses.replace(cfg, hc=hc_s)
    kernel_s = fused.make_track_fn(problem, hc_s)
    plain_s = fused.make_plain_track_fn(problem, hc_s)
    assert kernel_s.constants.solver == "schedule"
    parity("schedule", kernel_s, plain_s, *inputs(1), T)
    rk_s, rp_s, ms_s, plain_ms_s, work_s = alone(kernel_s, plain_s, x0, tgt, 1)
    abs_err_s, rel_s = x_errors(rk_s, rp_s)
    nf_s = flips(rk_s, rp_s)
    bound_s, bound_by_s = tracker_bound(kernel_s.constants, work_s, n)
    print(f"schedule kernel alone {ms_s:.3f} ms, plain {plain_ms_s:.3f} ms on "
          f"{n} paths; flag flips {nf_s}, bit-identical paths "
          f"{identical(rk_s, rp_s)}/{n}, x max abs err {abs_err_s:.3e}, rel "
          f"{rel_s:.3e}; work {work_s['steps']} path-steps, "
          f"{work_s['newton']} corrector iterations; bound {bound_s:.3f} ms "
          f"({bound_by_s}); flag flips against the reduced program "
          f"{flips(rk_s, rk)}", flush=True)
    assert nf_s <= max(3, int(FLIP_FRAC * n)), nf_s
    assert rel_s < REL_TOL, rel_s
    engine_s = eng.TrifocalPoseEngine(cfg_s)
    engine_s.run_round(view, SEED, H_ROUND)  # warm-up
    rr_s, launches_s = counted_round(engine_s)
    phase_round["schedule"] = sum(_kernels.hc_phase.phase_launches.values())
    round_line(f"round H={H_ROUND} schedule (segmented, compaction)", rr_s,
               launches_s)
    print(f"round H={H_ROUND} schedule: hc_phase launches "
          f"{phase_round['schedule']}", flush=True)
    assert launches_s > 0, "the schedule round did not launch the kernel"
    pose_line(rr_s)
    k_schedule = dict(program="schedule", launches=launches_s,
                      blocks_per_sm=occupancy[_kernels.hc_track_label(hc_s)],
                      max_abs_err=abs_err_s, ms_one_launch=ms_s,
                      plain_ms=plain_ms_s, bound_ms=bound_s,
                      bound_by=bound_by_s)

    # 6. Segmented against one launch, path for path.  The kernels line's
    # ms is the segmented tracker's, the one the main path's launches were
    # counted on.
    def segmented_alone(label, hc_x, one, one_ms):
        seg_track = segmented.make_segmented_track_fn(problem, hc_x)
        runs = []
        for _ in range(3):
            _kernels.hc_track.launches = 0
            rs, t = timed(lambda: seg_track(x0, tgt).track)
            runs.append((t, _kernels.hc_track.launches))
            same = (identical(rs, one), flips(rs, one))
            assert same == (n, 0), same
        seg_ms = sorted(t for t, _ in runs)[1]
        print(f"{label} segmented (8 steps, compaction) vs one launch on {n} "
              f"paths: bit-identical paths {n}/{n} in 3 runs; "
              f"{runs[0][1]} launches {seg_ms:.3f} ms (median of 3), one "
              f"launch {one_ms:.3f} ms", flush=True)
        return seg_ms

    k_reduced["ms"] = segmented_alone("reduced", hc, rk, ms)
    k_schedule["ms"] = segmented_alone("schedule", hc_s, rk_s, ms_s)
    kernels = [k_reduced, k_schedule]
    engine_one = eng.TrifocalPoseEngine(dataclasses.replace(
        cfg, hc=dataclasses.replace(hc, compact_survivors=False)))
    engine_one.run_round(view, SEED, H_ROUND)  # warm-up
    rr_one, launches_one = counted_round(engine_one)
    round_line(f"round H={H_ROUND} one launch", rr_one, launches_one)
    assert launches_one == 1, launches_one
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert (getattr(rr_one, f) == getattr(rr, f)).all(), f
    print(f"segmented round track_ms {rr.track_ms:.3f} / total_ms "
          f"{rr.total_ms:.3f} ({launches} launches) vs one launch "
          f"{rr_one.track_ms:.3f} / {rr_one.total_ms:.3f} ({launches_one})",
          flush=True)

    # 7. The TrunRANSAC abort round.
    cfg_a = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=ABORT_CHUNK))
    engine_a = eng.TrifocalPoseEngine(cfg_a)
    engine_a.run_round(view, SEED, H_ROUND)  # warm-up
    ra, launches_a = counted_round(engine_a)
    n_chunks = -(-H_ROUND // ABORT_CHUNK)
    print(f"abort round H={H_ROUND}, chunk {ABORT_CHUNK}: chunks run "
          f"{ra.chunks_run} of {n_chunks}, found_pose {ra.found_pose}, best support {ra.best_support21}/"
          f"{ra.best_support31} of {ra.num_edgels}, launches {launches_a}, "
          f"track_ms (time to pose) {ra.track_ms:.3f}, total_ms "
          f"{ra.total_ms:.3f}", flush=True)
    assert launches_a > 0, "the abort round did not launch the kernel"
    pose_line(ra)
    assert ra.chunks_run < n_chunks, ra.chunks_run

    # 8. The step variants, each a build of its own, and 9. the evaluation
    # variants with builds of their own: kernel against plain on the H=10
    # round's paths, the H=100 engine round, and the segmented tracker
    # alone on the round's inputs (kernel, then track_plain over the same
    # segments, which counts the work).  Phase 9's builds must agree bit
    # for bit on every path.
    def work_line(work):
        return (f"{work['steps']} path-steps, {work['newton']} corrector "
                f"iterations, {work['solves']} full solves, "
                f"{work.get('replays', 0)} replays, "
                f"{work.get('split_solves', 0)} + "
                f"{work.get('split_replays', 0)} split")

    x10, tgt10 = inputs(10)
    m10 = x10.shape[0]
    for name, hc_v in variants.items():
        # Phase 9's builds and the tiled handoff must agree bit for bit.
        exact = name in EVAL_BUILDS or name == "cph128"
        kv = fused.make_track_fn(problem, hc_v)
        pv = fused.make_plain_track_fn(problem, hc_v)
        c_v = kv.constants
        order = _kernels.hc_track_variant(hc_v)[0]
        rk10, rp10, ms10, plain10, work10 = alone(kv, pv, x10, tgt10, 1)
        nf10 = flips(rk10, rp10)
        abs10, rel10 = x_errors(rk10, rp10)
        b10, by10 = tracker_bound(c_v, work10, m10, order,
                                  hc_v.pair_coef_basis)
        same10 = identical(rk10, rp10)
        print(f"{name} ({_kernels.hc_track_label(hc_v)}, {c_v.solver}) "
              f"kernel vs plain on {m10} paths: flag flips {nf10}, converged "
              f"{int(rk10.converged.sum())}/{int(rp10.converged.sum())}, "
              f"bit-identical paths {same10}/{m10}, x max abs "
              f"err {abs10:.3e}, rel {rel10:.3e}; work {work_line(work10)}; "
              f"kernel alone {ms10:.3f} ms (median of 3), plain {plain10:.3f} "
              f"ms, bound {b10:.3f} ms ({by10})", flush=True)
        assert nf10 <= max(1, int(FLIP_FRAC * m10)), nf10
        assert rel10 < REL_TOL, rel10
        assert not exact or same10 == m10, same10
        if hc_v.tile > 1 and hc_v.predictor_handoff:
            # One launch pads the last tile (3,070 = 23 x 128 + 126) with
            # an active copy of path 0, as the JAX package's one launch;
            # the segmented tracker's launches have no pad.
            assert fused.handoff_pad(hc_v, m10) == 1
            rs10 = segmented.make_segmented_track_fn(problem, hc_v)(
                x10, tgt10).track
            rps10 = segmented.make_segmented_track_fn(
                problem, hc_v, plain=True)(x10, tgt10).track
            torch.cuda.synchronize()
            segs10 = identical(rs10, rps10)
            print(f"{name} segmented vs track_plain over the same segments "
                  f"on {m10} paths: bit-identical paths {segs10}/{m10}, flag "
                  f"flips {flips(rs10, rps10)}", flush=True)
            assert segs10 == m10 and flips(rs10, rps10) == 0, segs10

        # RKJ and CJR=1 converge worse: found_pose is printed, not asserted.
        cfg_v = dataclasses.replace(cfg, hc=hc_v)
        engine_v = eng.TrifocalPoseEngine(cfg_v)
        engine_v.run_round(view, SEED, H_ROUND)  # warm-up
        rr_v, launches_v = counted_round(engine_v)
        round_line(f"{name} round H={H_ROUND} (segmented, compaction)", rr_v,
                   launches_v)
        assert launches_v > 0, f"the {name} round did not launch the kernel"
        if name == "abc":
            # The basis's known floor under the imaginary residues.
            print(f"abc round: {rr_v.stats.num_real} real solutions against "
                  f"the two-point basis's {rr.stats.num_real} (converged "
                  f"{rr_v.stats.num_converged} / {rr.stats.num_converged})",
                  flush=True)

        seg_v = segmented.make_segmented_track_fn(problem, hc_v)
        runs = [timed(lambda: seg_v(x0, tgt).track) for _ in range(3)]
        seg_ms = sorted(t for _, t in runs)[1]
        work = {}
        plain_seg = segmented.make_segmented_track_fn(problem, hc_v, plain=True)
        rp_v, plain_ms = timed(lambda: plain_seg(x0, tgt, work=work).track)
        rs = runs[0][0]
        nf_v = flips(rs, rp_v)
        abs_v, rel_v = x_errors(rs, rp_v)
        bound_v, by_v = tracker_bound(c_v, work, n, order,
                                      hc_v.pair_coef_basis)
        same_v = identical(rs, rp_v)
        print(f"{name} segmented tracker on {n} paths: {seg_ms:.3f} ms "
              f"(median of 3); plain over the same segments {plain_ms:.3f} "
              f"ms; flag flips {nf_v}, bit-identical paths "
              f"{same_v}/{n}, x max abs err {abs_v:.3e}; work "
              f"{work_line(work)}; bound {bound_v:.3f} ms ({by_v})",
              flush=True)
        assert nf_v <= max(3, int(FLIP_FRAC * n)), nf_v
        assert rel_v < REL_TOL, rel_v
        assert not exact or same_v == n, same_v
        kernels.append(dict(program=c_v.solver, variant=name,
                            replaces=REPLACES_VARIANT[name],
                            blocks_per_sm=occupancy[
                                _kernels.hc_track_label(hc_v)],
                            launches=launches_v, max_abs_err=abs_v, ms=seg_ms,
                            plain_ms=plain_ms, plain_paths=n, bound_ms=bound_v,
                            bound_by=by_v))
        if hc_v.tile > 1 and hc_v.predictor_handoff:
            # The tiled kernel in one launch on the round's paths (30,700:
            # its last tile padded), its own occupancy, and the geometry of
            # each launch (one launch, then each segment's over its
            # active prefix): tiles, the cluster a tile runs on, blocks.
            one_v = sorted(timed(lambda: kv(x0, tgt))[1] for _ in range(3))[1]
            tile_bps = _kernels.hc_track_blocks_per_sm(hc_v, dev)
            resident = _kernels.hc_track_tile_clusters(hc_v, dev)
            geo_one = tile_geometry(_kernels, lambda: kv(x0, tgt))
            geo_seg = tile_geometry(_kernels, lambda: seg_v(x0, tgt))
            print(f"{name}: one launch on {n} paths {one_v:.3f} ms (median "
                  f"of 3); hc_track_tile_kernel blocks_per_sm {tile_bps}, "
                  f"tile {hc_v.tile}, {-(-n // hc_v.tile)} tiles; resident "
                  f"clusters by size {resident}; one launch (tiles, "
                  f"cluster, blocks) {geo_one[0]}; segment launches "
                  f"{geo_seg}; ptxas "
                  + "; ".join(ptxas_lines(_kernels.build_logs.get(
                      _kernels.hc_track_label(hc_v), "")).get(
                          "hc_track_tile_kernel", [])), flush=True)
            assert len(geo_one) == 1 and len(geo_seg) > 1, (geo_one, geo_seg)
            kernels[-1].update(ms_one_launch=one_v, tile=hc_v.tile,
                               kernel="hc_track_tile_kernel",
                               blocks_per_sm=tile_bps, cluster=geo_one[0][1],
                               resident_clusters=resident,
                               segment_launches=geo_seg)

        if name == "cjr2":
            engine_va = eng.TrifocalPoseEngine(dataclasses.replace(
                cfg_a, hc=hc_v))
            engine_va.run_round(view, SEED, H_ROUND)  # warm-up
            rva, launches_va = counted_round(engine_va)
            print(f"{name} abort round H={H_ROUND}, chunk {ABORT_CHUNK}: "
                  f"chunks run {rva.chunks_run} of {n_chunks}, found_pose "
                  f"{rva.found_pose}, best support {rva.best_support21}/"
                  f"{rva.best_support31}, launches {launches_va}, track_ms "
                  f"{rva.track_ms:.3f}, total_ms {rva.total_ms:.3f}",
                  flush=True)
            assert launches_va > 0, "the cjr2 abort round did not launch"

    # 9, continued: the structures run the default build, so their round
    # equals the default's path for path.  Their kernels entries are the
    # default build's numbers from phases 4 and 6, with the round's own
    # launches.
    for name, knobs in EVAL_STRUCTURES.items():
        hc_v = dataclasses.replace(hc, **knobs)
        assert _kernels.hc_track_label(hc_v) == _kernels.hc_track_label(hc)
        engine_v = eng.TrifocalPoseEngine(dataclasses.replace(cfg, hc=hc_v))
        rr_v, launches_v = counted_round(engine_v)
        round_line(f"{name} round H={H_ROUND} (segmented, compaction, no "
                   f"warm-up)", rr_v, launches_v)
        assert launches_v > 0, f"the {name} round did not launch the kernel"
        for f in ("converged", "inf_fail", "pruned", "num_steps"):
            assert (getattr(rr_v, f) == getattr(rr, f)).all(), f
        print(f"{name}: the round equals the default's on all {n} paths "
              f"(flags and step counts); it runs the default build "
              f"{_kernels.hc_track_label(hc)}", flush=True)
        kernels.append(dict(
            k_reduced, variant=name, replaces=REPLACES_VARIANT[name],
            launches=launches_v, plain_paths=n,
            note="the default build: ms, plain_ms, bound and error are the "
                 "reduced entry's"))

    # 10. K1's phases alone, both programs: bit for bit at one iteration,
    # then the timed table with the launch counts from 0.
    def outputs_bits(o):
        return torch.cat([torch.view_as_real(v).reshape(v.shape[0], -1)
                          .view(torch.int32) if v.is_complex()
                          else v.reshape(v.shape[0], -1).view(torch.int32)
                          for v in o], dim=1)

    def per_iteration_plain(run):
        """The plain version's ms per iteration: (min of 3 at 4 iterations
        - min of 3 at 1) / 3, so that its set-up cancels."""
        one = min(phases.cuda_ms(lambda: run(1)) for _ in range(3))
        four = min(phases.cuda_ms(lambda: run(4)) for _ in range(3))
        return (four - one) / 3

    t_phases = time.perf_counter()
    steps_us = {}   # program -> (the step's µs per iteration, paths)
    for program, hc_p, k_round, rr_p in (("reduced", hc, k_reduced, rr),
                                         ("schedule", hc_s, k_schedule,
                                          rr_s)):
        seg_ms = k_round["ms"]
        state = phases.make_state(problem, dataclasses.replace(cfg, hc=hc_p))
        B = state.batch
        run_here = [p for p in phases.PORT_PHASES
                    if not (program == "schedule"
                            and p in ("elimfam", "elimtail"))]
        plain_ms = {}
        for p in phases.PORT_PHASES:
            if p not in run_here:
                try:
                    phases.run_phase(state, p, 1)
                except ValueError as err:
                    print(f"phase {program} {p}: refused ({err})", flush=True)
                    continue
                raise AssertionError(f"{p} ran on the schedule program")
            if p == "step":
                k = phases.run_step(state, 1)
                pl = phases.run_step(state, 1, plain=True)

                def plain_run(n):
                    return phases.run_step(state, n, plain=True)
            else:
                k = phases.run_phase(state, p, 1)
                pl = phases.plain_phase(state, p, 1)

                def plain_run(n, p=p):
                    return phases.plain_phase(state, p, n)
            torch.cuda.synchronize()
            kb, pb = outputs_bits(k), outputs_bits(pl)
            same = int((kb == pb).all(dim=1).sum())
            err = max(float((u.to(torch.complex64) - v.to(torch.complex64))
                            .abs().max()) for u, v in zip(k, pl))
            print(f"phase {program} {p}: kernel vs plain at 1 iteration, "
                  f"bit-identical paths {same}/{B}, max abs err {err:.3e}",
                  flush=True)
            assert same == B, (program, p, same)
            assert bool(torch.isfinite(k[0]).all()), (program, p)
            plain_ms[p] = (per_iteration_plain(plain_run), err)
        _kernels.hc_phase.phase_launches = {}
        _kernels.hc_track.launches = 0
        rows = phases.measure(state, run_here, PHASE_ITERS, PHASE_STEP_ITERS)
        launches_p = dict(_kernels.hc_phase.phase_launches,
                          step=_kernels.hc_track.launches)
        for r in rows:
            p = r["phase"]
            assert launches_p.get(p, 0) > 0, (program, p, launches_p)
            assert r["blocks_per_sm"] == r["tracker_blocks_per_sm"], r
            print(f"phase {program} {p:9s}: {r['us']:10.3f} us/iter over "
                  f"{B} paths, {r['ns_per_path']:8.3f} ns/path-iter, "
                  f"{r['step_share']:.4f} of a step; bound "
                  f"{r['bound_ms'] * 1e3:9.3f} us ({100 * r['bound_share']:.3f}"
                  f" %); plain {plain_ms[p][0]:.3f} ms/iter; blocks/SM "
                  f"{r['blocks_per_sm']} (tracker {r['tracker_blocks_per_sm']}"
                  f"); launches {launches_p[p]}", flush=True)
            kernels.append(dict(
                name="hc_phase" if p != "step" else "hc_track", phase=p,
                program=program,
                replaces=(REPLACES_PHASE if p != "step"
                          else "tools/microbench_fused.py:442"),
                jax_phases=[j for j, (q, _) in phases.PHASE_MAP.items()
                            if q == p],
                launches=launches_p[p],
                launches_per_round=(phase_round[program] if p != "step"
                                    else k_round["launches"]),
                blocks_per_sm=r["blocks_per_sm"], max_abs_err=plain_ms[p][1],
                ms=r["ms"], plain_ms=plain_ms[p][0], bound_ms=r["bound_ms"],
                bound_by="operations", paths=B,
                ptxas=phase_ptxas.get((_kernels.hc_track_label(
                    phases.phase_config(hc_p, p)), p), ""),
                **({"note": "phase 10's step: the tracker kernel itself on "
                            "fresh state, timed as the JAX tool's run_step"}
                   if p == "step" else {})))
        step_ms = next(r["ms"] for r in rows if r["phase"] == "step")
        steps_us[program] = (step_ms * 1e3, B)
        longest = int(rr_p.num_steps.max())
        print(f"phase {program} step: {step_ms:.3f} ms per step on {B} fresh "
              f"paths; phase 4/5's segmented tracker {seg_ms:.3f} ms over the "
              f"round's largest step count {longest}: {seg_ms / longest:.3f} "
              f"ms per step (a sanity line: the round's batch shrinks)",
              flush=True)

    print(f"phase 10: {time.perf_counter() - t_phases:.1f} s", flush=True)

    # 11. The serving surface.
    t_serve = time.perf_counter()
    serve, streams = serving(cfg, engine, view, rr, round_line, eng, _kernels)
    k_reduced.update(serve)
    print(f"phase 11: {time.perf_counter() - t_serve:.1f} s", flush=True)

    # 12. The oracle tracker, the cross-check and monodromy.
    t_oracle = time.perf_counter()
    oracle, rcpu = oracle_rounds(cfg, engine, view, round_line, eng,
                                 _kernels)
    k_reduced.update(
        oracle, launches_per_cross_check=cross_check(engine, view, rcpu),
        launches_per_monodromy_leg=monodromy_checks(cfg, engine, view,
                                                    _kernels))
    print(f"phase 12: {time.perf_counter() - t_oracle:.1f} s", flush=True)

    # 13. P2C and the ablation ladder.
    t_p2c = time.perf_counter()
    kernels.append(p2c_ladder(cfg, problem, view, inputs, round_line, eng,
                              _kernels, occupancy[_kernels.hc_track_label(hc)]))
    print(f"phase 13: {time.perf_counter() - t_p2c:.1f} s", flush=True)

    # 14. Hypothesis sharding on the one card.
    t_shard = time.perf_counter()
    k_reduced.update(sharding(cfg, engine, view, rr, ra, streams, inputs,
                              round_line, eng, _kernels))
    print(f"phase 14: {time.perf_counter() - t_shard:.1f} s", flush=True)

    # 15. The measurement tools on the card, in subprocesses.
    t_tools = time.perf_counter()
    tools_phase(*steps_us["reduced"])
    print(f"phase 15: {time.perf_counter() - t_tools:.1f} s", flush=True)
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        **dict(name="hc_track", route="cuda", source=SOURCE, library_ms=None,
               replaces=REPLACES.get(k["program"])), **k}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [WORKER_FLAG]:
        sys.exit(shard_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
