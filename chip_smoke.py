#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the kernel build (csrc/hc_track.cu with nvcc), its seconds and
     ptxas's resource lines;
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
     the time to the pose and the pose against ground truth.
Then a JSON line of per-kernel numbers (one entry per solve program of
hc_track: launches in the engine's round, ms of the segmented tracker that
round runs, ms_one_launch of one launch, plain_ms of track_plain, all on
the round's 30,700 paths), and as the last line {"ok": true, "device":
{...}}.  Needs a CUDA card; exits nonzero without.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

H_ROUND = 100
VIEW, SEED = 0, 0
ABORT_CHUNK = 12
FLIP_FRAC, SUP_FRAC = 0.005, 0.002  # the reference's cross-check bands
REL_TOL = 1e-3                      # x on paths both versions converge
# One H100 SXM at its 700 W limit: FP32 outside the tensor cores, HBM3.
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "trifocal_pose_estimation_using_improved_gpuhc_torch/csrc/hc_track.cu"
REPLACES = {
    "reduced": "trifocal_pose_estimation_using_improved_gpuhc_tpu/ops/"
               "fused.py:1494",
    "schedule": "trifocal_pose_estimation_using_improved_gpuhc_tpu/ops/"
                "fused.py:873",
}


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


def fill_steps(c):
    """The symbolic pattern with fill of the constants' solve program, per
    pivot step in program order: (step, column, rows, pattern), where rows
    are the candidate rows not used by an earlier step (the pivot is one
    of them) and pattern is the set of columns, rhs (c.n) included, that
    the pivot row may hold after the eliminated column.

    The rows start with the Hx pattern plus the rhs.  As in the schedule
    analysis (``ops/schedule.py``), fill is taken over the union: after a
    step every unused candidate row holds the union of their patterns
    minus the column, since any of them may be some path's pivot.  An
    earlier-eliminated column is in no pattern: a row that was not a
    candidate has a structural zero there (checked), and a candidate was
    reduced to zero.  Later levels' rows are found through the row maps
    with the first unused candidate as the pivot; after a group's first
    step its rows share one pattern, so which one pivots does not change
    the patterns."""
    n = c.n
    pats = [{n} for _ in range(n)]
    for r, col in zip(c.nz_row, c.nz_col):
        pats[int(r)].add(int(col))
    used, rmap, level, out = set(), [int(r) for r in c.map0], 0, []
    for st in c.stages:
        while level < st.level:
            rmap = [[rmap[s] for s in src if s >= 0 and rmap[s] not in used][k]
                    for *src, k in c.maps[level].tolist()]
            level += 1
        picks = []
        for s, col, cand in zip(st.steps, st.cols, st.cands):
            rows = [rmap[i] for i in cand if rmap[i] not in used]
            if any(col in pats[r] for r in set(range(n)) - used - set(rows)):
                raise ValueError(f"step {s}: a non-candidate row holds "
                                 f"column {col}")
            pattern = set().union(*(pats[r] for r in rows)) - {col}
            picks.append((s, col, rows, pattern))
        for _, _, rows, pattern in picks:
            used.add(rows[0])
            for r in rows[1:]:
                pats[r] = set(pattern)
        out.extend(picks)
    return out


def solve_flops(c):
    """FP32 operations of one assemble + solve of the constants' program.

    Assembly: an Hx term is two complex products, a scale and a complex
    add (16), an rhs term three products, a scale and an add (22).  Solve,
    per step (``fill_steps``): the pivot metric of each unused candidate
    (one add), the reciprocal (3 + 2), and per other unused candidate the
    multiplier (6) and the update of the pivot row's pattern (8 per
    entry); back-substitution, per step, a complex dot over the pattern's
    columns (8 each), the rhs (2) and the scaled result (11)."""
    nz_terms, rhs_terms = c.term_lists()
    flops = 16 * sum(map(len, nz_terms)) + 22 * sum(map(len, rhs_terms))
    for _, _, rows, pattern in fill_steps(c):
        w = len(pattern)
        flops += len(rows) + 5 + (len(rows) - 1) * (6 + 8 * w)
        flops += 8 * (w - 1) + 2 + 11
    return flops


def tracker_bound(c, work, n_paths):
    """(bound_ms, bound_by) of one tracker call over n_paths: the larger of
    the FP32 operations its paths really did (work: the path-steps and
    corrector iterations counted by track_plain, which the kernel matches
    bit for bit) over 67 TFLOP/s and its bytes (state, flags and
    coefficients read once, state and flags written once, the plan read
    once) over 3.35 TB/s."""
    per_solve = solve_flops(c)
    # A step: 4 RK stages, 3 fills of P and dP/dt and 1 of P (10 per pair
    # each), the RK combination and stage points (740); a corrector
    # iteration: the update and two norms (240).
    flops = (work["steps"] * (4 * per_solve + 70 * c.q + 740)
             + work["newton"] * (per_solve + 240))
    nbytes = n_paths * (4 * 30 * 8 + 2 * 8 * 4 + 3 * c.q * 8) \
        + 4 * c.kernel_plan().size
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    # 2. The kernel build.
    t0 = time.perf_counter()
    _kernels.load("hc_track")
    print(f"build: hc_track.cu in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_kernels.build_seconds.get('hc_track', 0.0):.2f} s)",
          flush=True)
    for line in _kernels.build_logs.get("hc_track", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"ptxas: {line.strip()}")

    cfg = resolve_data_root(
        EngineConfig(data_root=os.path.join(ROOT, "data", "synth_trifocal")))
    engine = eng.TrifocalPoseEngine(cfg)
    assert engine.device == dev, engine.device
    problem, hc = engine.problem, cfg.hc
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
        """One round through engine e, the launches counted from 0."""
        _kernels.hc_track.launches = 0
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
    round_line(f"round H={H_ROUND} (segmented, compaction)", rr, launches)
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
    rk, rp, ms, plain_ms, work = alone(kernel_track, plain_track, x0, tgt, 2)
    abs_err, rel = x_errors(rk, rp)
    nf = flips(rk, rp)
    bound_ms, bound_by = tracker_bound(kernel_track.constants, work, n)
    print(f"kernel alone {ms:.3f} ms, plain {plain_ms:.3f} ms on {n} paths; "
          f"flag flips {nf}, bit-identical paths {identical(rk, rp)}/{n}, x max "
          f"abs err {abs_err:.3e}, rel {rel:.3e}; work {work['steps']} "
          f"path-steps, {work['newton']} corrector iterations; bound "
          f"{bound_ms:.3f} ms ({bound_by})", flush=True)
    assert nf <= max(3, int(FLIP_FRAC * n)), nf
    assert rel < REL_TOL, rel
    k_reduced = dict(program="reduced", launches=launches,
                     max_abs_err=abs_err, ms_one_launch=ms, plain_ms=plain_ms,
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
    round_line(f"round H={H_ROUND} schedule (segmented, compaction)", rr_s,
               launches_s)
    assert launches_s > 0, "the schedule round did not launch the kernel"
    pose_line(rr_s)
    k_schedule = dict(program="schedule", launches=launches_s,
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

    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s", flush=True)
    print(json.dumps({"kernels": [dict(
        name="hc_track", route="cuda", source=SOURCE,
        replaces=REPLACES[k["program"]], library_ms=None, **k)
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
