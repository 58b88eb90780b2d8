#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits nonzero):
  1. the card: nvidia-smi's name and power limit, torch's device name;
  2. the kernel build (csrc/hc_track.cu with nvcc), and its seconds;
  3. the kernel against its plain PyTorch twin (ops/fused.track_plain) on
     the card: 1 hypothesis x all paths of view 0;
  4. one RANSAC round (view 0, seed 0, H=100 hypotheses) through the
     engine after a warm-up round, with the kernel's launch count and the
     best pose against ground truth; the same round with track_plain;
     then kernel and plain timed alone on that round's inputs.
Then a JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.  Needs a CUDA card; exits nonzero without.
"""

import json
import os
import subprocess
import sys
import time

import torch

H_ROUND = 100
VIEW, SEED = 0, 0
FLIP_FRAC, SUP_FRAC = 0.005, 0.002  # the reference's cross-check bands
REL_TOL = 1e-3                      # x on paths both versions converge
ROOT = os.path.dirname(os.path.abspath(__file__))


def flips(a, b):
    """Per-path flag disagreements in converged, inf-fail and pruned."""
    return int(((a.converged != b.converged) | (a.inf_fail != b.inf_fail)
                | (a.pruned != b.pruned)).sum())


def identical(a, b):
    """Paths whose x and step count agree bit for bit."""
    same = (a.x == b.x).all(dim=1) & (a.num_steps == b.num_steps)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine as eng
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
        fused,
        ransac,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
        resolve_data_root,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

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

    cfg = resolve_data_root(
        EngineConfig(data_root=os.path.join(ROOT, "data", "synth_trifocal")))
    engine = eng.TrifocalPoseEngine(cfg, device=dev)
    problem, hc = engine.problem, cfg.hc
    view = engine.load_view(VIEW)
    T = problem.num_tracks
    plain_track = fused.make_plain_track_fn(problem, hc)

    def inputs(h):
        s = ransac.sample_edgel_triplets(SEED, view.edge_locations.shape[0], h)
        tgt = ransac.build_target_params(view.edge_locations,
                                         view.edge_tangents, s)
        tgt = torch.as_tensor(tgt, device=dev).repeat_interleave(T, dim=0)
        return engine._start.repeat(h, 1), tgt

    # 3. Kernel against track_plain, 1 hypothesis x all paths.
    x0, tgt = inputs(1)
    rk = engine.track(x0, tgt)
    rp = plain_track(x0, tgt)
    torch.cuda.synchronize()
    nf = flips(rk, rp)
    abs_err, rel = x_errors(rk, rp)
    print(f"parity 1x{T}: flag flips {nf}/{T}, converged "
          f"{int(rk.converged.sum())}/{int(rp.converged.sum())}, bit-identical "
          f"paths {identical(rk, rp)}/{T}, x max abs err {abs_err:.3e}, rel "
          f"{rel:.3e}", flush=True)
    assert nf <= max(1, int(FLIP_FRAC * T)), nf
    assert rel < REL_TOL, rel

    # 4. The main path: one RANSAC round through the engine.
    engine.run_round(view, SEED, H_ROUND)  # warm-up
    _kernels.hc_track.launches = 0
    rr = engine.run_round(view, SEED, H_ROUND)
    launches = _kernels.hc_track.launches
    n = H_ROUND * T
    print(f"round H={H_ROUND}: converged {rr.stats.num_converged}, inf "
          f"{rr.stats.num_infinity}, real {rr.stats.num_real}, candidates "
          f"{rr.num_candidates}, found_pose {rr.found_pose}, best support "
          f"{rr.best_support21}/{rr.best_support31} of {rr.num_edgels}, "
          f"launches {launches}, track_ms {rr.track_ms:.3f}, "
          f"{n / (rr.track_ms / 1e3):.1f} paths/s, total_ms "
          f"{rr.total_ms:.3f}", flush=True)
    assert launches > 0, "the round did not launch the kernel"
    # The views are noiseless: the best pose must pass the support test and
    # sit within the reference's residual tolerances of the ground truth.
    pe = rr.pose_errors
    print(f"best pose vs ground truth: rot21 {pe.rot21:.3e}, rot31 "
          f"{pe.rot31:.3e}, transl21 {pe.transl21:.3e}, transl31 "
          f"{pe.transl31:.3e}", flush=True)
    assert rr.found_pose, "the round found no pose"
    assert pe.within(cfg.ransac), pe
    plain_engine = eng.TrifocalPoseEngine(cfg, device=dev,
                                          track_fn=plain_track)
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

    # Kernel and plain alone on the round's inputs, in turns (plain, kernel
    # x 3, plain); the medians are reported.
    x0, tgt = inputs(H_ROUND)
    rp, plain_a = timed(lambda: plain_track(x0, tgt))
    kernel_runs = [timed(lambda: engine.track(x0, tgt)) for _ in range(3)]
    _, plain_b = timed(lambda: plain_track(x0, tgt))
    rk = kernel_runs[0][0]
    ms = sorted(t for _, t in kernel_runs)[1]
    plain_ms = (plain_a + plain_b) / 2
    for r in (rk, rp):
        conv = r.x[r.converged]
        assert r.x.shape == (n, problem.num_vars)
        assert bool(torch.isfinite(conv).all()), "non-finite converged x"
    abs_err, rel = x_errors(rk, rp)
    nf = flips(rk, rp)
    print(f"kernel alone {ms:.3f} ms, plain {plain_ms:.3f} ms on {n} paths; "
          f"flag flips {nf}, bit-identical paths {identical(rk, rp)}/{n}, x max "
          f"abs err {abs_err:.3e}, rel {rel:.3e}", flush=True)
    assert nf <= max(3, int(FLIP_FRAC * n)), nf
    assert rel < REL_TOL, rel

    print(json.dumps({"kernels": [{
        "name": "hc_track", "route": "cuda",
        "source": "trifocal_pose_estimation_using_improved_gpuhc_torch/csrc/"
                  "hc_track.cu",
        "replaces": "trifocal_pose_estimation_using_improved_gpuhc_tpu/ops/"
                    "fused.py:1494",
        "launches": launches, "max_abs_err": abs_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
