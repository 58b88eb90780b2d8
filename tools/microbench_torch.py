#!/usr/bin/env python3
"""Per-phase microbenchmark of the port's tracker kernel on one CUDA card.

    python3 tools/microbench_torch.py [--schedule] [--classic|--gathered|--merged] [phase ...]

The port of tools/microbench_fused.py, with its arguments: phase names are
the JAX tool's (default: its list, fillp mm5 front eval evasm elim back
evsolve step), each run as the port phase that computes its function on
the card (ops/phases.PHASE_MAP, whose notes say where a JAX phase is a TPU
matmul form of one function here); --schedule takes the static-schedule
solve; --classic/--gathered/--merged set eval_structure, which is one
function, and one build, on the card.  Each phase kernel runs K1's own
code in K1's build on the state of ops/phases.make_state (view 0, seed 0,
one hypothesis over the H = 100 round's 30,700 paths), and is timed by
CUDA events with the JAX tool's arithmetic (ops/phases.two_count, 500
iterations; the step 64).  Per phase it prints µs per iteration over the
batch, ns per path-iteration, the share of one step, the bound (its FP32
operations over 67 TFLOP/s, ops/bound.py) and the share of it reached,
and the resident blocks per SM of the phase kernel and of the tracker in
the same build.  Needs a CUDA card; exits nonzero without one.
"""

import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, STEP_ITERS = 500, 64


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("microbench_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
        phases,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        EngineConfig,
    )

    args = list(argv)
    cfg = EngineConfig(data_root=os.path.join(ROOT, "data", "synth_trifocal"))
    hc = cfg.hc
    if "--schedule" in args:
        args.remove("--schedule")
        hc = dataclasses.replace(hc, solver="schedule")
    for flag in ("--classic", "--gathered", "--merged"):
        if flag in args:
            args.remove(flag)
            hc = dataclasses.replace(hc, eval_structure=flag[2:])
    names = args or list(phases.DEFAULT_PHASES)
    unknown = [a for a in names if a not in phases.PHASE_MAP]
    if unknown:
        print(f"microbench_torch: unknown phases {unknown} (the JAX tool's "
              f"names: {sorted(phases.PHASE_MAP)})", file=sys.stderr)
        return 2
    cfg = dataclasses.replace(cfg, hc=hc)
    port = [phases.PHASE_MAP[a][0] for a in names]
    _kernels.build_hc_track([phases.phase_config(hc, p) for p in set(port)])
    problem = trifocal.TrifocalProblem.load(cfg)
    state = phases.make_state(problem, cfg)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0])
    print(f"solver: {state.c.solver}  eval_structure: {hc.eval_structure} "
          f"(one build: {_kernels.hc_track_label(hc)})  paths: "
          f"{state.batch}  iterations: {ITERS} (step {STEP_ITERS})",
          flush=True)
    rows = {r["phase"]: r for r in phases.measure(
        state, list(dict.fromkeys(port)), ITERS, STEP_ITERS)}
    for name, ph in zip(names, port):
        r = rows[ph]
        note = phases.PHASE_MAP[name][1]
        print(f"{name:8s} -> {ph:9s}: {r['us']:10.3f} us/iter "
              f"{r['ns_per_path']:8.3f} ns/path-iter, {r['step_share']:7.4f}"
              f" of a step; bound {r['bound_ms'] * 1e3:8.3f} us "
              f"({100 * r['bound_share']:.3f} %); blocks/SM "
              f"{r['blocks_per_sm']} (tracker {r['tracker_blocks_per_sm']})"
              + (f"  [{note}]" if note else ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
