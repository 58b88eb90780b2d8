#!/usr/bin/env python3
"""The tracker's work per path and HC step by phase, and a measured step
against the H100's roofline.

    python3 tools/roofline_torch.py [--corrector-iters 2]
        [--step-us US --paths N] [--platform gpu|cpu] [--data-root DIR]

The port of tools/roofline.py, recomputed for Hopper.  From the committed
problem's constants (``FusedConstants``, the shipped configuration: the
condensed program, RK4, the two-point basis) and the counts of
``ops/bound.py`` it prints the FP32 operations of one HC step of one path,
phase by phase: the fills of P and dP/dt, the evaluations' monomials and
term walks, the forward eliminations and the back-substitutions (one per
RK stage and per corrector iteration, ``--corrector-iters`` of them: 2 by
default, about the 1.87 a step of K1's phase table takes on fresh paths,
PERF.md section 6), and the step's own bookkeeping; the total is
``bound.tracker_flops`` of that work.  Beside it, the bytes a path-step
moves (state, flags and coefficients, each read once and written once).

Given a measured step, ``--step-us`` microseconds per iteration over a
batch of ``--paths`` paths (the "step" row of tools/microbench_torch.py,
or chip_smoke.py phase 10), it prints the achieved FP32 rate and byte
rate against the card's peaks (``bound.PEAK_FLOPS``, 67 TFLOP/s FP32
outside the tensor cores; ``bound.PEAK_BYTES``, 3.35 TB/s), the bound
(the larger of the two times) and the share of it reached.  On a card it
prints the card's name and power limit as nvidia-smi gives them: the
peaks are the 700 W part's.  The TPU model of the JAX tool (vector
registers, MXU passes, its clock and peak) has no counterpart here.
Needs a card unless given --platform cpu (the arithmetic alone).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = 4   # RK4, the shipped predictor


def step_work(c, corrector_iters=2.0):
    """[(phase, FP32 operations)] of one RK4 HC step of one path in the
    two-point basis and the tracker work it is (``bound.tracker_flops``'s
    dict): 4 RK stages and ``corrector_iters`` corrector iterations, each a
    full evaluation and solve."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import bound

    order = ORDER
    solves = order + corrector_iters
    rk_fill, corr_fill = bound.FILL_FLOPS["efg"]
    mono = bound.monomial_flops(c)
    rows = [
        ("fills (P, dP/dt)", (bound.RK_FILLS[order] * rk_fill + corr_fill)
         * c.q),
        ("monomials", solves * mono),
        ("term walk", solves * (bound.assembly_flops(c) - mono)),
        ("elimination", solves * bound.forward_flops(c)),
        ("back-substitution", solves * bound.backsub_flops(c)),
        ("step bookkeeping", bound.STEP_FLOPS[order] + 240 * corrector_iters),
    ]
    return rows, {"solves": solves, "steps": 1, "newton": corrector_iters}


def path_step_bytes(c):
    """Bytes of one path-step: x, x_last (in and out), the 8 flags (in and
    out) and the pair coefficients (in), as ``bound.tracker_bound``."""
    return 4 * 30 * 8 + 2 * 8 * 4 + 3 * c.q * 8


def roofline(flops, nbytes, step_us, paths):
    """The figures of a step of ``step_us`` µs over ``paths`` paths that
    each do ``flops`` FP32 operations and move ``nbytes`` bytes."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import bound

    secs = step_us * 1e-6
    t_ops = flops * paths / bound.PEAK_FLOPS * 1e6
    t_bytes = nbytes * paths / bound.PEAK_BYTES * 1e6
    bound_us = max(t_ops, t_bytes)
    return {"ns_per_path_step": step_us * 1e3 / paths,
            "gflops": flops * paths / secs / 1e9,
            "flops_share": flops * paths / secs / bound.PEAK_FLOPS,
            "gbytes": nbytes * paths / secs / 1e9,
            "bytes_share": nbytes * paths / secs / bound.PEAK_BYTES,
            "bound_us": bound_us,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_share": bound_us / step_us}


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        tooling,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corrector-iters", type=float, default=2.0)
    ap.add_argument("--step-us", type=float, default=None,
                    help="measured µs of one step over --paths paths")
    ap.add_argument("--paths", type=int, default=None)
    tooling.add_arguments(ap)
    args = ap.parse_args(argv)
    if (args.step_us is None) != (args.paths is None):
        ap.error("--step-us and --paths go together")

    from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        bound,
        fused,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
    )

    dev = tooling.device(args.platform, "roofline_torch")
    if dev is None:
        return 2
    print(tooling.card_line(dev), flush=True)
    cfg = config.config_for_data_root(args.data_root)
    c = fused.FusedConstants.build(trifocal.TrifocalProblem.load(cfg),
                                   solver=cfg.hc.solver)
    rows, work = step_work(c, args.corrector_iters)
    total = bound.tracker_flops(c, work)
    nbytes = path_step_bytes(c)
    print(f"Per-path, per-HC-step FP32 work ({c.solver} program, RK4: "
          f"{ORDER} RK solves + {args.corrector_iters:g} corrector "
          f"iterations; ops/bound.py counts):")
    for name, fl in rows:
        print(f"  {name:20s} {fl / 1e3:10.3f} kFLOP")
    print(f"  {'TOTAL':20s} {total / 1e3:10.3f} kFLOP "
          f"(bound.tracker_flops)")
    print(f"  bytes moved          {nbytes:10d} B -> {total / nbytes:.1f} "
          f"FLOP/B (the card's balance point "
          f"{bound.PEAK_FLOPS / bound.PEAK_BYTES:.1f} FLOP/B)")
    out = {"program": c.solver, "corrector_iters": args.corrector_iters,
           "phases": dict(rows), "flops_per_path_step": total,
           "bytes_per_path_step": nbytes, "device": str(dev)}
    if args.step_us is not None:
        r = roofline(total, nbytes, args.step_us, args.paths)
        out.update(step_us=args.step_us, paths=args.paths, **r)
        print(f"\nA measured step of {args.step_us} us over {args.paths} "
              f"paths:\n"
              f"  per path-step        {r['ns_per_path_step']:10.3f} ns\n"
              f"  achieved FP32 rate   {r['gflops']:10.3f} GFLOP/s = "
              f"{100 * r['flops_share']:.3f} % of "
              f"{bound.PEAK_FLOPS / 1e12:g} TFLOP/s\n"
              f"  achieved byte rate   {r['gbytes']:10.3f} GB/s = "
              f"{100 * r['bytes_share']:.3f} % of "
              f"{bound.PEAK_BYTES / 1e12:g} TB/s\n"
              f"  bound                {r['bound_us']:10.3f} us "
              f"({r['bound_by']}) -> the step runs at "
              f"{100 * r['bound_share']:.3f} % of its bound")
        print("  => latency-bound: neither the FP32 rate nor the bytes "
              "limit the step; its dependent chains (pivot steps, "
              "back-substitution sums) do." if r["bound_share"] < 0.25 else
              "  => near its bound")
    print(json.dumps({"roofline": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
