"""Monodromy start-system generation on the port's own trackers.

Counterpart of the JAX package's ``models/monodromy.py``: from a seed
parameter point p0 (the problem's start parameters) and some of its roots,
track loops p0 -> p1 -> p2 -> p0 through random complex parameter points;
the roots permute around each loop, and a landing point that Newton
polishes into a root not yet known is a new root.  The loop repeats until
the count reaches ``target_count`` or stops growing for ``patience``
loops.  Each leg runs the CUDA tracker (``ops/fused.make_track_fn``) with
``dynamic_start=True`` (each path's start system is target - diff) and
TrunPaths off (at complex parameter points no root is real geometry);
the polish is Newton on ``ops/linalg.solve_batched``.

Run it on the card:

    python -m trifocal_pose_estimation_using_improved_gpuhc_torch.models.monodromy \\
        [--seeds N] [--max-loops 30] [--rng-seed 0] [--out-dir DIR] \\
        [--data-root DIR] [--platform gpu|cpu]

It writes ``start_params.txt`` / ``start_sols.txt`` into ``--out-dir`` in
the reference format (``utils/data_io`` reads them back).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
)


@dataclasses.dataclass
class MonodromyResult:
    params: np.ndarray      # (P+1,) complex64 seed parameter point
    solutions: np.ndarray   # (N, V) complex64 distinct roots at params
    loops_run: int
    history: list           # solution count after each loop


def _device(device) -> torch.device:
    """None is the first CUDA card, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda:0"
    return torch.device(device)


def make_refiner(problem: TrifocalProblem, batch: int, iters: int = 3,
                 device=None):
    """Newton-polish roots at a fixed parameter point, on ``device`` (None:
    the first CUDA card).

    Returns refine(x (B, V) complex64, params (P+1,)) -> (x_refined,
    residual_inf (B,)) as numpy, the residual max_e |Re H_e| + |Im H_e|
    after ``iters`` iterations.  Batches are padded to a multiple of
    ``batch`` by repeating the first root."""
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        eval as ev,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import linalg

    dev = _device(device)
    tables = ev.factored_tables(problem, dev)

    def refine(x: np.ndarray, params: np.ndarray):
        B = x.shape[0]
        Bp = -(-B // batch) * batch
        if Bp != B:
            x = np.concatenate(
                [x, np.broadcast_to(x[:1], (Bp - B,) + x.shape[1:])])
        xt = torch.as_tensor(np.asarray(x, np.complex64), device=dev)
        p = torch.as_tensor(np.asarray(params, np.complex64),
                            device=dev).expand(Bp, -1)
        for _ in range(iters):
            hx, h, _ = ev.eval_all_factored(problem, xt, p, p, need_h=True,
                                            need_ht=False, tables=tables)
            xt = xt - linalg.solve_batched(hx, h)
        _, h, _ = ev.eval_all_factored(problem, xt, p, p, need_h=True,
                                       need_ht=False, tables=tables)
        res = (h.real.abs() + h.imag.abs()).max(dim=1).values
        return xt[:B].cpu().numpy(), res[:B].cpu().numpy()

    return refine


def _dedup(sols: np.ndarray, new: np.ndarray, tol: float) -> np.ndarray:
    """Append rows of ``new`` not already present in ``sols``.

    Relative inf-norm distance (duplicate-solution test of
    Evaluations.cpp:184-233 with a scale-aware tolerance)."""
    out = sols
    for row in new:
        if out.size == 0:
            out = row[None]
            continue
        scale = max(1.0, float(np.abs(row).max()))
        if np.min(np.max(np.abs(out - row[None]), axis=1)) > tol * scale:
            out = np.concatenate([out, row[None]])
    return out


def monodromy_solve(
    problem: TrifocalProblem,
    cfg: HCConfig,
    seed_sols: Optional[np.ndarray] = None,
    target_count: Optional[int] = None,
    max_loops: int = 30,
    patience: int = 3,
    rng_seed: int = 0,
    dedup_tol: float = 1e-3,
    perturb_scale: float = 1.0,
    track_fn=None,
    leg_batch: Optional[int] = None,
    device=None,
) -> MonodromyResult:
    """Grow a solution set at the problem's start parameters via monodromy.

    seed_sols: initial known roots at problem.start_params (defaults to
    the committed start solutions; pass a subset to exercise discovery).
    track_fn: a ``track(x0, tgt, diff) -> TrackResult`` on tensors, built
    with ``dynamic_start=True`` (default: the CUDA tracker with TrunPaths
    off).  device: where the legs and the polish run (None: the first CUDA
    card, and an error without one)."""
    dev = _device(device)
    p0 = np.asarray(problem.start_params).astype(np.complex64)
    npar = p0.shape[0] - 1  # last slot is the constant 1
    if seed_sols is None:
        seed_sols = np.asarray(problem.start_sols)
    sols = np.asarray(seed_sols, np.complex64).copy()
    if target_count is None:
        target_count = problem.num_tracks

    if track_fn is None:
        from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
            fused,
        )

        # Depth-sign pruning is a RANSAC heuristic (real geometry); at
        # random complex parameter points every root is complex, so the
        # legs track untruncated.
        track_fn = fused.make_track_fn(
            problem, dataclasses.replace(cfg, truncate_paths=False),
            dynamic_start=True)

    rng = np.random.default_rng(rng_seed)
    history = []
    stagnant = 0
    loops = 0
    refiner = None
    residual_tol = 1e-3

    # A fixed leg batch: the legs' shapes stay the same as the solution
    # set grows (padded by repeating the first root).
    if leg_batch is None:
        leg_batch = max(target_count, problem.num_tracks)

    def leg(x_from: np.ndarray, p_from: np.ndarray, p_to: np.ndarray):
        B = x_from.shape[0]
        Bp = -(-B // leg_batch) * leg_batch
        if Bp != B:
            x_from = np.concatenate(
                [x_from,
                 np.broadcast_to(x_from[:1], (Bp - B,) + x_from.shape[1:])])
        tgt = np.broadcast_to(p_to, (Bp, p0.shape[0])).astype(np.complex64)
        diff = (p_to - p_from)[None].repeat(Bp, axis=0).astype(np.complex64)
        res = track_fn(torch.as_tensor(np.asarray(x_from, np.complex64),
                                       device=dev),
                       torch.as_tensor(tgt, device=dev),
                       torch.as_tensor(diff, device=dev))
        return res.x[:B].cpu().numpy(), res.converged[:B].cpu().numpy()

    for loops in range(1, max_loops + 1):
        # Random complex waypoints around the seed point.
        way = []
        for _ in range(2):
            z = p0.copy()
            z[:npar] = z[:npar] + perturb_scale * (
                rng.standard_normal(npar) + 1j * rng.standard_normal(npar)
            ).astype(np.complex64)
            way.append(z)

        x, ok = leg(sols, p0, way[0])
        x, ok2 = leg(x, way[0], way[1])
        x, ok3 = leg(x, way[1], p0)
        good = ok & ok2 & ok3
        # Newton-polish the landing points at p0 and accept only true
        # roots; unpolished end-zone error defeats duplicate detection.
        if refiner is None:
            refiner = make_refiner(problem, batch=leg_batch, device=dev)
        cand, res = refiner(x[good], p0)
        cand = cand[res < residual_tol]
        before = sols.shape[0]
        sols = _dedup(sols, cand, dedup_tol)
        history.append(int(sols.shape[0]))
        if sols.shape[0] == before:
            stagnant += 1
        else:
            stagnant = 0
        if sols.shape[0] >= target_count or stagnant >= patience:
            break

    return MonodromyResult(
        params=p0, solutions=sols, loops_run=loops, history=history)


def write_start_system(
    path_params: str, path_sols: str, result: MonodromyResult
) -> None:
    """Write start_params.txt / start_sols.txt in the reference format:
    one "re im" pair per line, num_params lines / num_tracks*num_vars lines
    (Data_Reader.cpp:37-60,104-121; utils/data_io.py round-trips them)."""
    with open(path_params, "w") as f:
        for z in result.params[:-1]:  # constant-1 slot is implicit
            f.write(f"{z.real:.17g}\t{z.imag:.17g}\n")
    with open(path_sols, "w") as f:
        for row in result.solutions:
            for z in row:
                f.write(f"{z.real:.17g}\t{z.imag:.17g}\n")


def main(argv=None) -> int:
    """Regenerate the start system (see the module docstring)."""
    import argparse
    import os
    import sys
    import time

    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
        config_for_data_root,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=None,
                    help="use only the first N committed roots as seeds "
                         "(default: all -- verifies closure)")
    ap.add_argument("--max-loops", type=int, default=30)
    ap.add_argument("--rng-seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None,
                    help="write start_params.txt / start_sols.txt here")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("-p", "--problem", default="trifocal_2op1p_30x30")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu: the first CUDA card (an error without one); "
                         "cpu: run on the CPU")
    args = ap.parse_args(argv)

    if args.platform == "gpu" and not torch.cuda.is_available():
        print("no CUDA device; pass --platform cpu to run on the CPU",
              file=sys.stderr)
        return 2
    cfg = config_for_data_root(args.data_root, args.problem)
    problem = TrifocalProblem.load(cfg)
    seeds = None
    if args.seeds is not None:
        seeds = np.asarray(problem.start_sols)[: args.seeds]
    t0 = time.perf_counter()
    res = monodromy_solve(
        problem, cfg.hc, seed_sols=seeds, max_loops=args.max_loops,
        rng_seed=args.rng_seed,
        device="cpu" if args.platform == "cpu" else None)
    print(f"monodromy: {res.loops_run} loops, growth {res.history} in "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"solutions: {res.solutions.shape[0]} / {problem.num_tracks}")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        write_start_system(
            os.path.join(args.out_dir, "start_params.txt"),
            os.path.join(args.out_dir, "start_sols.txt"),
            res,
        )
        print(f"wrote start system to {args.out_dir}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
