"""Hypothesis sharding across two real processes, gloo on the CPU.

The counterpart of tests/test_multihost.py and tests/multihost_worker.py
for the port.  This file's ``__main__`` is the worker: the test starts two
of them (ranks 0 and 1), each joining a ``torch.distributed`` gloo group
over ``tcp://127.0.0.1`` and driving two local CPU shards, so the global
mesh has four.  Each rank passes its half of the batch.

* The local shards equal the unsharded oracle's slice: 8 hypotheses of
  view 0 over the first 16 roots, ``max_steps=3``, each rank's half
  through ``make_sharded_track_fn(backend="xla", group=...)`` against the
  oracle over the whole batch (flags and steps exactly, x within 1e-3
  relative: the oracle's rounding may depend on the batch's size).
* A found flag raised on rank 1 reaches rank 0 through the segment loop's
  reduction: rank 1's first hypothesis targets the start parameters, the
  pass ratio is 0, the imaginary tolerance huge and TrunPaths off (the
  cross-shard abort of tests/test_torch_mesh.py); rank 0 reads found, a
  global found_path in rank 1's block, and its own paths stopped before
  their budget.

Usage of the worker: python tests/test_torch_multiprocess.py RANK PORT
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORLD = 2
_LOCAL_SHARDS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reports():
    """Both ranks' reports, after both exited 0 within the timeout."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(_WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text}"
        line = [ln for ln in text.splitlines() if ln.startswith("{")][-1]
        out.append(json.loads(line))
    return out


def test_local_shards_equal_the_oracle_slice(reports):
    for r in reports:
        assert r["flags_equal"] == ["converged", "inf_fail", "pruned",
                                    "num_steps"], r
        assert r["x_rel_err"] < 1e-3, r


def test_found_on_rank1_reaches_rank0(reports):
    r0, r1 = reports
    for r in reports:
        lo, hi = r["rank1_block"]
        assert r["found"] and lo <= r["found_path"] < hi, r
    assert r0["found_path"] == r1["found_path"]
    # Rank 0 converges no path of its own: its stop came from rank 1.
    assert r0["own_converged"] == 0 and r0["own_max_steps"] < r0["budget"], r0


def _worker(rank: int, port: int) -> int:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        ransac,
        tracker,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
        mesh as pmesh,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config,
        data_io,
    )

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=_WORLD, rank=rank)
    try:
        cfg = config.EngineConfig()
        problem = trifocal.TrifocalProblem.load(cfg)
        view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
        mesh = pmesh.make_mesh(devices=["cpu"] * _LOCAL_SHARDS)

        def workload(H, T, trivial=()):
            s = ransac.sample_edgel_triplets(3, view.edge_locations.shape[0],
                                             H)
            tgt = ransac.build_target_params(view.edge_locations,
                                             view.edge_tangents, s)
            tgt[list(trivial)] = problem.start_params
            return (torch.as_tensor(np.tile(np.asarray(problem.start_sols)[:T],
                                            (H, 1))),
                    torch.as_tensor(np.repeat(tgt, T, axis=0)))

        # The local shards against the unsharded oracle's slice.
        H, T = 8, 16
        hc = dataclasses.replace(cfg.hc, max_steps=3)
        x0, tgt = workload(H, T)
        B = H * T // _WORLD
        lo, hi = rank * B, (rank + 1) * B
        local = pmesh.make_sharded_track_fn(
            problem, hc, mesh, backend="xla", group=dist.group.WORLD)(
                x0[lo:hi], tgt[lo:hi])
        ref = tracker.make_track_fn(problem, hc)(x0, tgt)
        flags_equal = [f for f in ("converged", "inf_fail", "pruned",
                                   "num_steps")
                       if torch.equal(getattr(local, f),
                                      getattr(ref, f)[lo:hi])]
        scale = ref.x[lo:hi].abs().amax(dim=1).clamp(min=1.0)
        err = ((local.x - ref.x[lo:hi]).abs().amax(dim=1) / scale).max()

        # The abort raised on rank 1 stops rank 0.
        H, T = 4, 8
        hc = dataclasses.replace(cfg.hc, max_steps=16, segment_steps=2,
                                 init_delta_t=0.5, truncate_paths=False)
        rc = dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                                 pass_inlier_support_ratio=0.0,
                                 imag_part_tol=1e9)
        x0, tgt = workload(H, T, trivial=[H // _WORLD])
        B = H * T // _WORLD
        lo, hi = rank * B, (rank + 1) * B
        res = pmesh.make_sharded_track_fn(
            problem, hc, mesh, ransac_cfg=rc, group=dist.group.WORLD)(
                x0[lo:hi], tgt[lo:hi],
                torch.as_tensor(view.edge_locations[:64]), torch.eye(3), 64)
        print(json.dumps(dict(
            rank=rank, flags_equal=flags_equal, x_rel_err=float(err),
            found=res.found, found_path=res.found_path,
            rank1_block=[B, 2 * B], budget=hc.max_steps,
            own_converged=int(res.track.converged.sum()),
            own_max_steps=int(res.track.num_steps.max()))), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2])))
