"""Hypothesis sharding: each shard of a mesh tracks a block of whole
hypotheses.

Counterpart of the JAX package's ``parallel/mesh.py``, which puts a 1-D
device mesh over the hypothesis axis (the reference's static split of the
RANSAC iterations over its GPUs, ``GPU_HC_Solver.cpp:84-88``).  Here a
mesh is an ordered list of ``torch.device``s, one per shard; one device may
stand in it several times (``["cpu"] * 4`` in the tests, ``["cuda:0"] * 2``
on a host with one card).  Shard i owns the i-th contiguous block of the
batch, so all paths of a hypothesis stay on one shard when the hypotheses
divide evenly (the engine pads them to whole shards).  Shards on a card
each run on a CUDA stream of their own, and results come back in global
path order on the mesh's first device.

Backends, as in the JAX package:

* ``"segmented"``: the production path.  Each shard runs the segmented
  driver (``ops/segmented.py``) on its block: the tracker kernel on the
  card, ``fused.track_plain`` on the CPU.  At every segment boundary the
  shards' loop tests are reduced: the loop goes on while any shard has an
  active path and, with the TrunRANSAC abort, no shard has found a pose,
  so one shard's hit stops every shard (the JAX ``pmax`` of
  ``[keep, found]``).  At the end the first shard that found gives
  ``found_path`` and the first shard with the largest support gives
  ``best_support`` and ``best_path`` (the JAX all_gather + argmax), each
  path index made global by the shard's offset.
* ``"fused"``: one call of the tracker over the whole budget per shard.
* ``"xla"``: the full-pivot oracle (``ops/tracker.py``) per shard; under
  ``predictor_handoff`` its batch-wide condition is then decided per
  shard, as in the JAX package.

The values the shards exchange are host scalars that the segment loop
reads back anyway, so the exchange runs on the host: a Python max within
one process, and with ``group`` (a ``torch.distributed`` gloo group, one
process per rank, each driving its own local shards) an all-reduce (MAX)
of a CPU int tensor per boundary and one all-gather of the abort's
outcome at the end.  Rank r's local shard i is global shard r x (local
shards) + i, and each rank passes and gets back its own block of the
batch.  NCCL is not used: it refuses two ranks on one card, and gloo never
sees a CUDA tensor here.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    segmented,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
    RansacConfig,
)

BACKENDS = ("segmented", "fused", "xla")
_FIELDS = ("x", "converged", "inf_fail", "pruned", "num_steps")


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The shards' devices, in shard order.

    devices: an explicit list, which may repeat a device; n_devices, if
    also given, must be its length.  Without it, the first n_devices CUDA
    cards (default all visible ones); raises when fewer are visible, and
    without a card."""
    if devices is not None:
        mesh = [_device(d) for d in devices]
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        if n_devices is not None and n_devices != len(mesh):
            raise ValueError(f"num_devices={n_devices} but {len(mesh)} "
                             f"devices given")
        return mesh
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass devices=['cpu'] * n to "
                           "shard on the CPU")
    visible = torch.cuda.device_count()
    n = visible if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"num_devices must be positive, got {n}")
    if n > visible:
        raise ValueError(f"num_devices={n} > visible devices {visible}")
    return [torch.device("cuda", i) for i in range(n)]


class _Shard:
    """One shard's device and its CUDA stream (None on the CPU)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)

    def enter(self):
        """A context in which this shard's stream is the current one."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def take(self, *tensors) -> list:
        """The caller's tensors (None passes) on this shard's device, for
        use on its stream: the stream waits for the work queued on the
        caller's stream so far, and the allocator keeps each tensor until
        the stream is done with it."""
        out = []
        for t in tensors:
            if t is not None and self.stream is not None and t.is_cuda:
                self.stream.wait_stream(torch.cuda.current_stream(t.device))
                t.record_stream(self.stream)
            with self.enter():
                out.append(None if t is None else t.to(self.device))
        return out


def _block(x0: torch.Tensor, shards: list) -> int:
    B, k = x0.shape[0], len(shards)
    if B % k:
        raise ValueError(f"{B} paths do not split into {k} equal shards: "
                         f"pad the hypotheses to whole shards")
    return B // k


def _gather(parts: list, shards: list, out: torch.device) -> fused.TrackResult:
    """The shards' results in global path order on ``out``, queued on the
    current streams behind the shards' work."""
    for sh, p in zip(shards, parts):
        if sh.stream is None:
            continue
        cur = torch.cuda.current_stream(sh.device)
        cur.wait_stream(sh.stream)
        for f in _FIELDS:
            getattr(p, f).record_stream(cur)
    return fused.TrackResult(**{
        f: torch.cat([getattr(p, f).to(out) for p in parts])
        for f in _FIELDS})


class _ShardedRun:
    """A segmented call over the shards, in the shape of
    ``segmented._Run``: ``advance`` dispatches every shard's next segment
    (on its own stream, none waiting for another), ``keep`` reads the
    shards' loop tests and reduces them, ``track_result`` and ``result``
    gather the shards' paths and select the abort's outcome."""

    def __init__(self, seg, shards: list, group, x0, target_params, edgels,
                 intrinsics, n_edgels):
        self.shards, self.group = shards, group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.b = _block(x0, shards)
        self.out = x0.device
        self.runs = []
        for i, sh in enumerate(shards):
            lo = i * self.b
            x, t, e, k = sh.take(x0[lo:lo + self.b],
                                 target_params[lo:lo + self.b], edgels,
                                 intrinsics)
            with sh.enter():
                self.runs.append(seg.begin(x, t, e, k, n_edgels))

    def advance(self) -> None:
        for sh, run in zip(self.shards, self.runs):
            with sh.enter():
                run.advance()

    def keep(self) -> bool:
        """Whether another segment runs: any shard (of any rank) keeps going
        and none has found a pose."""
        polls = [run.poll() for run in self.runs]
        keep = any(k for k, _ in polls)
        found = any(f for _, f in polls)
        if self.group is not None:
            flags = torch.tensor([keep, found], dtype=torch.int32)
            dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=self.group)
            keep, found = (bool(v) for v in flags.tolist())
        return keep and not found

    def track_result(self) -> fused.TrackResult:
        """This process's paths in their original order; queued, not waited
        for."""
        parts = []
        for sh, run in zip(self.shards, self.runs):
            with sh.enter():
                parts.append(run.track_result())
        return _gather(parts, self.shards, self.out)

    def result(self) -> segmented.SegmentedResult:
        res = self.track_result()
        rows = []
        for i, (sh, run) in enumerate(zip(self.shards, self.runs)):
            with sh.enter():
                found, fpath, bsupp, bpath = run.outcome()
            off = (self.rank * len(self.runs) + i) * self.b
            rows.append([found, fpath + off if fpath >= 0 else -1, bsupp,
                         bpath + off if bpath >= 0 else -1])
        table = torch.tensor(rows, dtype=torch.long)
        if self.group is not None:
            parts = [torch.empty_like(table)
                     for _ in range(dist.get_world_size(self.group))]
            dist.all_gather(parts, table, group=self.group)
            table = torch.cat(parts)
        table = table.numpy()
        found = bool(table[:, 0].any())
        first = int(np.argmax(table[:, 0] > 0))
        best = int(np.argmax(table[:, 2]))
        return segmented.SegmentedResult(
            track=res, found=found,
            found_path=int(table[first, 1]) if found else -1,
            best_support=int(table[best, 2]),
            best_path=int(table[best, 3]))


def make_sharded_track_fn(problem, hc: HCConfig, mesh: Sequence,
                          backend: str = "segmented",
                          ransac_cfg: Optional[RansacConfig] = None,
                          group=None):
    """Build the sharded tracker over ``mesh`` (``make_mesh``'s list).

    ``track(x0 (B, V), target_params (B, P+1)) -> TrackResult`` for the
    one-call backends "fused" and "xla"; for "segmented" ``track(x0,
    target_params, edgels=None, intrinsics=None, n_edgels=None) ->
    SegmentedResult`` and ``track.begin`` (the same arguments), a run not
    started, as ``segmented.make_segmented_track_fn`` gives (the engine's
    chunked abort round and its streams drive it).  B must divide evenly by
    the local shards; each takes B / shards paths.  The abort's scoring
    runs when ``ransac_cfg.abort_by_good_sol`` is set and needs the view's
    edgels and intrinsics.

    group: a ``torch.distributed`` gloo group of processes, each calling
    this with its own local mesh (the same number of shards on every rank)
    and its own block of the batch; the segmented backend reduces its loop
    test and its abort outcome over the group, the one-call backends
    exchange nothing."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: one of {BACKENDS}")
    mesh = [_device(d) for d in mesh]
    shards = [_Shard(d) for d in mesh]

    if backend == "segmented":
        seg = segmented.make_segmented_track_fn(problem, hc, ransac_cfg)

        def begin(x0, target_params, edgels=None, intrinsics=None,
                  n_edgels=None) -> _ShardedRun:
            return _ShardedRun(seg, shards, group, x0, target_params, edgels,
                               intrinsics, n_edgels)

        def track(x0, target_params, edgels=None, intrinsics=None,
                  n_edgels=None) -> segmented.SegmentedResult:
            run = begin(x0, target_params, edgels, intrinsics, n_edgels)
            run.advance()
            while run.keep():
                run.advance()
            return run.result()

        track.begin = begin
    else:
        fn = (tracker.make_track_fn(problem, hc) if backend == "xla"
              else fused.make_track_fn(problem, hc))

        def track(x0, target_params) -> fused.TrackResult:
            b = _block(x0, shards)
            parts = []
            for i, sh in enumerate(shards):
                x, t = sh.take(x0[i * b:(i + 1) * b],
                               target_params[i * b:(i + 1) * b])
                with sh.enter():
                    parts.append(fn(x, t))
            return _gather(parts, shards, x0.device)

    track.mesh = mesh
    track.backend = backend
    return track
