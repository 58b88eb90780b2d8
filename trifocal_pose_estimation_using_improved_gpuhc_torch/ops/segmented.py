"""Segmented path tracking: survivor compaction and the TrunRANSAC abort.

Counterpart of the JAX package's ``ops/segmented.py``.  Tracking runs in
segments of ``segment_steps`` HC steps on resumable state (x, x_last,
flags): one launch of the CUDA kernel per segment for tensors on the card,
``fused.track_plain`` for tensors on the CPU; the last segment gets the
steps left of the budget.  Between segments:

* with ``abort_by_good_sol``, ``_score_new`` scores up to 128 paths that
  converged since the last boundary: the imaginary gate on the 12 pose
  components, Cayley -> R, inlier counts over every edgel for both view
  pairs, and the found test (both supports >= ratio x edgels).  It keeps
  the running best support and its path and the first found path.  Paths
  beyond the 128 slots wait for the next boundary and are never dropped.
  A found flag ends the tracking at that boundary.  On the card this is one
  launch of ``csrc/hc_score.cu`` (``_kernels.hc_score``), which updates the
  run's state in place; on the CPU it is the eager ``_score_plain``, the
  kernel's plain twin, bit for bit;
* with ``compact_survivors``, the paths are packed by the JAX package's
  key: active paths first, ordered by 1 - t, then the finished ones, in a
  stable sort.  The next segment then launches over the active prefix
  only; a launch over all paths would give the same results, since the
  kernel leaves a finished path untouched.  The packing is undone at the
  end.

Segmenting and packing only reschedule the work: per path, the flags, the
step counts and x are those of one call over the whole budget.  Except
under ``predictor_handoff``: the kernel keeps the corrector's elimination
only within a launch (``track_plain`` within a call), so every segment's
first step starts with a full stage-1 solve, as the JAX kernel's does (it
resets its handoff flag at every launch).  There segmented tracking is not
one call path for path, in the JAX package either; it is each segment's
call on the carried state.

The loop ends when no path is active, when the budget is spent, or when
the found flag is set.  The JAX package keeps that test on the device in
a while loop; eager PyTorch reads it once per segment: 24 bytes (the
active count, the run's own loop test and the found flag, kept apart so
that a sharded run can reduce them over its shards), copied behind the
segment's work and waited for by an event, which is cheap on a local
card.  ``parallel/mesh.py`` drives one run per shard of the hypotheses
and reduces the loop test across them at every boundary, as the JAX
package's ``axis_name`` branches do.

Each run records, in the current request's recorder (``utils/spans``;
nothing without one), a ``segment.launch`` (the segment's launch queued),
a ``segment.boundary`` (scoring, compaction, the loop test queued) and a
``segment.wait`` (the loop test waited for) span per segment; an abort
run's ``outcome`` also records the counters ``scored_paths`` and
``score_slots``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused, ransac
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import spans
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
    RansacConfig,
)

# Converged paths scored per segment boundary.
_SCORE_SLOTS = 128


class SegmentedResult(NamedTuple):
    """TrackResult fields + TrunRANSAC outputs."""

    track: fused.TrackResult
    found: bool            # a pose with the pass support was found
    found_path: int        # path index of the first found pose (-1)
    best_support: int      # best min(n21, n31) among scored paths (-1)
    best_path: int         # path index of that candidate (-1)


def active_mask(hc: HCConfig, fl: torch.Tensor) -> torch.Tensor:
    """(B,) bool: not converged, not diverged, not pruned."""
    t = fl[:, fused._F_T]
    conv = (t >= 1.0) | (1.0 - t <= hc.t_converged_eps)
    return ~conv & (fl[:, fused._F_INF] < 0.5) & (fl[:, fused._F_PRN] < 0.5)


def compaction_order(hc: HCConfig, fl: torch.Tensor) -> torch.Tensor:
    """The packing permutation: active paths first by 1 - t, then the
    finished ones, stable."""
    key = torch.where(active_mask(hc, fl), 1.0 - fl[:, fused._F_T],
                      torch.full_like(fl[:, fused._F_T], 2.0))
    return torch.argsort(key, stable=True)


def score_slots(hc: HCConfig, fl: torch.Tensor,
                scored: torch.Tensor) -> tuple:
    """The paths ``_score_new`` takes at a boundary: the first
    _SCORE_SLOTS of the newly converged paths (converged, not yet scored),
    in path order.  Returns (slot path indices, valid mask); an invalid
    slot holds a path that is not newly converged."""
    t = fl[:, fused._F_T]
    newly = ((t >= 1.0) | (1.0 - t <= hc.t_converged_eps)) & ~scored
    sidx = torch.argsort((~newly).to(torch.int32), stable=True)
    sidx = sidx[:_SCORE_SLOTS]
    return sidx, newly[sidx]


class Readback:
    """A device tensor's copy to the host, queued behind the work on the
    stream so far and waited for by an event: ``wait`` returns once that
    work is done, whatever was queued after it.  (A plain ``.cpu()`` waits
    for everything queued on the stream.)  On the CPU it is the tensor."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        self.host = t
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


class _Run:
    """One segmented tracking call in progress (see the module docstring).

    ``advance`` dispatches one segment and the boundary work and queues the
    loop test; ``keep`` reads it (``poll`` reads its two parts);
    ``track_result`` undoes the packing and ``result`` also reads the
    abort's outcome.  Two runs advanced in turns keep the card busy: while
    the host waits for one run's loop test and queues its next segment, the
    card tracks the other's.  A run with no active path launches nothing
    when advanced (a shard of a sharded run that goes on for the others'
    sake); its scoring and packing still run, as in the JAX package's
    sharded loop."""

    def __init__(self, tr: "_Tracker", x0, target_params, edgels, intrinsics,
                 n_edgels):
        if x0.device != target_params.device:
            raise ValueError("x0 and target_params must share a device")
        self.tr = tr
        dev = x0.device
        self.dev = dev
        perm, self.inv, self.aux = tr.on(dev)
        # Positions of T21, T31, Cayley21, Cayley31 (variables 18-29).
        self.pose_rows = self.inv[18:30]
        self.x = x0[:, perm].contiguous()
        self.xl = self.x.clone()
        B = self.x.shape[0]
        self.fl = fused.init_flags(tr.hc, B, dev)
        self.efg = fused.build_pair_coefs(tr.problem, target_params,
                                          tr.hc.pair_coef_basis)
        self.order = torch.arange(B, device=dev)
        self.scored = torch.zeros(B, dtype=torch.bool, device=dev)
        self.found = torch.zeros((), dtype=torch.bool, device=dev)
        self.found_path = torch.full((), -1, dtype=torch.long, device=dev)
        self.best_supp = torch.full((), -1, dtype=torch.long, device=dev)
        self.best_path = torch.full((), -1, dtype=torch.long, device=dev)
        if tr.abort:
            if edgels is None:
                raise ValueError("the abort round needs the view's edgels")
            self.edgels = edgels.contiguous()   # the kernel reads rows
            self.kmat = intrinsics
            # The pass test in float32, as the reference computes it.
            self.need = float(np.float32(tr.ratio) * np.float32(
                n_edgels if n_edgels is not None else len(edgels)))
            if dev.type == "cuda":
                self.score_work = tr.score_workspace(dev)
        self.si = 0
        self.n_live = B   # paths the next launch covers
        self.n_active = B
        self._flag = None
        self.work = None  # track_plain's work counts, if asked for
        self.launches = 0  # this run's kernel launches

    def advance(self) -> None:
        with spans.span("segment.launch"):
            self._launch()
        with spans.span("segment.boundary"):
            self._boundary()

    def _launch(self) -> None:
        """The next segment, queued."""
        tr, hc = self.tr, self.tr.hc
        niter = min(tr.seg, tr.budget - self.si * tr.seg)
        n = self.n_live
        if self.n_active and isinstance(self.aux, fused._Tables):
            self.x[:n], self.xl[:n], self.fl[:n] = fused.track_plain(
                tr.consts, hc, self.x[:n], self.xl[:n], self.fl[:n],
                self.efg[:n], niter=niter, tables=self.aux, work=self.work)
        elif self.n_active:
            tr.kernels.hc_track(self.x[:n], self.xl[:n], self.fl[:n],
                                self.efg[:n], self.aux, niter, hc)
            self.launches += 1

    def _boundary(self) -> None:
        """The boundary's scoring and packing, and its loop test, queued."""
        tr, hc = self.tr, self.tr.hc
        if tr.abort:
            self._score_new()
        if hc.compact_survivors:
            idx = compaction_order(hc, self.fl)
            self.x, self.xl, self.fl, self.efg, self.order, self.scored = (
                a[idx] for a in (self.x, self.xl, self.fl, self.efg,
                                 self.order, self.scored))
        self.si += 1
        active = active_mask(hc, self.fl)
        n_active = active.sum()
        keep = (n_active > 0) & (self.si < tr.n_segments)
        self._flag = Readback(torch.stack([n_active, keep.to(n_active.dtype),
                                           self.found.to(n_active.dtype)]))

    def poll(self) -> tuple:
        """(this run's loop test without the found flag, the found flag):
        waits for the queued loop test."""
        with spans.span("segment.wait"):
            n_active, keep, found = self._flag.wait().tolist()
        self.n_active = n_active
        if self.tr.hc.compact_survivors:
            self.n_live = n_active
        return bool(keep), bool(found)

    def keep(self) -> bool:
        """Whether another segment runs: waits for the queued loop test."""
        keep, found = self.poll()
        return keep and not found

    def _score_new(self) -> None:
        """Score newly converged paths (the module docstring's gate): on
        the card in one launch of ``_kernels.hc_score``, on the CPU by
        ``_score_plain``."""
        if self.dev.type != "cuda":
            self._score_plain()
            return
        tr = self.tr
        tr.kernels.hc_score(
            self.x, self.fl, self.scored, self.order, self.pose_rows,
            self.edgels, self.kmat, self.found, self.found_path,
            self.best_supp, self.best_path, self.score_work, _SCORE_SLOTS,
            fused._F_T, tr.hc.t_converged_eps, tr.imag_tol, tr.thresh_px,
            self.need)

    def _score_plain(self) -> None:
        """``_score_new`` in eager PyTorch: the kernel's plain twin."""
        tr = self.tr
        sidx, valid = score_slots(tr.hc, self.fl, self.scored)
        self.scored[sidx] = self.scored[sidx] | valid
        xs = self.x[sidx]
        pr = xs.real[:, self.pose_rows]        # (S, 12)
        pi = xs.imag[:, self.pose_rows]
        gate = pi.abs().amax(dim=1) < tr.imag_tol
        r21 = trifocal.cayley_to_rotation(pr[:, 6:9])
        r31 = trifocal.cayley_to_rotation(pr[:, 9:12])
        n21, n31 = ransac.count_inlier_support(
            r21, r31, pr[:, 0:3], pr[:, 3:6], self.edgels, self.kmat,
            thresh_px=tr.thresh_px)
        ok = valid & gate
        hit = ok & (n21.float() >= self.need) & (n31.float() >= self.need)
        found = hit.any()
        first = torch.argmax(hit.to(torch.int32))
        fp = torch.where(found, self.order[sidx[first]], -1)
        self.found_path = torch.where(self.found, self.found_path, fp)
        self.found = self.found | found
        smin = torch.where(ok, torch.minimum(n21, n31), -1)
        sbest = torch.argmax(smin)
        better = smin[sbest] > self.best_supp
        self.best_supp = torch.where(better, smin[sbest], self.best_supp)
        self.best_path = torch.where(better, self.order[sidx[sbest]],
                                     self.best_path)

    def track_result(self) -> fused.TrackResult:
        """The paths in their original order; queued, not waited for."""
        unperm = torch.argsort(self.order)
        x = self.x[unperm][:, self.inv]
        conv, inf, pruned, steps = fused.flags_outputs(self.tr.hc,
                                                       self.fl[unperm])
        return fused.TrackResult(x=x, converged=conv, inf_fail=inf,
                                 pruned=pruned, num_steps=steps)

    def outcome(self) -> list:
        """The abort's outcome [found, found_path, best_support,
        best_path], read in one copy.  An abort run reads the number of
        paths it scored in the same copy and records it beside the scoring
        slots its boundaries computed (``min(_SCORE_SLOTS, paths)`` each)."""
        row = [self.found.long(), self.found_path, self.best_supp,
               self.best_path]
        if not self.tr.abort:
            return torch.stack(row).tolist()
        *out, n_scored = torch.stack(row + [self.scored.sum()]).tolist()
        spans.count("scored_paths", n_scored)
        spans.count("score_slots", self.si * min(_SCORE_SLOTS, len(self.fl)))
        return out

    def result(self) -> SegmentedResult:
        found, fpath, bsupp, bpath = self.outcome()
        return SegmentedResult(
            track=self.track_result(), found=bool(found), found_path=fpath,
            best_support=bsupp, best_path=bpath)


class _Tracker:
    """The per-problem constants of make_segmented_track_fn."""

    def __init__(self, problem, hc: HCConfig,
                 ransac_cfg: Optional[RansacConfig], plain: bool):
        from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
            _kernels,
        )

        self.kernels = _kernels
        self.problem = problem
        self.hc = hc
        # rk_jacobian_reuse runs the schedule program, as in the JAX
        # package's segmented tracker.
        self.consts = fused.FusedConstants.build(problem,
                                                 solver=fused.solver_of(hc))
        fused.check_variant(hc, self.consts)
        self.on = fused.device_constants(self.consts, plain)
        self.seg = max(1, hc.segment_steps)
        self.budget = hc.max_steps + 1
        self.n_segments = -(-self.budget // self.seg)
        self.abort = bool(ransac_cfg and ransac_cfg.abort_by_good_sol)
        rc = ransac_cfg or RansacConfig()
        self.imag_tol = rc.imag_part_tol
        self.thresh_px = rc.reproj_inlier_thresh_px
        self.ratio = rc.pass_inlier_support_ratio
        self._built = False

    def score_workspace(self, dev) -> torch.Tensor:
        """A workspace of the boundary scoring kernel on card ``dev``.  The
        first builds the tracker's variant and the scoring's library
        together, nvcc in parallel (each is otherwise built at its first
        launch)."""
        if not self._built:
            self.kernels.build_hc_track(
                [self.hc], also=[self.kernels.hc_score_job(_SCORE_SLOTS)])
            self._built = True
        return self.kernels.hc_score_workspace(dev, _SCORE_SLOTS)


def make_segmented_track_fn(problem, hc: HCConfig,
                            ransac_cfg: Optional[RansacConfig] = None,
                            plain: bool = False):
    """Build ``track(x0 (B, V), target_params (B, P+1), edgels=None,
    intrinsics=None, n_edgels=None, work=None) -> SegmentedResult``.

    With ``plain`` every segment runs ``fused.track_plain``, on the card
    too (the segmented kernel's reference), and ``work`` is its dict of
    work counts (see ``track_plain``).

    Scoring runs only when ``ransac_cfg.abort_by_good_sol`` is set, and
    then needs the view's edgels (N, 6) and intrinsics (3, 3) on the
    tensors' device.  ``track.begin`` starts a call without running it
    (see ``_Run``), for the engine's chunked abort round."""
    tr = _Tracker(problem, hc, ransac_cfg, plain)

    def begin(x0, target_params, edgels=None, intrinsics=None,
              n_edgels=None) -> _Run:
        return _Run(tr, x0, target_params, edgels, intrinsics, n_edgels)

    def track(x0, target_params, edgels=None, intrinsics=None,
              n_edgels=None, work=None) -> SegmentedResult:
        run = begin(x0, target_params, edgels, intrinsics, n_edgels)
        if work is not None and not isinstance(run.aux, fused._Tables):
            raise ValueError("work is counted by track_plain only")
        run.work = work
        run.advance()
        while run.keep():
            run.advance()
        return run.result()

    track.begin = begin
    track.constants = tr.consts
    return track
