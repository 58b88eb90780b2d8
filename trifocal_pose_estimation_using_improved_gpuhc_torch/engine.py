"""One RANSAC round of trifocal pose estimation over HC path tracking.

Counterpart of the JAX package's ``engine.py`` (``run_round``): sample
edgel triplets, build target parameters, track num_tracks x H paths,
score the converged candidates on the device, pick the best-supported
pose and measure its residuals against ground truth.  The tracker is the
JAX engine's choice: for ``backend="fused"`` the segmented one
(``ops/segmented.py``) when survivor compaction or the TrunRANSAC abort is
on, else one call over the whole budget (``ops/fused.py``); for
``backend="xla"`` the full-pivot oracle (``ops/tracker.py``) in one call;
for ``backend="p2c"`` the kernel on the P2C coefficient plan
(``ops/p2c.py``, its coefficient map derived once, at construction) in one
call.  With ``abort_by_good_sol`` the segmented round tracks the
hypotheses in chunks and stops at the first chunk that finds a pose; the
oracle's and the P2C rounds, as in the JAX engine, track them all.
Every round scores its candidates as the JAX engine's ``_score_round``
does; ``run_round(..., collect_solutions=True)`` also returns every path's
solution, the candidates' fundamental matrices and the residuals' minima
over all candidates;
``run_stream`` serves a sequence of views, two in flight on the card, and
reads back one 39-float selection per view (per chunk with the abort).

It runs the configurations ``utils/config.check_shipped`` accepts: either
solve program, and the step variants predictor "rk4" (the default), "rk3"
or "rk2", ``corrector_jacobian_reuse`` 1 or 2, ``predictor_handoff``
(decided per tile of ``tile`` paths) and ``rk_jacobian_reuse`` (which runs
the schedule program),
the last two not together, and the evaluation variants eval_precision
"split3_rk2", pair_coef_basis "abc" and eval_structure "gathered" or
"merged", with any of those; each variant of the step or of the first two
is a build of the tracker kernel of its own.

The engine runs on the card (``cuda:0``) unless the caller asks for
another device, and never moves work elsewhere.  Unlike the JAX engine,
which tracks with its oracle whenever it runs on the CPU, it keeps the
configured backend on every device: on the CPU ``backend="fused"`` runs
``fused.track_plain``, the kernel's twin.

With ``num_devices`` above 1 the hypotheses are sharded over a mesh
(``parallel/mesh.py``): by default the first ``num_devices`` cards, or
the caller's list of devices, one per shard (one device may repeat).  As
in the JAX engine (its ``engine.py:96-128``, ``:377-381``, ``:410``,
``:795-797``), the tracker is the sharded segmented one when compaction or
the abort is on, else one sharded call, or the sharded oracle; H is padded
to whole shards with real samples (the first H of them are the unpadded
round's), which are tracked and then sliced away; and the abort chunks
are rounded up to whole shards.  Padded hypotheses and a ragged tail's
repeats lie in the last chunk: a hit among them stops no chunk that would
otherwise run, but, as in the JAX engine, it ends that chunk's tracking at
the boundary where it is found, the real paths' too.  The round's outcome
is scored over the real hypotheses only.  Staging, scoring and the
stream's selection run on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    fused,
    p2c,
    ransac,
    segmented,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
    mesh as pmesh,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import data_io, spans
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import evaluation as evl
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    EngineConfig,
    check_shipped,
    problem_dir,
    ransac_data_dir,
)

_SCORE_CHUNK = 1024  # paths per scoring chunk: bounds the (paths x edgels) block


@dataclasses.dataclass
class RoundResult:
    """One RANSAC round on one view triplet."""

    stats: evl.SolutionStats
    track_ms: float          # tracking to the decision, synchronised
    total_ms: float          # tracking + scoring + selection
    num_candidates: int
    best_support21: int
    best_support31: int
    num_edgels: int
    found_pose: bool          # >= 0.9 support on both pairs
    pose_errors: Optional[evl.PoseErrors]
    best_pose: Optional[tuple]  # (R21, R31, t21, t31) numpy
    num_steps: np.ndarray     # per-path HC step counts
    # HC step counts of the max-support solutions (union over both pairs).
    actual_sol_steps: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    # collect_solutions rounds: the candidates' fundamental matrices,
    # (n_cand, 3, 3) each; each residual's minimum over all candidate poses
    # and whether one pose has all four within tolerance.
    cand_f21: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 3), np.float32)
    )
    cand_f31: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 3), np.float32)
    )
    min_residuals: Optional[evl.PoseErrors] = None
    any_within_gt: bool = False
    # Per-path outcomes, for cross-checks against the reference (also in
    # ``solutions`` when the round collects).
    converged: Optional[np.ndarray] = None
    inf_fail: Optional[np.ndarray] = None
    pruned: Optional[np.ndarray] = None
    # Abort rounds: the chunks tracked before the round stopped.
    chunks_run: int = 1
    # collect_solutions rounds: every real path's outcome, as host numpy
    # arrays in a TrackResult (chunks an abort round skipped: x 0, not
    # converged, 0 steps).  Its flags and steps are the arrays above, not
    # copies of them.
    solutions: Optional[fused.TrackResult] = None
    # The request's spans (name, start_ns, end_ns, parent index) and
    # counters (``utils/spans``): run_round's round, run_stream's view.
    spans: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)


class _OneCall:
    """A one-call tracker's run, in the shape of ``segmented._Run`` (one
    advance, then done), so that the stream drives both alike."""

    def __init__(self, track, x0, target_params):
        self._call = lambda: track(x0, target_params)
        self._res = None

    def advance(self) -> None:
        self._res = self._call()

    def keep(self) -> bool:
        return False

    def track_result(self) -> fused.TrackResult:
        return self._res


class TrifocalPoseEngine:
    def __init__(self, cfg: EngineConfig, device=None, track_fn=None):
        """device: None means the first CUDA card (the first num_devices
        cards when sharded), and raises without them; else a device, or a
        list of num_devices devices, one per shard.  track_fn: a one-call
        tracker ``(x0, target_params) -> TrackResult`` in place of the
        configured one (the abort round needs the segmented tracker, and a
        sharded engine its sharded one, so they refuse one)."""
        check_shipped(cfg)
        self._ndev = cfg.num_devices or 1
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device; pass device='cpu' to run on the CPU")
            self.mesh = pmesh.make_mesh(self._ndev)
        elif isinstance(device, (list, tuple)):
            self.mesh = pmesh.make_mesh(self._ndev, device)
        elif self._ndev == 1:
            self.mesh = [torch.device(device)]
        else:
            raise ValueError(f"num_devices={self._ndev}: pass a list of "
                             f"{self._ndev} devices, one per shard")
        self.cfg = cfg
        self.device = self.mesh[0]
        self.problem = trifocal.TrifocalProblem.load(cfg)
        backend = cfg.hc.backend
        # The abort needs the segmented tracker: the oracle's and the P2C
        # tracker's rounds, as the JAX engine's, run every hypothesis in
        # one call.
        self._abort = cfg.ransac.abort_by_good_sol and backend == "fused"
        self._segmented = track_fn is None and backend == "fused" and (
            cfg.hc.compact_survivors or self._abort)
        if track_fn is not None and self._abort:
            raise ValueError("the abort round runs the segmented tracker")
        if track_fn is not None and self._ndev > 1:
            raise ValueError("a sharded engine runs its sharded tracker")
        if track_fn is not None:
            self.track = track_fn
        elif self._ndev > 1:
            self.track = pmesh.make_sharded_track_fn(
                self.problem, cfg.hc, self.mesh,
                backend=("xla" if backend == "xla" else "segmented"
                         if self._segmented else "fused"),
                ransac_cfg=cfg.ransac)
        elif backend == "xla":
            self.track = tracker.make_track_fn(self.problem, cfg.hc)
        elif backend == "p2c":
            tables = p2c.derive_coeff_map(self.problem, problem_dir(cfg))
            self.track = p2c.make_fused_p2c_track_fn(self.problem, tables,
                                                     cfg.hc)
        elif self._segmented:
            self.track = segmented.make_segmented_track_fn(
                self.problem, cfg.hc, cfg.ransac)
        else:
            self.track = fused.make_track_fn(self.problem, cfg.hc)
        self._intrinsics = data_io.load_intrinsic_matrix(ransac_data_dir(cfg))
        self._k = torch.as_tensor(self._intrinsics, device=self.device)
        self._start = torch.as_tensor(self.problem.start_sols,
                                      device=self.device)

    def load_view(self, view_index: int) -> data_io.RansacView:
        return data_io.load_ransac_view(ransac_data_dir(self.cfg), view_index)

    def _sync(self) -> None:
        for d in {d for d in self.mesh if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    def _whole_shards(self, h: int) -> int:
        """h hypotheses rounded up to whole shards."""
        return -(-h // self._ndev) * self._ndev

    def _masks(self, res: fused.TrackResult):
        """Real-solution and candidate masks: a candidate is converged, its
        rotation parameters real within imag_part_tol and its depths
        non-negative."""
        rc = self.cfg.ransac
        xr, xi = res.x.real, res.x.imag
        conv = res.converged
        real = conv & (xi.abs() <= rc.zero_imag_part_tol).all(dim=1)
        cand = (conv & (xi[:, 24:30].abs() < rc.imag_part_tol).all(dim=1)
                & (xr[:, 0:8] >= 0).all(dim=1))
        return real, cand

    def _supports(self, xr: torch.Tensor, edgels: torch.Tensor):
        """The inlier supports (int32) of the poses of the solutions' real
        parts xr (S, 30), in chunks of _SCORE_CHUNK rows."""
        n21 = torch.empty(xr.shape[0], dtype=torch.int32, device=xr.device)
        n31 = torch.empty_like(n21)
        for lo in range(0, xr.shape[0], _SCORE_CHUNK):
            hi = min(lo + _SCORE_CHUNK, xr.shape[0])
            r21, r31, t21, t31 = trifocal.solution_to_pose(xr[lo:hi])
            n21[lo:hi], n31[lo:hi] = ransac.count_inlier_support(
                r21, r31, t21, t31, edgels, self._k,
                thresh_px=self.cfg.ransac.reproj_inlier_thresh_px)
        return n21, n31

    def _device_score(self, res: fused.TrackResult, edgels: torch.Tensor):
        """Real-solution and candidate masks and per-path supports (-1 for
        non-candidates)."""
        real, cand = self._masks(res)
        n21, n31 = self._supports(res.x.real, edgels)
        return (real, cand, torch.where(cand, n21, -1),
                torch.where(cand, n31, -1))

    @staticmethod
    def _device_select(xr, conv, inf, real, cand, n21, n31, num_steps,
                       n_paths: int) -> torch.Tensor:
        """The stream's best-pose selection on the device over the first
        n_paths paths (padding never counts): a (39,) float32 vector
        [num_conv, num_inf, num_real, num_cand, best21, best31,
        steps_of_best, n_actual, steps_actual_sum] + xr[best] (30), best
        the first argmax of min(n21, n31) and the actual solutions the
        max-support ties on either pair (the JAX engine's layout)."""
        conv, inf, real, cand, n21, n31 = (
            a[:n_paths] for a in (conv, inf, real, cand, n21, n31))
        steps = num_steps[:n_paths].float()
        bi = torch.argmax(torch.minimum(n21, n31))
        actual = (n21 == n21.max()) | (n31 == n31.max())
        head = torch.stack([
            conv.sum().float(), inf.sum().float(), real.sum().float(),
            cand.sum().float(), n21[bi].float(), n31[bi].float(), steps[bi],
            actual.sum().float(), torch.where(actual, steps, 0.0).sum(),
        ])
        return torch.cat([head, xr[bi].float()])

    def run_round(self, view: data_io.RansacView, seed: int,
                  num_hypotheses: Optional[int] = None,
                  collect_solutions: bool = False) -> RoundResult:
        """One round.  collect_solutions: also return every path's solution
        (``RoundResult.solutions``), the candidates' fundamental matrices
        and the residuals' minima; the tracking and its track_ms are the
        same.

        The round's spans, nested so: ``round`` (its self time the tail)
        holds ``round.sample`` (sampling, targets), ``round.stage`` (the
        device copies and the synchronisation before the timed part),
        ``round.track`` (track_ms: the segment spans of ``ops/segmented``,
        in a ``round.chunk`` per abort chunk; in a plain round then
        ``round.unpack``, the synchronisation that waits for the unpacked
        paths) and ``round.score`` (``score.readback``,
        ``score.supports``); total_ms is ``round.track`` and
        ``round.score``.  Counters, in abort rounds: ``scored_paths`` and
        ``score_slots``.  The last rounds' spans and counters are also kept
        in ``utils/spans.finished``."""
        rec = spans.Recorder()
        try:
            with spans.recording(rec), spans.span("round"):
                rr = self._round(view, seed, num_hypotheses,
                                 collect_solutions)
        finally:  # a round that raised keeps its place in the log
            kept = spans.keep(rec)
        rr.spans, rr.counts = kept
        return rr

    def _round(self, view: data_io.RansacView, seed: int,
               num_hypotheses: Optional[int], collect: bool) -> RoundResult:
        cfg = self.cfg
        H = num_hypotheses or cfg.ransac.num_iterations
        Hp = self._whole_shards(H)
        T = self.problem.num_tracks

        with spans.span("round.sample"):
            samples = ransac.sample_edgel_triplets(
                seed, view.edge_locations.shape[0], Hp)
            tgt = ransac.build_target_params(
                view.edge_locations, view.edge_tangents, samples)
        if self._abort:
            return self._abort_round(view, tgt, H, collect)
        # Staging sits outside the timed span, as in the reference.
        with spans.span("round.stage"):
            edgels = torch.as_tensor(view.edge_locations, device=self.device)
            tgt_d = torch.as_tensor(tgt, device=self.device
                                    ).repeat_interleave(T, dim=0)
            x0 = self._start.repeat(Hp, 1)
            self._sync()

        with spans.span("round.track") as track:
            res = self.track(x0, tgt_d)
            if self._segmented:
                res = res.track
            with spans.span("round.unpack"):
                self._sync()
        if Hp != H:
            res = fused.TrackResult(**{
                f.name: getattr(res, f.name)[:H * T]
                for f in dataclasses.fields(res)})
        return self._result(track, view, res, edgels, collect)

    def _abort_round(self, view, tgt: np.ndarray, H: int,
                     collect_solutions: bool = False) -> RoundResult:
        """TrunRANSAC: the hypotheses in chunks of abort_chunk, stopping at
        the first chunk whose tracking found a pose (engine.py:401-534 of
        the JAX package).  The reference dispatches chunk i+1 before it
        reads chunk i's found flag, to hide that read behind the next
        chunk.  Here the segment loop has already read the flag at chunk
        i's last boundary, so nothing is left to hide: chunk i+1 starts only
        when chunk i found nothing.  Chunks never run are scored as having
        no candidates.  tgt holds the H real hypotheses and the padding to
        whole shards."""
        cfg = self.cfg
        Hp, T = len(tgt), self.problem.num_tracks
        n_edgels = view.edge_locations.shape[0]
        chunk_h = self._whole_shards(min(cfg.ransac.abort_chunk, Hp))
        n_chunks = -(-Hp // chunk_h)
        with spans.span("round.stage"):
            edgels = torch.as_tensor(view.edge_locations, device=self.device)
            x0 = self._start.repeat(chunk_h, 1)
            chunks = self._chunk_targets(tgt, chunk_h)
            self._sync()

        with spans.span("round.track") as track:
            results = []
            for tg in chunks:
                with spans.span("round.chunk"):
                    res = self.track(x0, tg, edgels, self._k, n_edgels)
                results.append(res.track)
                if res.found:
                    break

        per = chunk_h * T

        def whole(f, fill):
            run = torch.cat([getattr(r, f) for r in results])
            pad = run.new_full((n_chunks * per - run.shape[0],)
                               + run.shape[1:], fill)
            return torch.cat([run, pad])[:H * T]

        res = fused.TrackResult(
            x=whole("x", 0), converged=whole("converged", False),
            inf_fail=whole("inf_fail", False),
            pruned=whole("pruned", False), num_steps=whole("num_steps", 0))
        return self._result(track, view, res, edgels, collect_solutions,
                            chunks_run=len(results))

    def _chunk_targets(self, tgt: np.ndarray, chunk_h: int) -> list:
        """The hypotheses' targets in chunks of chunk_h, each repeated per
        root on the device.  A ragged tail repeats its first hypotheses up
        to a full chunk; the callers leave the repeats out."""
        H, T = len(tgt), self.problem.num_tracks
        chunks = []
        for lo in range(0, H, chunk_h):
            idx = lo + np.arange(chunk_h) % (min(lo + chunk_h, H) - lo)
            chunks.append(torch.as_tensor(tgt[idx], device=self.device)
                          .repeat_interleave(T, dim=0))
        return chunks

    def _score_round(self, view: data_io.RansacView, res: fused.TrackResult,
                     edgels: torch.Tensor, collect: bool) -> dict:
        """The JAX engine's ``_score_round`` over res, whose tensors lie on
        the engine's device: the statistics, the candidate gate, the
        supports of every candidate, the best pose (first argmax of
        min(n21, n31)) and its residuals, and the step counts of the
        max-support ties on either pair; with ``collect`` also the minima of
        the residuals over all candidate poses, the candidates' fundamental
        matrices K^-T [t]x R K^-1 and every path's solution.  Every round
        runs it (the default, abort and collecting ones).  The supports and
        poses are computed on the device; the host gets the per-path flags
        and steps, the candidates' supports and the poses it needs, and
        does the 3x3 work.  Returns the RoundResult fields it sets."""
        rc = self.cfg.ransac
        n_edgels = view.edge_locations.shape[0]
        real, cand = self._masks(res)
        with spans.span("score.readback"):
            rows = torch.stack(
                [a.to(torch.int32) for a in (res.converged, res.inf_fail,
                                             res.pruned, real, cand)]
                + [res.num_steps.to(torch.int32)]).cpu().numpy()
        conv_m, inf_m, pruned_m, real_m, cand_m = rows[:5].astype(bool)
        steps = rows[5]
        out = dict(
            stats=evl.SolutionStats(
                num_converged=int(conv_m.sum()),
                num_infinity=int(inf_m.sum()), num_real=int(real_m.sum()),
                num_paths=len(conv_m)),
            num_steps=steps, converged=conv_m, inf_fail=inf_m,
            pruned=pruned_m, num_candidates=0, best_support21=0,
            best_support31=0, found_pose=False, pose_errors=None,
            best_pose=None)
        if collect:
            out["solutions"] = fused.TrackResult(
                x=res.x.cpu().numpy(), converged=conv_m, inf_fail=inf_m,
                pruned=pruned_m, num_steps=steps)
        cand_idx = np.nonzero(cand_m)[0]
        n_cand = len(cand_idx)
        if not n_cand:
            return out
        xs = res.x.real[torch.as_tensor(cand_idx, device=res.x.device)]
        with spans.span("score.supports"):
            n21, n31 = torch.stack(self._supports(xs, edgels)).cpu().numpy()
        poses = trifocal.solution_to_pose(xs)
        bi = int(np.argmax(np.minimum(n21, n31)))
        best21, best31 = int(n21[bi]), int(n31[bi])
        best_pose = tuple(p[bi].cpu().numpy() for p in poses)
        ratio = rc.pass_inlier_support_ratio
        actual = np.union1d(cand_idx[n21 == n21.max()],
                            cand_idx[n31 == n31.max()])
        out.update(
            num_candidates=n_cand, best_support21=best21,
            best_support31=best31,
            found_pose=(best21 >= ratio * n_edgels
                        and best31 >= ratio * n_edgels),
            best_pose=best_pose,
            pose_errors=evl.measure_pose_error(
                *best_pose, view.gt_pose21, view.gt_pose31),
            actual_sol_steps=steps[actual].astype(np.int32))
        if not collect:
            return out
        r21, r31, t21, t31 = (p.cpu().numpy() for p in poses)
        min_res, any_gt = evl.min_residuals_over_sols(
            r21, r31, t21, t31, view.gt_pose21, view.gt_pose31, rc)
        kinv = np.linalg.inv(self._intrinsics)

        def fmats(r, t):
            sk = np.zeros((len(t), 3, 3), np.float32)
            sk[:, 0, 1], sk[:, 0, 2] = -t[:, 2], t[:, 1]
            sk[:, 1, 0], sk[:, 1, 2] = t[:, 2], -t[:, 0]
            sk[:, 2, 0], sk[:, 2, 1] = -t[:, 1], t[:, 0]
            return kinv.T @ (sk @ r) @ kinv

        out.update(cand_f21=fmats(r21, t21), cand_f31=fmats(r31, t31),
                   min_residuals=min_res, any_within_gt=any_gt)
        return out

    def _result(self, track: int, view, res: fused.TrackResult,
                edgels: torch.Tensor, collect: bool,
                **chunks) -> RoundResult:
        """A round's result: ``_score_round`` and the round's times, from
        its ``round.track`` span (index ``track``) and ``round.score``."""
        with spans.span("round.score") as score:
            fields = self._score_round(view, res, edgels, collect)
        return RoundResult(
            track_ms=spans.ns(track) * 1e-6,
            total_ms=(spans.ns(track) + spans.ns(score)) * 1e-6,
            num_edgels=view.edge_locations.shape[0], **fields, **chunks)

    # -- streamed recovery ---------------------------------------------------
    def warmup(self, num_hypotheses: Optional[int] = None) -> None:
        """One round on view 0 (builds and loads the kernel)."""
        self.run_round(self.load_view(0), seed=0,
                       num_hypotheses=num_hypotheses)

    def run_stream(self, view_indices, num_hypotheses: Optional[int] = None,
                   seed: int = 0):
        """Streamed recovery over a sequence of views, each with RANSAC
        seed ``seed``; returns (results, views/s), and ([], 0.0) for no
        view.

        Two views are in flight on the card: the segmented tracker's runs
        (``track.begin``) advance in turns, so that while the host reads one
        run's loop test and queues its next segment, the card tracks the
        other's; a one-call tracker's run is one launch.  When a view's
        tracking ends, its scoring and selection (``_device_select``) are
        queued, the next view is loaded, sampled and dispatched, and only
        then is the view's 39-float selection read back (``Readback``).  So
        per-path step counts stay on the card: ``num_steps`` is empty and
        ``actual_sol_steps`` holds the best path's steps.  track_ms is a
        view's latency from its dispatch to its selection on the host: its
        ``view`` span (each view's recorder, ``utils/spans``, holds it, its
        runs' segment spans and their counters).

        With ``abort_by_good_sol`` the views' hypotheses run in chunks of
        ``stream_abort_chunk`` (a ragged tail repeats the chunk's first
        hypotheses, which are not counted), each chunk stopping at its first
        segment boundary that holds a passing pose; one selection per chunk
        comes back.  A view's next chunk is queued only after its last one
        was read as a miss, at the front of the queue, so the second slot
        holds another view's chunk and a hit wastes no device time.
        Skipped chunks count as unconverged (``num_paths`` is H x T).
        Sharded, each view samples H padded to whole shards and the abort
        chunks are rounded up to whole shards; the padding is not counted."""
        view_indices = list(view_indices)
        nv = len(view_indices)
        if not nv:
            return [], 0.0
        H = num_hypotheses or self.cfg.ransac.num_iterations
        Hp = self._whole_shards(H)
        chunk_h = (self._whole_shards(min(self.cfg.ransac.stream_abort_chunk,
                                          Hp)) if self._abort else Hp)
        T = self.problem.num_tracks
        ratio = self.cfg.ransac.pass_inlier_support_ratio
        n_chunks = -(-Hp // chunk_h)
        x0 = self._start.repeat(chunk_h, 1)
        prep = [None] * nv   # (view, its chunks' targets, its edgels)

        def real_h(ci: int) -> int:
            return max(0, min(H - ci * chunk_h, chunk_h))

        def prep_view(i: int) -> None:
            view = self.load_view(view_indices[i])
            tgt = ransac.build_target_params(
                view.edge_locations, view.edge_tangents,
                ransac.sample_edgel_triplets(
                    seed, view.edge_locations.shape[0], Hp))
            prep[i] = (view, self._chunk_targets(tgt, chunk_h),
                       torch.as_tensor(view.edge_locations,
                                       device=self.device))

        queue = deque((i, 0) for i in range(nv))
        inflight: deque = deque()
        sums = np.zeros((nv, 4), np.int64)   # conv, inf, real, cand
        best = [None] * nv                   # the best chunk's selection
        chunks_run = [0] * nv
        decided = [False] * nv
        recs = [spans.Recorder() for _ in range(nv)]
        view_span = [-1] * nv

        t0 = time.perf_counter()

        def pump() -> None:
            while len(inflight) < 2 and queue:
                i, ci = queue.popleft()
                if decided[i]:
                    continue
                if prep[i] is None:
                    prep_view(i)
                rec = recs[i]
                if ci == 0:
                    view_span[i] = rec.open("view")
                view, chunks, edgels = prep[i]
                with spans.recording(rec):
                    run = self._begin(x0, chunks[ci], edgels,
                                      view.edge_locations.shape[0])
                    run.advance()
                inflight.append((i, ci, run))

        pump()
        while inflight:
            i, ci, run = inflight.popleft()
            with spans.recording(recs[i]):
                more = run.keep()
                if more:
                    run.advance()
                else:
                    res = run.track_result()
            if more:
                inflight.append((i, ci, run))
                continue
            real, cand, n21, n31 = self._device_score(res, prep[i][2])
            pending = segmented.Readback(self._device_select(
                res.x.real, res.converged, res.inf_fail, real, cand, n21,
                n31, res.num_steps, real_h(ci) * T))
            pump()  # the next dispatch rides the card while we wait
            sel = pending.wait().numpy()
            chunks_run[i] += 1
            sums[i] += sel[:4].astype(np.int64)
            if best[i] is None or (min(sel[4], sel[5])
                                   > min(best[i][4], best[i][5])):
                best[i] = sel
            n_e = prep[i][0].edge_locations.shape[0]
            hit = (sel[3] > 0 and sel[4] >= ratio * n_e
                   and sel[5] >= ratio * n_e)
            if hit or ci + 1 >= n_chunks or real_h(ci + 1) == 0:
                decided[i] = True
                recs[i].close(view_span[i])
            else:
                queue.appendleft((i, ci + 1))
                pump()

        results = [self._stream_result(prep[i][0], sums[i], best[i], H * T,
                                       recs[i], view_span[i], chunks_run[i])
                   for i in range(nv)]
        return results, nv / (time.perf_counter() - t0)

    def _begin(self, x0, tgt, edgels, n_edgels):
        """A run of the engine's tracker that has not started."""
        if not self._segmented:
            return _OneCall(self.track, x0, tgt)
        if self._abort:
            return self.track.begin(x0, tgt, edgels, self._k, n_edgels)
        return self.track.begin(x0, tgt)

    def _stream_result(self, view, counts, sel, num_paths: int,
                       rec: spans.Recorder, view_span: int,
                       chunks_run: int) -> RoundResult:
        """A streamed view's RoundResult from its summed counts, its best
        chunk's selection and its recorder (track_ms: the ``view`` span)."""
        n_e = view.edge_locations.shape[0]
        ratio = self.cfg.ransac.pass_inlier_support_ratio
        n_cand = int(counts[3])
        b21 = b31 = 0
        found = False
        pose = perr = None
        actual_steps = np.zeros(0, np.int32)
        if n_cand and sel[3] > 0:
            b21, b31 = int(sel[4]), int(sel[5])
            found = b21 >= ratio * n_e and b31 >= ratio * n_e
            pose = tuple(a.numpy() for a in trifocal.solution_to_pose(
                torch.as_tensor(sel[9:39])))
            perr = evl.measure_pose_error(*pose, view.gt_pose21,
                                          view.gt_pose31)
            actual_steps = np.array([int(sel[6])], np.int32)
        return RoundResult(
            stats=evl.SolutionStats(
                num_converged=int(counts[0]), num_infinity=int(counts[1]),
                num_real=int(counts[2]), num_paths=num_paths),
            track_ms=rec.ns(view_span) * 1e-6,
            total_ms=rec.ns(view_span) * 1e-6,
            num_candidates=n_cand, best_support21=b21, best_support31=b31,
            num_edgels=n_e, found_pose=found, pose_errors=perr,
            best_pose=pose, num_steps=np.zeros(0, np.int32),
            actual_sol_steps=actual_steps, chunks_run=chunks_run,
            spans=rec.spans_out(), counts=rec.counts)
