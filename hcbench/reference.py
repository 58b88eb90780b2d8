"""The plain reference of one RANSAC round, independent of the program.

It repeats what the program's ``TrifocalPoseEngine.run_round`` computes for a
view and a sampling seed, from the problem's files and the view alone, with
the frozen plain code of ``hcbench/plain/`` (commit e13ae2fbc8b3): the
hypothesis sampling and target parameters (``plain/ransac``), the tracking
(``plain/segmented``'s segment loop with survivor compaction and, in an
abort round, the boundary scoring and found test, over ``plain/fused``'s
``track_plain``), the chunks of the TrunRANSAC abort, and the round's
scoring and selection (a copy of the engine's ``_score_round``).  On the
card ``track_plain`` computes what the program's kernel computes, bit for
bit (the kernel is built without multiply-add contraction for this).

An abort round's chunks are independent: the program tracks chunk c only
after chunks 0..c-1 found nothing.  Tracking them one after another would
cost the plain tracker's per-step host time once per chunk, so the
reference tracks them all together and takes the first chunk, in order,
that finds a pose as the one where the program stops.  Where that is not
the last chunk, the later ones were tracked for nothing, and the work
counted for the bound (``work``) is counted again over the program's
chunks alone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hcbench.plain import bound, ransac, segmented, trifocal
from hcbench.plain.config import EngineConfig, ransac_data_dir
from hcbench.plain.data_io import load_intrinsic_matrix

_SCORE_CHUNK = 1024  # the engine's scoring chunk (rows of supports at once)


@dataclasses.dataclass
class Outcome:
    """What a round returns, as host numpy."""

    converged: np.ndarray   # bool (H*T,)
    inf_fail: np.ndarray
    pruned: np.ndarray
    num_steps: np.ndarray   # int32 (H*T,)
    chunks_run: int
    best_pose: Optional[tuple]  # (R21, R31, t21, t31) float32


def advance_together(runs: list, work: Optional[dict]) -> None:
    """One segment of every run in ``runs`` (``plain/segmented._Run``s of one
    tracker, at the same segment): the runs' live paths tracked in one
    ``track_plain`` call (paths are independent, so this is each run's own
    call), then each run's own boundary work (scoring, packing, loop test)
    through its ``advance`` with nothing left to track."""
    tr = runs[0].tr
    if len({r.si for r in runs}) != 1:
        raise ValueError("runs advanced together must be at one segment")
    niter = min(tr.seg, tr.budget - runs[0].si * tr.seg)
    going = [(r, r.n_live) for r in runs if r.n_active]
    if going:
        cat = [torch.cat([getattr(r, a)[:n] for r, n in going])
               for a in ("x", "xl", "fl", "efg")]
        x, xl, fl = segmented.fused.track_plain(
            tr.consts, tr.hc, *cat[:3], cat[3], niter=niter,
            tables=going[0][0].aux, work=work)
        lo = 0
        for r, n in going:
            r.x[:n], r.xl[:n], r.fl[:n] = x[lo:lo + n], xl[lo:lo + n], \
                fl[lo:lo + n]
            lo += n
    for r in runs:
        r.n_active = 0  # tracked above: advance does the boundary work only
        r.advance()


class PlainRound:
    """The reference of a configuration's rounds on one device."""

    def __init__(self, cfg: EngineConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.problem = trifocal.TrifocalProblem.load(cfg)
        self.track = segmented.make_segmented_track_fn(
            self.problem, cfg.hc, cfg.ransac)
        self.abort = cfg.ransac.abort_by_good_sol
        k = load_intrinsic_matrix(ransac_data_dir(cfg))
        self.k = torch.as_tensor(k, device=self.device)
        self.start = torch.as_tensor(self.problem.start_sols,
                                     device=self.device)

    def constants(self):
        return self.track.constants

    def run(self, edge_locations, edge_tangents, seed: int,
            work: Optional[dict] = None) -> tuple:
        """(Outcome, paths tracked) of the round on a view's edgels with
        RANSAC seed ``seed``; ``work`` counts the tracking that the program's
        round does (``plain/fused.track_plain``'s counts)."""
        H = self.cfg.ransac.num_iterations
        T = self.problem.num_tracks
        samples = ransac.sample_edgel_triplets(seed, len(edge_locations), H)
        tgt = ransac.build_target_params(edge_locations, edge_tangents,
                                         samples)
        edgels = torch.as_tensor(edge_locations, device=self.device)
        n_e = len(edge_locations)
        chunk_h = min(self.cfg.ransac.abort_chunk, H) if self.abort else H
        chunks = []
        for lo in range(0, H, chunk_h):
            idx = lo + np.arange(chunk_h) % (min(lo + chunk_h, H) - lo)
            chunks.append(torch.as_tensor(tgt[idx], device=self.device)
                          .repeat_interleave(T, dim=0))
        x0 = self.start.repeat(chunk_h, 1)

        def begin(ci):
            if self.abort:
                return self.track.begin(x0, chunks[ci], edgels, self.k, n_e)
            return self.track.begin(x0, chunks[ci])

        runs = self._track_chunks(begin, len(chunks), work)
        n_run = len(runs)
        results = [r.track_result() for r in runs]
        per = chunk_h * T

        def whole(f, fill):
            run = torch.cat([getattr(r, f) for r in results])
            pad = run.new_full((len(chunks) * per - run.shape[0],)
                               + run.shape[1:], fill)
            return torch.cat([run, pad])[:H * T]

        res = segmented.fused.TrackResult(
            x=whole("x", 0), converged=whole("converged", False),
            inf_fail=whole("inf_fail", False),
            pruned=whole("pruned", False), num_steps=whole("num_steps", 0))
        out = self._score_round(res, edgels)
        return Outcome(chunks_run=n_run, **out), n_run * per

    def _track_chunks(self, begin, n_chunks: int, work: Optional[dict]):
        """The runs of the chunks the program tracks, each at the boundary
        where it stopped.  All chunks are tracked together; the first one,
        in order, that finds a pose is the program's last, so a chunk that
        finds one ends every later chunk, and the tracking ends when no
        earlier chunk is left going."""
        runs = {c: begin(c) for c in range(n_chunks)}
        going, stop, ahead = dict(runs), {}, {}
        found_at = None
        while going:
            advance_together(list(going.values()), ahead)
            for c in sorted(going):
                keep, found = going[c].poll()
                if found and (found_at is None or c < found_at):
                    found_at = c
                if not keep or found:
                    stop[c] = going[c].si
                    del going[c]
            if found_at is not None:
                for c in [c for c in going if c > found_at]:
                    del going[c]
        last = n_chunks - 1 if found_at is None else found_at
        if work is not None:
            if last == n_chunks - 1:
                _add(work, ahead)
            else:  # the chunks after the last were tracked ahead: again
                again = {c: begin(c) for c in range(last + 1)}
                while again:
                    advance_together(list(again.values()), work)
                    for c in list(again):
                        if not again[c].poll()[0] or again[c].si == stop[c]:
                            del again[c]
        return [runs[c] for c in range(last + 1)]

    # A copy of the engine's _masks (its candidates), _supports and
    # _score_round (commit e13ae2fbc8b3): the per-path outcome and the best
    # pose (the first argmax of min(n21, n31) over the candidates).
    def _candidates(self, res):
        """Converged, the rotation parameters real within imag_part_tol,
        the depths non-negative."""
        xr, xi = res.x.real, res.x.imag
        return (res.converged
                & (xi[:, 24:30].abs() < self.cfg.ransac.imag_part_tol).all(1)
                & (xr[:, 0:8] >= 0).all(dim=1))

    def _supports(self, xr, edgels):
        n21 = torch.empty(xr.shape[0], dtype=torch.int32, device=xr.device)
        n31 = torch.empty_like(n21)
        for lo in range(0, xr.shape[0], _SCORE_CHUNK):
            hi = min(lo + _SCORE_CHUNK, xr.shape[0])
            r21, r31, t21, t31 = trifocal.solution_to_pose(xr[lo:hi])
            n21[lo:hi], n31[lo:hi] = ransac.count_inlier_support(
                r21, r31, t21, t31, edgels, self.k,
                thresh_px=self.cfg.ransac.reproj_inlier_thresh_px)
        return n21, n31

    def _score_round(self, res, edgels) -> dict:
        cand = self._candidates(res)
        out = dict(converged=res.converged.cpu().numpy(),
                   inf_fail=res.inf_fail.cpu().numpy(),
                   pruned=res.pruned.cpu().numpy(),
                   num_steps=res.num_steps.to(torch.int32).cpu().numpy(),
                   best_pose=None)
        cand_idx = np.nonzero(cand.cpu().numpy())[0]
        if not len(cand_idx):
            return out
        xs = res.x.real[torch.as_tensor(cand_idx, device=res.x.device)]
        n21, n31 = torch.stack(self._supports(xs, edgels)).cpu().numpy()
        poses = trifocal.solution_to_pose(xs)
        bi = int(np.argmax(np.minimum(n21, n31)))
        out["best_pose"] = tuple(p[bi].cpu().numpy() for p in poses)
        return out


def _add(into: dict, counts: dict) -> None:
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def paths_differ(program, ref: Outcome) -> float:
    """The share of the paths either round tracked (a step or more) whose
    converged, diverged or pruned flag or step count differs between the
    program's round and the reference's; a chunk that one of them ran and
    the other did not differs on every path."""
    steps = np.asarray(program.num_steps)
    d = ((np.asarray(program.converged) != ref.converged)
         | (np.asarray(program.inf_fail) != ref.inf_fail)
         | (np.asarray(program.pruned) != ref.pruned)
         | (steps != ref.num_steps))
    tracked = int(((steps > 0) | (ref.num_steps > 0)).sum())
    return float(d.sum() / tracked) if tracked else 0.0


def bound_ms(plain: PlainRound, work: dict, n_paths: int) -> float:
    """The least time the card could take for the counted tracking: the
    frozen ``tracker_bound``."""
    return bound.tracker_bound(plain.constants(), work, n_paths)[0]
