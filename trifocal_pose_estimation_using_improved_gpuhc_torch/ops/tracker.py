"""The oracle path tracker: every path advanced by masked batch steps with
the full-pivot solve.

Counterpart of the JAX package's ``ops/tracker.py``, its ``backend="xla"``
and its CPU product.  One step (``make_step_fn``) runs, for every path:
the end-zone flag, TrunPaths depth pruning (when ``truncate_paths``), the
dt clamp, the RK predictor ("rk4", "rk3" or "rk2"), at most
``max_correction_steps`` Newton iterations at the step's end point (the
last ``corrector_jacobian_reuse`` iterations re-solve against the k-th
iterate's Hx), and the adaptive step size; each branch of a path's control
flow is a ``torch.where``, and a finished path stays as it is.  Every
evaluation is ``ops/eval.eval_all_factored`` at ``param_homotopy``'s p(t),
and every solve ``ops/linalg.solve_batched``.

Under ``predictor_handoff`` the step keeps the last corrector iteration's
Hx (B, n, n) and solves RK stage 1 against it when no path of the whole
batch rolled back at the previous step (``hov``): the JAX oracle's
batch-wide condition.  Like the JAX oracle, the tracker ignores
``solver``, ``pair_coef_basis``, ``eval_precision``, ``eval_structure``,
``rk_jacobian_reuse`` and ``tile``: they pick the kernel's program, not
the function of this tracker.

``make_track_fn`` runs the steps on the device of its inputs.  Every
``_CHECK_EVERY`` steps it reads which paths are still active, stops when
none is, and runs the next steps on those paths only.  A path that
finishes between two reads is masked as in one batch, so every path takes
the steps that the JAX tracker's while loop over the whole batch gives it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import linalg
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
)

# The engine's result type: x, converged, inf_fail, pruned, num_steps.
TrackResult = fused.TrackResult

_CHECK_EVERY = 4  # steps between reads of the active paths


@dataclasses.dataclass
class TrackerState:
    """Per-path tracker state (leading dim B = paths)."""

    x: torch.Tensor             # (B, V) complex current solution
    x_last: torch.Tensor        # (B, V) last successful solution
    t: torch.Tensor             # (B,) real
    dt: torch.Tensor            # (B,) real
    succ_count: torch.Tensor    # (B,) int32 consecutive corrector successes
    end_zone: torch.Tensor      # (B,) bool
    check_depths: torch.Tensor  # (B,) bool: still watching the depths
    inf_fail: torch.Tensor      # (B,) bool
    pruned: torch.Tensor        # (B,) bool (TrunPaths truncation)
    num_steps: torch.Tensor     # (B,) int32 HC steps taken while active
    step: int = 0               # steps run

    def index(self, idx: torch.Tensor) -> "TrackerState":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[idx]
            for f in dataclasses.fields(self) if f.name != "step"})

    def put(self, idx: torch.Tensor, sub: "TrackerState") -> "TrackerState":
        """This state with the rows idx replaced by sub's, and sub's step."""
        return dataclasses.replace(self, step=sub.step, **{
            f.name: getattr(self, f.name).index_copy(0, idx,
                                                     getattr(sub, f.name))
            for f in dataclasses.fields(self) if f.name != "step"})


def init_state(x0: torch.Tensor, cfg: HCConfig) -> TrackerState:
    """Fresh state; the real dtype follows x0's (float64 for complex128)."""
    B, dev = x0.shape[0], x0.device
    real = torch.float64 if x0.dtype == torch.complex128 else torch.float32

    def full(v, dtype):
        return torch.full((B,), v, dtype=dtype, device=dev)

    return TrackerState(
        x=x0, x_last=x0, t=full(0.0, real), dt=full(cfg.init_delta_t, real),
        succ_count=full(0, torch.int32), end_zone=full(False, torch.bool),
        check_depths=full(bool(cfg.truncate_paths), torch.bool),
        inf_fail=full(False, torch.bool), pruned=full(False, torch.bool),
        num_steps=full(0, torch.int32))


def _is_converged(t: torch.Tensor, cfg: HCConfig) -> torch.Tensor:
    return (t >= 1.0) | (1.0 - t <= cfg.t_converged_eps)


def _active(s: TrackerState, cfg: HCConfig) -> torch.Tensor:
    return ~_is_converged(s.t, cfg) & ~s.inf_fail & ~s.pruned


def make_step_fn(
    problem: TrifocalProblem,
    cfg: HCConfig,
    solve: Callable[[torch.Tensor, torch.Tensor],
                    torch.Tensor] = linalg.solve_batched,
    dynamic_start: bool = False,
) -> Callable:
    """Build one masked HC step over a batch of paths:
    ``step_fn(s, target_params, diff_params, extras=None)``.

    target_params, diff_params: (B, P+1) complex per path (diff = target -
    start).  dynamic_start: each path's start system is target - diff
    (monodromy legs) instead of the problem's start parameters.  Under
    ``predictor_handoff`` ``extras`` is (hx_save (B, n, n), hov ()) and the
    step returns (state', extras'), else the state'."""
    cph = bool(cfg.predictor_handoff)
    cjr = int(cfg.corrector_jacobian_reuse)
    track_hx = bool(cjr) or cph
    consts: dict = {}   # per device and dtype: start parameters, tables

    def on(target_params):
        key = (str(target_params.device), target_params.dtype)
        if key not in consts:
            dev = target_params.device
            consts[key] = (
                torch.as_tensor(problem.start_params, device=dev).to(
                    target_params.dtype),
                ev.factored_tables(problem, dev))
        return consts[key]

    def evaluate(x, t, start, target_params, diff_params, tables):
        p = ev.param_homotopy(t, start, target_params)
        hx, _, mht = ev.eval_all_factored(problem, x, p, diff_params,
                                          need_h=False, need_ht=True,
                                          tables=tables)
        return hx, mht

    def step_fn(s: TrackerState, target_params: torch.Tensor,
                diff_params: torch.Tensor, extras=None):
        active = _active(s, cfg)
        start, tables = on(target_params)
        if dynamic_start:
            start = target_params - diff_params

        # End-zone flag.
        end_zone = s.end_zone | ((1.0 - s.t).abs() <= cfg.end_zone_factor)

        # TrunPaths depth-sign pruning.
        if cfg.truncate_paths:
            depths_ok = (s.x[:, 0:8].real > 0).all(dim=-1)
            check = torch.where(s.check_depths & (s.t > 0), ~depths_ok,
                                s.check_depths)
            pruned = s.pruned | (active & (s.t > 0.95) & check)
        else:
            check = s.check_depths
            pruned = s.pruned
        active = active & ~pruned

        # dt clamp: inside the end zone to 1 - t, else to 0.95 - t.
        dt = torch.where(end_zone, torch.minimum(s.dt, (1.0 - s.t).abs()),
                         torch.minimum(s.dt, (0.95 - s.t).abs()))

        # RK predictor.
        x0 = s.x
        half = 0.5 * dt
        dtc = dt.to(x0.dtype)[:, None]
        halfc = half.to(x0.dtype)[:, None]

        t_a = s.t
        hx, mht = evaluate(x0, t_a, start, target_params, diff_params, tables)
        if cph:
            # Stage 1 solves against the previous step's last corrector
            # Hx when no path of the batch rolled back there.
            hx_save, hov = extras
            hx = torch.where(hov, hx_save, hx)
        k1 = solve(hx, mht)
        t_b = t_a + half
        t_c = t_b + half
        x_b = x0 + halfc * k1
        hx, mht = evaluate(x_b, t_b, start, target_params, diff_params, tables)
        k2 = solve(hx, mht)
        if cfg.predictor == "rk2":
            x_pred = x0 + dtc * k2
        elif cfg.predictor == "rk3":
            x_e = x0 - dtc * k1 + 2.0 * dtc * k2
            hx, mht = evaluate(x_e, t_c, start, target_params, diff_params,
                               tables)
            k3 = solve(hx, mht)
            x_pred = x0 + dtc / 6.0 * (k1 + 4.0 * k2 + k3)
        else:
            x_c = x0 + halfc * k2
            hx, mht = evaluate(x_c, t_b, start, target_params, diff_params,
                               tables)
            k3 = solve(hx, mht)
            x_d = x0 + dtc * k3
            hx, mht = evaluate(x_d, t_c, start, target_params, diff_params,
                               tables)
            k4 = solve(hx, mht)
            x_pred = x0 + dtc / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

        # Newton corrector at t_c.
        p_corr = ev.param_homotopy(t_c, start, target_params)
        B = x0.shape[0]
        x = x_pred
        success = torch.zeros(B, dtype=torch.bool, device=x0.device)
        inf = torch.zeros_like(success)
        done = torch.zeros_like(success)
        hx0 = None
        for i in range(cfg.max_correction_steps):
            hx, h, _ = ev.eval_all_factored(problem, x, p_corr, diff_params,
                                            need_h=True, need_ht=False,
                                            tables=tables)
            if cjr and i >= cjr:
                # Modified Newton: Hx frozen at the cjr-th iterate.
                hx = hx0
            dx = solve(hx, h)
            x_new = torch.where(done[:, None], x, x - dx)
            sq_dx = (dx.real ** 2 + dx.imag ** 2).sum(dim=-1)
            sq_x = (x_new.real ** 2 + x_new.imag ** 2).sum(dim=-1)
            succ_i = sq_dx < cfg.corrector_tol_sq * sq_x
            inf_i = sq_x > cfg.infinity_norm_sq
            success = torch.where(done, success, succ_i)
            inf = torch.where(done, inf, inf_i)
            done = done | success | inf
            x = x_new
            if track_hx:
                hx0 = hx
        x_corr, inf_now = x, inf

        # Outcome bookkeeping.
        inf_fail = s.inf_fail | (active & inf_now)
        ok = active & ~inf_now
        fail = ok & ~success
        good = ok & success

        new_x = torch.where(good[:, None], x_corr,
                            torch.where(fail[:, None], s.x_last, s.x))
        # A diverged path keeps its diverged solution.
        new_x = torch.where((active & inf_now)[:, None], x_corr, new_x)
        new_x_last = torch.where(good[:, None], x_corr, s.x_last)
        new_t = torch.where(good | (active & inf_now), t_c, s.t)
        succ_count = torch.where(good, s.succ_count + 1,
                                 torch.where(fail, 0, s.succ_count))
        bump = good & (succ_count >= cfg.steps_to_increase_delta_t)
        new_dt = torch.where(fail, dt * 0.5,
                             torch.where(bump, dt * 2.0, dt))
        new_dt = torch.where(active, new_dt, s.dt)
        succ_count = torch.where(bump, 0, succ_count)

        new_s = TrackerState(
            x=new_x, x_last=new_x_last, t=new_t, dt=new_dt,
            succ_count=torch.where(active, succ_count,
                                   s.succ_count).to(torch.int32),
            end_zone=end_zone, check_depths=check, inf_fail=inf_fail,
            pruned=pruned,
            num_steps=s.num_steps + active.to(torch.int32), step=s.step + 1)
        if cph:
            # The handoff holds when no path rolled back; a diverged path
            # goes inactive and does not block it.
            return new_s, (hx0, ~fail.any())
        return new_s

    return step_fn


def make_track_fn(problem: TrifocalProblem, cfg: HCConfig,
                  solve=linalg.solve_batched, dynamic_start: bool = False,
                  dtype=torch.float32):
    """Build ``track(x0 (B, V), target_params (B, P+1), diff_params=None)
    -> TrackResult`` on the device of its inputs.

    dtype: the real dtype of the tracking, torch.float32 (complex64
    solutions) or torch.float64 (complex128).  diff_params=None is target -
    the problem's start parameters in complex64, as the JAX engine forms
    it; with dynamic_start it is required."""
    step_fn = make_step_fn(problem, cfg, solve, dynamic_start=dynamic_start)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64

    def track(x0: torch.Tensor, target_params: torch.Tensor,
              diff_params: Optional[torch.Tensor] = None) -> TrackResult:
        if x0.device != target_params.device:
            raise ValueError("x0 and target_params must share a device")
        if diff_params is None:
            if dynamic_start:
                raise ValueError("dynamic_start needs diff_params")
            sp = torch.as_tensor(problem.start_params,
                                 device=target_params.device)
            diff_params = target_params.to(torch.complex64) - sp
        tgt = target_params.to(cdtype)
        diff = diff_params.to(device=tgt.device, dtype=cdtype)
        s = init_state(x0.to(cdtype), cfg)
        B, nv = x0.shape
        extras = None
        if cfg.predictor_handoff:
            extras = (torch.zeros((B, nv, nv), dtype=cdtype,
                                  device=tgt.device),
                      torch.zeros((), dtype=torch.bool, device=tgt.device))
        while s.step <= cfg.max_steps:
            idx = _active(s, cfg).nonzero()[:, 0]
            if idx.numel() == 0:
                break
            sub, tg, df = s.index(idx), tgt[idx], diff[idx]
            ex = None if extras is None else (extras[0][idx], extras[1])
            for _ in range(min(_CHECK_EVERY, cfg.max_steps + 1 - s.step)):
                if ex is None:
                    sub = step_fn(sub, tg, df)
                else:
                    sub, ex = step_fn(sub, tg, df, ex)
            s = s.put(idx, sub)
            if ex is not None:
                extras = (extras[0].index_copy(0, idx, ex[0]), ex[1])
        # The reference sets the converge flag from t alone, independently
        # of the infinity flag.
        return TrackResult(x=s.x, converged=_is_converged(s.t, cfg),
                           inf_fail=s.inf_fail, pruned=s.pruned,
                           num_steps=s.num_steps)

    return track
