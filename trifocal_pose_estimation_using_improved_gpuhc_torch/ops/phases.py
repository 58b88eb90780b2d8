"""K1's phases alone: the pieces of the tracker's step, each run ``niter``
times per path on fixed state and timed apart.

Counterpart of the JAX round's per-phase microbenchmark
(``tools/microbench_fused.py``: ``build_phase_kernel``, ``run_phase`` and
``run_step``), whose Pallas kernel runs one piece of the TPU kernel's step
in a ``fori_loop`` over realistic state.  Here each phase is a kernel of
``csrc/hc_track.cu`` of its own (``_kernels.hc_phase``), built from K1's
own device functions in K1's build, and ``step`` is ``hc_track`` itself.

* ``PHASE_MAP`` takes each JAX phase name to the port phase that computes
  its function on the card, with a note where the JAX phase is a TPU
  matmul form of a function the card computes one way.
* ``make_state`` builds the state as ``run_phase`` does there: view 0,
  RANSAC seed 0, one hypothesis, its target repeated over the batch and
  the start solutions tiled.  The one departure: the batch is the H = 100
  round's paths (30,700 on the committed problem), not the JAX tool's
  2,048, since 2,048 paths would fill 2,048 of the 2,640 warp slots the
  tracker runs at on an H100 (132 SMs x 5 blocks x 4 warps) and a phase's
  time per path would not be the tracker's.
* ``plain_phase`` is each phase in plain PyTorch, from the functions
  ``fused.track_plain`` runs (``_fill``, ``_assemble``, ``factor_part``,
  ``backsub_plain``, ``solve_plain``, ``resolve_plain``), plus a monomial
  table and a term walk over it, FP32 or with bf16 operands.  The tests
  and the comparisons on the card use it; nothing on the timed path does.
  ``run_phase`` launches the kernel (CUDA tensors only).
* ``two_count`` is the JAX tool's timing: the minimum of runs at two
  iteration counts, the difference over the iterations between them, so
  that fixed costs cancel; ``measure`` times phases on the card by CUDA
  events and puts each beside its bound (``ops/bound.py``).

Iteration i of a phase runs at t = 0.31 + i 1e-7 (the JAX tool's t); a
phase that takes no t moves one entry of its fixed input by d = i 1e-7
(0 at i = 0, so a phase at ``niter=1`` is its piece of ``track_plain``
exactly): the point's entry 0 ("monomials"), monomial 0 ("walk"), the rhs
of row 0 ("elimfam", "elimtail"), the rhs of the first pivot row
("back").  Each iteration adds one value per lane of its result to a
running sum, as the JAX kernel adds into ``out`` to keep its work live.
"elimfam" and "elimtail" iterate on their own output, as the JAX tool's
do: from the second iteration on they eliminate again the system the last
one left, whose eliminated entries are rounding residuals.  Every
candidate row is updated whatever its multiplier, so an iteration does
the operations of one elimination; ``phase_ms`` checks the running sum is
finite after its timed runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    _kernels,
    bound,
    fused,
    ransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import data_io
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    EngineConfig,
    HCConfig,
    ransac_data_dir,
)

_ONE = ("one function on the card, as eval_structure and the FP32 "
        "eval_precision values are")
# JAX phase -> (port phase, note).
PHASE_MAP: Dict[str, Tuple[str, str]] = {
    "fillp": ("fill", ""),
    "front": ("monomials", "the monomial table, formed once per evaluation"),
    "mm5": ("walk", "the gathers and folds as the term walk over a fixed "
                    "monomial table"),
    "mm5s": ("walk", "its exact 3-term split is the FP32 walk"),
    "mm5d": ("walk_bf16", "bf16 operands, FP32 sum"),
    "mm5b": ("walk_bf16", "bf16 operands, FP32 sum"),
    "eval": ("eval", ""),
    "evals": ("eval", _ONE),
    "evalsk": ("eval", _ONE),
    "evalm": ("eval", _ONE),
    "evalk": ("eval", _ONE),
    "evalf": ("eval", _ONE),
    "evalg": ("eval", _ONE),
    "evalgk": ("eval", _ONE),
    "evrhs": ("evrhs", ""),
    "evasm": ("evasm", ""),
    "elim": ("elim", ""),
    "elimfam": ("elimfam", "condensed program only"),
    "elimtail": ("elimtail", "condensed program only; from the family "
                             "steps' state"),
    "back": ("back", ""),
    "evsolve": ("evsolve", ""),
    "replay": ("replay", "the corrector_jacobian_reuse build"),
    "step": ("step", "hc_track itself on fresh state"),
}
# The JAX tool's default phases (its main()).
DEFAULT_PHASES = ("fillp", "mm5", "front", "eval", "evasm", "elim", "back",
                  "evsolve", "step")
PORT_PHASES = _kernels.PHASES + ("step",)
H_BATCH = 100      # the batch: the paths of an H = 100 round
T0, DT = 0.31, 1e-7
_F32 = torch.float32


@dataclasses.dataclass
class PhaseState:
    """The fixed state every phase starts from (see ``make_state``)."""

    problem: TrifocalProblem
    hc: HCConfig
    c: fused.FusedConstants
    x: torch.Tensor            # (B, 30) complex64, position order
    efg: torch.Tensor          # (B, 3, Q) complex64
    plan: Optional[torch.Tensor]   # the kernel plan, on a CUDA device
    target: np.ndarray         # (1, P+1) the hypothesis's target parameters
    tables: Optional[fused._Tables] = None

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    def tb(self) -> fused._Tables:
        if self.tables is None:
            self.tables = fused._Tables(self.c, self.x.device)
        return self.tables


def make_state(problem: TrifocalProblem, cfg: EngineConfig,
               batch: Optional[int] = None, device=None) -> PhaseState:
    """View 0, seed 0, one hypothesis: its target over ``batch`` paths
    (default the H = 100 round's, 100 x the problem's roots), the start
    solutions tiled, the pair coefficients in ``cfg.hc``'s basis, on
    ``device`` (default ``cuda:0``; raises without a card)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the phases run on a CUDA card; pass "
                               "device='cpu' for the plain versions")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    hc = cfg.hc
    B = batch or H_BATCH * problem.num_tracks
    view = data_io.load_ransac_view(ransac_data_dir(cfg), 0)
    s = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     s)
    tgt_b = torch.as_tensor(tgt, device=device).repeat(B, 1)
    reps = -(-B // problem.num_tracks)
    x0 = np.tile(np.asarray(problem.start_sols), (reps, 1))[:B]
    c = fused.FusedConstants.build(problem, solver=fused.solver_of(hc))
    fused.check_variant(hc, c)
    x = torch.as_tensor(np.ascontiguousarray(x0[:, c.perm]), device=device)
    efg = fused.build_pair_coefs(problem, tgt_b, hc.pair_coef_basis)
    plan = (torch.as_tensor(c.kernel_plan(), device=device)
            if device.type == "cuda" else None)
    return PhaseState(problem, hc, c, x.to(torch.complex64).contiguous(),
                      efg, plan, np.asarray(tgt))


def phase_config(hc: HCConfig, phase: str) -> HCConfig:
    """The build a phase runs in: the state's, and for "replay" the
    corrector_jacobian_reuse build (its kernel keeps the multipliers)."""
    if phase == "replay" and not hc.corrector_jacobian_reuse:
        return dataclasses.replace(hc, corrector_jacobian_reuse=1)
    return hc


def run_phase(state: PhaseState, phase: str, niter: int,
              outputs: Optional[Tuple] = None):
    """``niter`` iterations of kernel phase ``phase`` (``_kernels.PHASES``)
    on the state's CUDA tensors, into ``outputs`` if given; returns (out,
    piv, acc) as ``_kernels.hc_phase`` lays them out (which raises on CPU
    tensors)."""
    return _kernels.hc_phase(phase, state.x, state.efg, state.plan, niter,
                             phase_config(state.hc, phase), outputs)


def run_step(state: PhaseState, niter: int, plain: bool = False):
    """``niter`` HC steps of the tracker on fresh state (flags from
    ``init_flags``): ``hc_track`` for CUDA tensors unless ``plain``, else
    ``track_plain``; returns (x, xl, flags)."""
    hc, x = state.hc, state.x
    fl = fused.init_flags(hc, state.batch, x.device)
    if x.device.type == "cuda" and not plain:
        out = (x.clone(), x.clone(), fl)
        _kernels.hc_track(*out, state.efg, state.plan, niter, hc)
        return out
    return fused.track_plain(state.c, hc, x, x, fl, state.efg, niter=niter,
                             tables=state.tb())


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------


def _t(i: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, d) of iteration i in float32, as the kernel forms them:
    d = i * 1e-7, t = 0.31 + d."""
    d = torch.tensor(float(i), dtype=_F32, device=dev) * torch.tensor(
        DT, dtype=_F32, device=dev)
    return torch.tensor(T0, dtype=_F32, device=dev) + d, d


def _cx(z) -> torch.Tensor:
    return torch.complex(z[0], z[1])


def monomial_table(c: fused.FusedConstants, x, split2: bool = False):
    """The evaluation's monomials (``FusedConstants.monomials`` order) at
    position-order x = (re, im), each (A, 30), as the kernel's table
    holds them: x[a] x[b], times x[c] for a cubic one; under ``split2``
    the point and each monomial through the 2-term split."""
    xr, xi = x
    if split2:
        xr, xi = fused._r2(xr), fused._r2(xi)
    A, dev = xr.shape[0], xr.device
    er = torch.cat([xr, xr.new_ones((A, 1))], dim=1)   # homogeneous slot
    ei = torch.cat([xi, xi.new_zeros((A, 1))], dim=1)
    mono = torch.as_tensor(c.monomials(), dtype=torch.long, device=dev)
    a, b, cc = mono[:, 0], mono[:, 1], mono[:, 2]
    vr, vi = fused._cmul(er[:, a], ei[:, a], er[:, b], ei[:, b])
    cub = (cc >= 0).nonzero()[:, 0]
    wr, wi = fused._cmul(vr[:, cub], vi[:, cub], er[:, cc[cub]],
                         ei[:, cc[cub]])
    vr, vi = vr.clone(), vi.clone()
    vr[:, cub], vi[:, cub] = wr, wi
    if split2:
        vr, vi = fused._r2(vr), fused._r2(vi)
    return vr, vi


def _term_tables(c: fused.FusedConstants, dev):
    """The evaluation's entries (``entry_terms``) as padded (coef, q, m,
    valid) tensors, (E, K) each."""
    entries = c.entry_terms()
    k = max(len(t) for t in entries)
    arr = np.zeros((len(entries), k, 3), np.float64)
    valid = np.zeros((len(entries), k), bool)
    for e, terms in enumerate(entries):
        arr[e, :len(terms)] = terms
        valid[e, :len(terms)] = True
    li = arr[..., 1:].astype(np.int64)
    return (torch.as_tensor(arr[..., 0], dtype=_F32, device=dev),
            torch.as_tensor(li[..., 0], device=dev),
            torch.as_tensor(li[..., 1], device=dev),
            torch.as_tensor(valid, device=dev))


def walk_plain(c: fused.FusedConstants, mono, P, R, want_h: bool = False,
               split2: bool = False, bf16: bool = False):
    """The term walk over a monomial table mono = (re, im), each (A, M):
    every entry sums coef * P[q] * monomial (R[q] for an rhs entry) over
    its terms in order, as ``fused._assemble`` does, the rhs negated
    unless ``want_h``; ``bf16`` rounds P[q] and the monomial to bf16
    before their product.  Returns the system (re, im), each (A, 30, 32)."""
    mr, mi = mono
    A, n, dev = mr.shape[0], c.n, mr.device
    coef, q, m, valid = _term_tables(c, dev)
    nnz = len(c.nz_row)
    rhs_entry = torch.zeros(len(coef), dtype=torch.bool, device=dev)
    rhs_entry[nnz:] = True
    zr = torch.where(rhs_entry[:, None], R[0][:, q], P[0][:, q])
    zi = torch.where(rhs_entry[:, None], R[1][:, q], P[1][:, q])
    vr, vi = mr[:, m], mi[:, m]                         # (A, E, K)
    if bf16:
        zr, zi, vr, vi = (fused._bf16(v) for v in (zr, zi, vr, vi))
    pr, pi = fused._cmul(zr, zi, vr, vi)

    def fold(ar, ai):
        ar = torch.where(valid, coef * ar, 0.0)
        ai = torch.where(valid, coef * ai, 0.0)
        acc_r = acc_i = torch.zeros_like(ar[..., 0])
        for k in range(ar.shape[-1]):
            acc_r, acc_i = acc_r + ar[..., k], acc_i + ai[..., k]
        return acc_r, acc_i

    if split2:
        hr, hi = fused._bf16(pr), fused._bf16(pi)
        sr, si = fold(hr, hi)
        lr, li = fold(fused._bf16(pr - hr), fused._bf16(pi - hi))
        sr, si = sr + lr, si + li
    else:
        sr, si = fold(pr, pi)
    out = []
    nz_row = torch.as_tensor(c.nz_row, dtype=torch.long, device=dev)
    nz_col = torch.as_tensor(c.nz_col, dtype=torch.long, device=dev)
    for s in (sr, si):
        sys_ = s.new_zeros((A, n, fused.WIDTH))
        sys_[:, nz_row, nz_col] = s[:, :nnz]
        sys_[:, :, n] = s[:, nnz:] if want_h else -s[:, nnz:]
        out.append(sys_)
    return tuple(out)


def _lanes(v: torch.Tensor) -> torch.Tensor:
    """(A, k) -> (A, 32): the first 32 entries, zero-padded."""
    v = v[:, :32]
    return torch.cat([v, v.new_zeros((v.shape[0], 32 - v.shape[1]))], 1)


def _diag_lanes(mr: torch.Tensor) -> torch.Tensor:
    """Lane l's value of a system: entry (l mod 30, l)."""
    lanes = torch.arange(32, device=mr.device)
    return mr[:, lanes % mr.shape[1], lanes]


def plain_phase(state: PhaseState, phase: str, niter: int):
    """Phase ``phase`` in plain PyTorch, ``niter`` >= 1 iterations, with the
    kernel's arithmetic and its outputs (out, piv, acc) (see
    ``_kernels.hc_phase``), on any device."""
    if phase not in _kernels.PHASES:
        raise ValueError(f"unknown phase {phase!r}")
    if niter < 1:
        raise ValueError(f"niter must be >= 1, got {niter}")
    c, hc, tb = state.c, state.hc, state.tb()
    n_fam = bound.family_steps(c)
    if phase in ("elimfam", "elimtail") and n_fam == 0:
        raise ValueError(f"{phase} runs the condensed program ('reduced') "
                         f"only")
    split2 = hc.eval_precision == "split3_rk2"
    x = fused._planes(state.x)
    ef = fused.efg_planes(state.efg).unbind(1)
    A, dev, n = state.batch, state.x.device, c.n
    ar = torch.arange(A, device=dev)
    fam = [st for st in tb.stages if st[0] < len(tb.maps)]
    tail = [st for st in tb.stages if st[0] >= len(tb.maps)]

    def fill(t, rk=True):
        return fused._fill(ef, t.expand(A), rk=rk, basis=hc.pair_coef_basis)

    def assemble(t, want_h=False, rhs_only=False, rk=True):
        P, R = fill(t, rk)
        return fused._assemble(tb, x, P, R, want_h, rhs_only=rhs_only,
                               split2=split2 and not want_h)

    t0, _ = _t(0, dev)
    out = torch.zeros((A, _kernels.PHASE_OUT), dtype=torch.complex64,
                      device=dev)
    piv_out = torch.full((A, 32), -1, dtype=torch.int32, device=dev)
    acc_r = torch.zeros((A, 32), dtype=_F32, device=dev)
    acc_i = torch.zeros_like(acc_r)
    # The fixed state a phase starts from.
    if phase in ("walk", "walk_bf16", "elimfam", "elimtail", "back"):
        P0, R0 = fill(t0)
        m = fused._assemble(tb, x, P0, R0, False, split2=split2)
        mono = monomial_table(c, x, split2)
    if phase in ("elimtail", "back"):
        f, fstate = fused.factor_part(tb, m, fam if phase == "elimtail"
                                      else tb.stages)
    if phase == "replay":
        kept = fused.factor_plain(tb, assemble(t0, want_h=True, rk=False))

    for i in range(niter):
        t, d = _t(i, dev)
        if phase == "fill":
            P, R = fill(t)
            res = (P, R)
            vr, vi = _lanes(P[0] + R[0]), _lanes(P[1] + R[1])
        elif phase == "monomials":
            xr = x[0].clone()
            xr[:, 0] = xr[:, 0] + d
            res = monomial_table(c, (xr, x[1]), split2)
            vr, vi = res[0][:, :32], res[1][:, :32]
        elif phase in ("walk", "walk_bf16"):
            mr_, mi_ = mono[0].clone(), mono[1]
            mr_[:, 0] = mono[0][:, 0] + d
            res = walk_plain(c, (mr_, mi_), P0, R0, split2=split2,
                             bf16=phase == "walk_bf16")
        elif phase in ("elimfam", "elimtail"):
            m[0][:, 0, n] = m[0][:, 0, n] + d
            f, _ = fused.factor_part(tb, m, fam if phase == "elimfam"
                                     else tail,
                                     None if phase == "elimfam" else fstate)
            res = (f.mr, f.mi)
        elif phase == "back":
            p0 = f.piv[:, 0]
            m[0][ar, p0, n] = m[0][ar, p0, n] + d
            res = fused.backsub_plain(tb, f.mr, f.mi, f.piv)
        elif phase == "replay":
            res = fused.resolve_plain(tb, kept, assemble(
                t, want_h=True, rhs_only=True, rk=False))
        elif phase == "evrhs":
            res = assemble(t, rhs_only=True)
        elif phase in ("eval", "evasm"):
            res = assemble(t)
        elif phase == "elim":
            f = fused.factor_plain(tb, assemble(t))
            res = (f.mr, f.mi)
        else:  # evsolve
            res = fused.solve_plain(tb, assemble(t))
        if phase in ("back", "evsolve", "replay"):
            vr, vi = fused._pad_lanes(res[0]), fused._pad_lanes(res[1])
        elif phase == "evrhs":
            lanes = torch.arange(32, device=dev) % n
            vr, vi = res[0][:, lanes], res[1][:, lanes]
        elif phase not in ("fill", "monomials"):
            vr, vi = _diag_lanes(res[0]), _diag_lanes(res[1])
        acc_r, acc_i = acc_r + vr, acc_i + vi

    if phase == "fill":
        q = c.q
        out[:, :q], out[:, fused.QMAX:fused.QMAX + q] = _cx(res[0]), _cx(
            res[1])
    elif phase == "monomials":
        out[:, :res[0].shape[1]] = _cx(res)
    elif phase in ("evrhs", "back", "evsolve", "replay"):
        out[:, :n] = _cx(res)
    else:
        out[:, :n * fused.WIDTH] = _cx(res).reshape(A, -1)
        if phase in ("elim", "elimfam", "elimtail"):
            lo = n_fam if phase == "elimtail" else 0
            hi = n_fam if phase == "elimfam" else c.num_steps
            piv_out[:, lo:hi] = f.piv[:, lo:hi].to(torch.int32)
    acc = torch.complex(fused._lane_sum(acc_r), fused._lane_sum(acc_i))
    return out, piv_out, acc


# ---------------------------------------------------------------------------
# Timing, on the card.
# ---------------------------------------------------------------------------


def two_count(timed: Callable[[int], float], iters: int,
              step: bool = False) -> float:
    """Per-iteration time by the JAX tool's arithmetic: after one warm-up
    run, the minimum of runs at two iteration counts, lo and hi, and
    (min at hi - min at lo) / (hi - lo), so that fixed costs cancel.
    Phases: lo = iters, hi = 2 iters, 5 runs each (warm-up at 4); the
    step (``step``): lo = max(2, iters // 4), hi = iters // 2, 3 runs
    each (warm-up at 2).  ``timed(n)`` is the time of one run of n
    iterations."""
    if step:
        timed(2)
        lo, hi, runs = max(2, iters // 4), iters // 2, 3
    else:
        timed(4)
        lo, hi, runs = iters, 2 * iters, 5
    if hi <= lo:
        raise ValueError(f"iters={iters} gives no two counts")
    t_lo = min(timed(lo) for _ in range(runs))
    t_hi = min(timed(hi) for _ in range(runs))
    return (t_hi - t_lo) / (hi - lo)


def cuda_ms(fn: Callable[[], object], setup: Callable[[], object] = None
            ) -> float:
    """ms of fn() on the current stream by CUDA events (``setup()`` runs
    before, outside the events)."""
    args = setup() if setup is not None else None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn() if args is None else fn(args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _on_card(state: PhaseState) -> None:
    if state.x.device.type != "cuda":
        raise RuntimeError("the phases are timed on a CUDA card only")


def phase_ms(state: PhaseState, phase: str, iters: int) -> float:
    """ms per iteration over the batch of a kernel phase (its outputs
    allocated once, outside the events), or of "step" (``hc_track`` on
    fresh state, the state's copy outside the events), by ``two_count``.
    Raises if the last timed run's result or running sum is not finite."""
    _on_card(state)
    if phase == "step":
        hc = state.hc

        def timed(k):
            def fresh():
                return (state.x.clone(), state.x.clone(),
                        fused.init_flags(hc, state.batch, state.x.device))

            return cuda_ms(lambda s: _kernels.hc_track(
                *s, state.efg, state.plan, k, hc), fresh)

        return two_count(timed, iters, step=True)
    bufs = run_phase(state, phase, 1)   # the outputs every timed run reuses
    ms = two_count(lambda k: cuda_ms(
        lambda: run_phase(state, phase, k, outputs=bufs)), iters)
    out, _, acc = bufs
    if not (bool(torch.isfinite(torch.view_as_real(acc)).all())
            and bool(torch.isfinite(torch.view_as_real(out)).all())):
        raise RuntimeError(f"phase {phase}: a non-finite result after "
                           f"{2 * iters} iterations")
    return ms


def step_flops(state: PhaseState, iters: int) -> float:
    """FP32 operations per step over the batch, in the steps ``two_count``
    times for "step" (lo to hi from fresh state): the work track_plain
    counts there (``bound.tracker_flops``), over hi - lo."""
    lo, hi = max(2, iters // 4), iters // 2
    x, xl, fl = run_step(state, lo, plain=True)
    work: dict = {}
    fused.track_plain(state.c, state.hc, x, xl, fl, state.efg,
                      niter=hi - lo, tables=state.tb(), work=work)
    order = _kernels.hc_track_variant(state.hc)[0]
    return bound.tracker_flops(state.c, work, order,
                               state.hc.pair_coef_basis) / (hi - lo)


def phase_bound_ms(state: PhaseState, phase: str,
                   step_iters: int = 64) -> float:
    """The least time of one iteration over the batch: its FP32 operations
    (``bound.phase_flops`` per path; "step": ``step_flops``) over the
    card's FP32 rate.  A phase's bytes move once per launch, not per
    iteration, so operations bound it."""
    hc = state.hc
    if phase == "step":
        flops = step_flops(state, step_iters)
    else:
        flops = state.batch * bound.phase_flops(
            state.c, phase, hc.pair_coef_basis,
            split2=hc.eval_precision == "split3_rk2")
    return flops / bound.PEAK_FLOPS * 1e3


def measure(state: PhaseState, phases: List[str], iters: int,
            step_iters: int) -> List[dict]:
    """Time each port phase (and "step", first, for the shares) on the
    card; per phase: ms and µs per iteration over the batch, ns per
    path-iteration, its share of one step, its bound and the share of
    the bound reached, and the resident blocks per SM of its kernel and
    of the tracker in the same build."""
    _on_card(state)
    step = phase_ms(state, "step", step_iters)
    rows = []
    for ph in phases:
        ms = step if ph == "step" else phase_ms(state, ph, iters)
        b = phase_bound_ms(state, ph, step_iters)
        hc_p = phase_config(state.hc, ph)
        k1 = _kernels.hc_track_blocks_per_sm(hc_p, state.x.device)
        own = k1 if ph == "step" else _kernels.hc_phase_blocks_per_sm(
            ph, hc_p, state.x.device)
        rows.append(dict(phase=ph, ms=ms, us=ms * 1e3,
                         ns_per_path=ms * 1e6 / state.batch,
                         step_share=ms / step, bound_ms=b,
                         bound_share=b / ms if ms > 0 else float("nan"),
                         blocks_per_sm=own, tracker_blocks_per_sm=k1))
    return rows
