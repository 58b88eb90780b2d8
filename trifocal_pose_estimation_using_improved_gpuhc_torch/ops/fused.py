"""The HC path tracker: host constants, the plain PyTorch twin of the CUDA
kernel, and the wrapper that dispatches between them.

Counterpart of the JAX package's ``ops/fused.py``, whose one Pallas kernel
(``_make_kernel``) runs up to ``niter`` HC steps per path: end-zone clamp,
TrunPaths depth pruning, an RK4 predictor, a Newton corrector of at most
``max_correction_steps`` iterations and the adaptive step size.  Here:

* ``FusedConstants.build`` ports the production subset of the reference's
  constants: the variable permutation and the equation-row order of the
  solve, the Hx nonzero order, the depth positions, plus the solve program
  and evaluation tables both implementations below execute.  The TPU's
  one-hot matmul constants are not ported: the card gathers by index.
* ``track_plain`` is the whole step loop on batch-first complex64 tensors.
* ``csrc/hc_track.cu`` (bound in ``ops/_kernels.py``) is the same loop as
  one warp per path; ``make_track_fn`` launches it for CUDA tensors and
  runs ``track_plain`` for CPU tensors.

Everything runs in the permuted space of the solve: variable ``perm[i]``
sits at position ``i``, equation ``row_order[r]`` at row ``r``.  The
augmented system is (30, 32): 30 position columns, the right-hand side at
column 30, one zero pad column.

The solve is a program of pivot steps on the whole matrix, built on the
host from one of two symbolic plans (``HCConfig.solver``):

* ``"reduced"``: the condensed elimination of ``ops/reduce.py``.  Family
  groups of one level run as one stage; the rows a level's groups leave
  behind (in ascending slot order) are looked up through a per-path row
  map, which is all that the reference's compaction does.
* ``"schedule"``: the 30-step static schedule of ``ops/schedule.py``
  (the reference's ``_solve`` -> ``_eliminate``/``_backsub``).  One level,
  no row maps; position ``s`` is step ``s``'s column, and its candidate
  rows come in the interval row order (``find_interval_row_order``).

Each step picks, among its candidate rows not yet used as pivots, the
largest |Re|+|Im| entry of its column (first hit in candidate order, a NaN
winning as in ``torch.argmax``), scales by conj(pivot)/|pivot|^2 with a
zero pivot's |pivot|^2 replaced by 1, and eliminates the column from the
other live candidates.  Back-substitution walks the steps in reverse using
the pivot rows, which no later step modifies.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models.trifocal import (
    TrifocalProblem,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import reduce as redu
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import schedule as sched
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    HCConfig,
)

# Flag columns (the reference's 8-row flag layout, batch-first here): t, dt,
# succ_count, end_zone, check_depths, inf_fail, pruned, num_steps (all f32;
# bools are 0/1).
_F_T, _F_DT, _F_SC, _F_EZ, _F_CK, _F_INF, _F_PRN, _F_NST = range(8)
N_FLAGS = 8
WIDTH = 32       # augmented row: 30 columns, rhs, pad
CMAX = 32        # candidate slots per step in the kernel's plan: one lane each
STEP_INTS = 4 + CMAX
QMAX = 64        # parameter pairs the kernel holds per path


@dataclasses.dataclass(frozen=True)
class Stage:
    """Independent pivot steps eliminated together (one level's family
    step, or one step of the reduced system)."""

    level: int                # row-map level the candidates index
    steps: Tuple[int, ...]    # global step indices (back-substitution slots)
    cols: Tuple[int, ...]     # position column each step eliminates
    cands: Tuple[Tuple[int, ...], ...]  # per step: level-row indices, in
    # tie-break order


@dataclasses.dataclass(frozen=True)
class FusedConstants:
    """Host constants of the tracker (numpy; see the module docstring)."""

    perm: np.ndarray          # (n,) position -> original var
    pos_of_var: np.ndarray    # (n,) original var -> position
    row_order: np.ndarray     # (n,) row -> original equation
    pos_of_row: np.ndarray    # (n,) original equation -> row
    nz_order: np.ndarray      # (NNZ,) Hx nonzero slots sorted by (row, col)
    nz_row: np.ndarray        # (NNZ,) row of each nonzero in that order
    nz_col: np.ndarray        # (NNZ,) position column of each nonzero
    depth_rows: Tuple[int, ...]   # positions of depth vars 0..7
    solver: str               # "reduced" or "schedule": the program below
    plan: Optional[redu.ReductionPlan]   # the condensed plan ("reduced")
    stages: Tuple[Stage, ...]
    map0: np.ndarray          # (n,) level-0 row index -> row
    maps: Tuple[np.ndarray, ...]  # level l+1 from level l: (n_l+1, 4) of
    # (src0, src1, src2, k): the k-th unused of the src rows (-1 pads)
    # Evaluation tables in position space (var index n = homogeneous 1).
    qa: np.ndarray            # (M2,)
    qb: np.ndarray
    ca: np.ndarray            # (M3,)
    cb: np.ndarray
    cc: np.ndarray
    pp_a: np.ndarray          # (Q,) original param indices
    pp_b: np.ndarray
    hx_q: np.ndarray          # (K2,)
    hx_m: np.ndarray
    hx_C: np.ndarray          # (K2, NNZ) columns in nz_order
    ht_q: np.ndarray          # (K3,)
    ht_m: np.ndarray
    ht_C: np.ndarray          # (K3, n) columns in row order
    n: int
    q: int

    @property
    def num_steps(self) -> int:
        return sum(len(s.steps) for s in self.stages)

    @classmethod
    def build(cls, problem: TrifocalProblem,
              solver: str = "reduced") -> "FusedConstants":
        """Constants of the ``solver`` program.  As in the reference,
        "reduced" falls back to the schedule when the Jacobian pattern has
        no condensation (``reduce.build_reduction`` returns None)."""
        if solver not in ("reduced", "schedule"):
            raise ValueError(f"unknown solver {solver!r}")
        f = problem.factored
        n = problem.num_vars
        nnz = f.hx_C.shape[1]
        pattern = f.hx_scatter.reshape(n, n) != nnz
        plan = redu.build_reduction(pattern) if solver == "reduced" else None
        if plan is not None:
            perm, row_order = _reduced_perm_rows(plan)
        else:
            schedule = sched.build_schedule(pattern)
            perm = np.array([st.col for st in schedule.steps], np.int32)
            row_order = sched.find_interval_row_order(schedule)
        pos_of_var = np.argsort(perm).astype(np.int32)
        pos_of_row = np.argsort(row_order).astype(np.int32)

        entries = []  # (row, position col, slot)
        for flat, slot in enumerate(f.hx_scatter):
            if slot == nnz:
                continue
            eq, var = divmod(flat, n)
            entries.append((int(pos_of_row[eq]), int(pos_of_var[var]),
                            int(slot)))
        entries.sort()
        nz_row = np.array([e[0] for e in entries], np.int32)
        nz_col = np.array([e[1] for e in entries], np.int32)
        nz_order = np.array([e[2] for e in entries], np.int32)

        if plan is not None:
            stages, map0, maps = _solve_program(plan, pos_of_var, pos_of_row)
        else:
            stages, map0, maps = _schedule_program(schedule, pos_of_row)

        pv = np.append(pos_of_var, n).astype(np.int32)  # homogeneous stays n
        return cls(
            perm=perm, pos_of_var=pos_of_var, row_order=row_order,
            pos_of_row=pos_of_row, nz_order=nz_order, nz_row=nz_row,
            nz_col=nz_col,
            depth_rows=tuple(int(pos_of_var[v]) for v in range(8)),
            solver="reduced" if plan is not None else "schedule",
            plan=plan, stages=stages, map0=map0, maps=maps,
            qa=pv[f.qm_a], qb=pv[f.qm_b],
            ca=pv[f.cm_a], cb=pv[f.cm_b], cc=pv[f.cm_c],
            pp_a=f.pp_a.astype(np.int32), pp_b=f.pp_b.astype(np.int32),
            hx_q=f.hx_q, hx_m=f.hx_m,
            hx_C=np.ascontiguousarray(f.hx_C[:, nz_order]),
            ht_q=f.ht_q, ht_m=f.ht_m,
            ht_C=np.ascontiguousarray(f.ht_C[:, row_order]),
            n=n, q=len(f.pp_a),
        )

    def kernel_plan(self) -> np.ndarray:
        """Every table the CUDA kernel reads, packed into one int32 array
        behind a 16-int header of (count, offset) fields."""
        n = self.n
        if n != 30 or self.q > QMAX:
            raise ValueError(f"the kernel takes n=30 and Q<={QMAX}, got "
                             f"n={n}, Q={self.q}")
        steps = np.full((self.num_steps, STEP_INTS), -1, np.int32)
        for st in self.stages:
            for s, col, cand in zip(st.steps, st.cols, st.cands):
                if len(cand) > CMAX:
                    raise ValueError(f"step {s} has {len(cand)} candidates")
                steps[s, :3] = (st.level, col, len(cand))
                steps[s, 4:4 + len(cand)] = cand
        maps = np.full((len(self.maps), 32, 4), -1, np.int32)
        for lv, m in enumerate(self.maps):
            maps[lv, :len(m)] = m
        # Per-row term lists: Hx terms (col, coef, q, a, b) grouped by
        # column, and rhs terms (coef, q, a, b, c).
        nz_terms, rhs_terms = self.term_lists()
        hx_terms: List[List[Tuple]] = [[] for _ in range(n)]
        for j, terms in enumerate(nz_terms):
            hx_terms[self.nz_row[j]].extend(
                (self.nz_col[j],) + t for t in terms)

        def flat(lists):
            off = np.cumsum([0] + [len(t) for t in lists]).astype(np.int32)
            terms = np.array([t for ts in lists for t in ts], np.float64)
            if np.any(terms != np.round(terms)):
                raise ValueError("non-integer evaluation coefficient")
            return off, terms.astype(np.int32).reshape(-1)

        hx_off, hx_t = flat(hx_terms)
        rhs_off, rhs_t = flat(rhs_terms)
        parts = [self.map0.astype(np.int32), steps.reshape(-1),
                 maps.reshape(-1), hx_off, hx_t, rhs_off, rhs_t,
                 np.array(self.depth_rows, np.int32)]
        header = np.zeros(16, np.int32)
        header[:4] = (n, self.q, self.num_steps, len(self.maps))
        off = 16
        for i, p in enumerate(parts):
            header[4 + i] = off
            off += p.size
        return np.concatenate([header] + parts).astype(np.int32)

    def term_lists(self):
        """The evaluation as term lists, in the order both implementations
        sum them: per Hx nonzero (in nz_order) its (coef, q, a, b) terms,
        coef * P[q] * x[a] * x[b]; per row its rhs (coef, q, a, b, c)
        terms, coef * R[q] * x[a] * x[b] * x[c]."""
        nz_terms = []
        for j in range(len(self.nz_row)):
            nz_terms.append([
                (self.hx_C[k, j], self.hx_q[k], self.qa[self.hx_m[k]],
                 self.qb[self.hx_m[k]])
                for k in np.nonzero(self.hx_C[:, j])[0]])
        rhs_terms = []
        for r in range(self.n):
            rhs_terms.append([
                (self.ht_C[k, r], self.ht_q[k], self.ca[self.ht_m[k]],
                 self.cb[self.ht_m[k]], self.cc[self.ht_m[k]])
                for k in np.nonzero(self.ht_C[:, r])[0]])
        return nz_terms, rhs_terms


def _reduced_perm_rows(plan: redu.ReductionPlan):
    """Variable permutation and row order of the condensed layout: each
    family's local columns family-major (step k of group q at base +
    k * nG + q), then the reduced system's columns in elimination order;
    level-0 rows slot-major per family."""
    n = plan.n
    fams = sorted(plan.families, key=lambda f: f.level)
    perm: List[int] = []
    for fam in fams:
        for k in range(fam.l):
            perm.extend(gr.local_cols[k] for gr in fam.groups)
    perm.extend(plan.final_cols)
    rows: List[int] = []
    for fam in (f for f in plan.families if f.level == 0):
        for j in range(fam.g):
            rows.extend(gr.rows[j] for gr in fam.groups)
    rows.extend(r for r in range(n) if r not in set(rows))
    if sorted(perm) != list(range(n)):
        raise ValueError("condensed plan does not cover every column")
    return np.array(perm, np.int32), np.array(rows, np.int32)


def _solve_program(plan: redu.ReductionPlan, pos_of_var, pos_of_row):
    """Stages and row maps executing ``plan`` (see the module docstring).

    Level-0 row indices are original equations; the rows of level l+1 are
    the survivors of level l's groups (groups in ascending row order, g - l
    survivors each, ascending slot order), then its passthrough rows.
    The reduced system's steps take their candidates in the row order the
    reference lays them out in (``schedule.find_interval_row_order``)."""
    stages: List[Stage] = []
    maps: List[np.ndarray] = []
    step = 0
    n_rows = plan.n
    for level in range(plan.num_levels):
        fams = [f for f in plan.families if f.level == level]
        for fam in fams:
            for k in range(fam.l):
                idx = tuple(range(step, step + len(fam.groups)))
                step += len(fam.groups)
                stages.append(Stage(
                    level=level, steps=idx,
                    cols=tuple(int(pos_of_var[gr.local_cols[k]])
                               for gr in fam.groups),
                    cands=tuple(tuple(gr.rows) for gr in fam.groups)))
        groups = sorted((g for f in fams for g in f.groups),
                        key=lambda g: g.rows)
        spec = []
        grouped = set()
        for gr in groups:
            grouped.update(gr.rows)
            src = list(gr.rows) + [-1] * (3 - len(gr.rows))
            for s in range(len(gr.rows) - len(gr.local_cols)):
                spec.append(src + [s])
        for r in range(n_rows):
            if r not in grouped:
                spec.append([r, -1, -1, 0])
        maps.append(np.array(spec, np.int32))
        n_rows = len(spec)
    order2 = sched.find_interval_row_order(plan.schedule)
    pos2 = np.argsort(order2)
    for st, col in zip(plan.schedule.steps, plan.final_cols):
        cand = tuple(sorted(st.rows, key=lambda r: pos2[r]))
        stages.append(Stage(level=plan.num_levels, steps=(step,),
                            cols=(int(pos_of_var[col]),), cands=(cand,)))
        step += 1
    if step != plan.n:
        raise ValueError(f"solve program has {step} steps for {plan.n} columns")
    return tuple(stages), pos_of_row.astype(np.int32), tuple(maps)


def _schedule_program(schedule: sched.SolveSchedule, pos_of_row):
    """Stages executing the static schedule: step s eliminates position
    column s (perm is the schedule's column order), its candidates are the
    original equations of ``schedule.steps[s].rows`` in row-position
    order, all on level 0, whose row map is ``pos_of_row``."""
    stages = tuple(
        Stage(level=0, steps=(s,), cols=(s,),
              cands=(tuple(sorted(st.rows, key=lambda r: pos_of_row[r])),))
        for s, st in enumerate(schedule.steps))
    return stages, pos_of_row.astype(np.int32), ()


# ---------------------------------------------------------------------------
# Per-path coefficients and flags.
# ---------------------------------------------------------------------------


def build_pair_coefs(problem: TrifocalProblem, target_params: torch.Tensor
                     ) -> torch.Tensor:
    """Per-path pair-product coefficients in the two-point ("efg") basis.

    P_q(t) = t^2 E + t(1-t) F + (1-t)^2 G with E = tgt_a tgt_b, F = tgt_a
    s_b + s_a tgt_b, G = s_a s_b (s = the problem's start parameters):
    exact at t = 1.  target_params (B, P+1) complex64 -> (B, 3, Q)
    complex64 holding E, F, G."""
    f = problem.factored
    dev = target_params.device
    a = torch.as_tensor(f.pp_a, dtype=torch.long, device=dev)
    b = torch.as_tensor(f.pp_b, dtype=torch.long, device=dev)
    sp = torch.as_tensor(problem.start_params, device=dev)
    ta, tb = target_params[:, a], target_params[:, b]
    sa, sb = sp[a], sp[b]
    e_re = ta.real * tb.real - ta.imag * tb.imag
    e_im = ta.real * tb.imag + ta.imag * tb.real
    f_re = ta.real * sb.real - ta.imag * sb.imag + sa.real * tb.real \
        - sa.imag * tb.imag
    f_im = ta.real * sb.imag + ta.imag * sb.real + sa.real * tb.imag \
        + sa.imag * tb.real
    g = torch.complex(sa.real * sb.real - sa.imag * sb.imag,
                      sa.real * sb.imag + sa.imag * sb.real)
    out = torch.stack([torch.complex(e_re, e_im), torch.complex(f_re, f_im),
                       g.expand_as(ta)], dim=1)
    return out.contiguous()


def init_flags(cfg: HCConfig, B: int, device=None) -> torch.Tensor:
    """Fresh per-path tracker state (B, 8); see the _F_* layout."""
    fl = torch.zeros((B, N_FLAGS), dtype=torch.float32, device=device)
    fl[:, _F_DT] = cfg.init_delta_t
    fl[:, _F_CK] = 1.0 if cfg.truncate_paths else 0.0
    return fl


def flags_outputs(cfg: HCConfig, fl: torch.Tensor):
    """flags (B, 8) -> (converged, inf_fail, pruned, num_steps), (B,)."""
    t = fl[:, _F_T]
    converged = (t >= 1.0) | (1.0 - t <= cfg.t_converged_eps)
    return (converged, fl[:, _F_INF] > 0.5, fl[:, _F_PRN] > 0.5,
            fl[:, _F_NST].to(torch.int32))


# ---------------------------------------------------------------------------
# The plain PyTorch twin of the kernel.
# ---------------------------------------------------------------------------


class _Tables:
    """FusedConstants as index/coefficient tensors on one device, with the
    term lists padded to rectangles (a padded term has coef 0 and valid
    False)."""

    def __init__(self, c: FusedConstants, device):
        def li(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        def padded(lists, width):
            k = max(len(t) for t in lists)
            out = np.zeros((len(lists), k, width), np.float64)
            valid = np.zeros((len(lists), k), bool)
            for i, terms in enumerate(lists):
                if terms:
                    out[i, :len(terms)] = terms
                    valid[i, :len(terms)] = True
            coef = torch.as_tensor(out[..., 0], dtype=torch.float32,
                                   device=device)
            idx = [li(out[..., j].astype(np.int64)) for j in range(1, width)]
            return coef, idx, torch.as_tensor(valid, device=device)

        self.c = c
        self.nz_row, self.nz_col = li(c.nz_row), li(c.nz_col)
        self.map0, self.depth = li(c.map0), li(c.depth_rows)
        nz_terms, rhs_terms = c.term_lists()
        self.hx_coef, (self.hx_q, self.hx_a, self.hx_b), self.hx_valid = \
            padded(nz_terms, 4)
        self.rhs_coef, (self.rhs_q, self.rhs_a, self.rhs_b, self.rhs_c), \
            self.rhs_valid = padded(rhs_terms, 5)
        self.maps = [li(m) for m in c.maps]
        self.stages = [(st.level, li(st.steps), li(st.cols), li(st.cands))
                       for st in c.stages]
        cols = np.zeros(c.num_steps, np.int64)
        for st in c.stages:
            cols[list(st.steps)] = st.cols
        self.step_cols = cols.tolist()


# Complex values are (re, im) pairs of float32 tensors, and every product
# and sum is written out in the kernel's order, one rounding per operation
# (the kernel is built without FMA contraction): the two implementations
# then agree bit for bit on the card, and with the CPU.


def _cmul(ar, ai, br, bi):
    """a * b, as the kernel's cmul computes it."""
    return ar * br - ai * bi, ar * bi + ai * br


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension (32 lanes) in the order of the kernel's
    xor-shuffle butterfly."""
    w = v.shape[-1]
    while w > 1:
        w //= 2
        v = v[..., :w] + v[..., w:]
    return v[..., 0]


def _pad_lanes(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, v.new_zeros(v.shape[:-1] + (WIDTH - v.shape[-1],))],
                     dim=-1)


def _planes(z: torch.Tensor):
    return z.real.contiguous(), z.imag.contiguous()


def efg_planes(efg: torch.Tensor) -> torch.Tensor:
    """(B, 3, Q) complex E, F, G -> (B, 6, Q) float32 planes E re, E im,
    F re, F im, G re, G im."""
    return torch.cat([torch.view_as_real(efg[:, i]).permute(0, 2, 1)
                      for i in range(3)], dim=1)


def _fill(efg, t: torch.Tensor, rk: bool):
    """Pair products at t for the Hx half and, for the rhs half, their
    t-derivative (RK stages) or the products again (corrector).
    efg: six (A, Q) planes (E, F, G re/im), t (A,) -> P, R as (re, im)."""
    er, ei, fr, fi, gr, gi = efg
    t = t[:, None]
    v = 1.0 - t
    tt, tv, vv = t * t, t * v, v * v
    P = (tt * er + (tv * fr + vv * gr), tt * ei + (tv * fi + vv * gi))
    if not rk:
        return P, P
    t2 = 2.0 * t
    a, b = 1.0 - t2, 2.0 * v
    return P, (t2 * er + (a * fr - b * gr), t2 * ei + (a * fi - b * gi))


def _assemble(tb: _Tables, x, P, R, want_h: bool):
    """Augmented systems (re, im), each (A, 30, 32), at position-order x
    (re, im): the Hx nonzeros and the rhs, H (corrector) or -Ht (RK
    stages); each entry sums its terms in term-list order."""
    xr, xi = x
    A, n = xr.shape[0], tb.c.n
    er = torch.cat([xr, xr.new_ones((A, 1))], dim=1)   # homogeneous slot
    ei = torch.cat([xi, xi.new_zeros((A, 1))], dim=1)

    def sum_terms(coef, q, mono, valid, Z):
        vr, vi = _cmul(Z[0][:, q], Z[1][:, q], *mono)
        vr = torch.where(valid, coef * vr, 0.0)
        vi = torch.where(valid, coef * vi, 0.0)
        acc_r = acc_i = torch.zeros_like(vr[..., 0])
        for k in range(vr.shape[-1]):
            acc_r, acc_i = acc_r + vr[..., k], acc_i + vi[..., k]
        return acc_r, acc_i

    hx = sum_terms(tb.hx_coef, tb.hx_q,
                   _cmul(er[:, tb.hx_a], ei[:, tb.hx_a],
                         er[:, tb.hx_b], ei[:, tb.hx_b]),
                   tb.hx_valid, P)
    x2 = _cmul(er[:, tb.rhs_a], ei[:, tb.rhs_a], er[:, tb.rhs_b],
               ei[:, tb.rhs_b])
    rhs = sum_terms(tb.rhs_coef, tb.rhs_q,
                    _cmul(*x2, er[:, tb.rhs_c], ei[:, tb.rhs_c]),
                    tb.rhs_valid, R)
    out = []
    for h, r in zip(hx, rhs):
        m = xr.new_zeros((A, n, WIDTH))
        m[:, tb.nz_row, tb.nz_col] = h
        m[:, :, n] = r if want_h else -r
        out.append(m)
    return tuple(out)


def _inv_den(pr, pi):
    """|p|^2 with a zero replaced by 1."""
    den = pr * pr + pi * pi
    return torch.where(den == 0.0, torch.ones_like(den), den)


def solve_plain(tb: _Tables, m, return_pivots: bool = False):
    """Condensed restricted-pivoting solve of the augmented systems
    m = (re, im), each (A, 30, 32), overwritten; returns x (re, im), each
    (A, 30) in position order (and the pivot row of every step)."""
    mr, mi = m
    A, n = mr.shape[0], tb.c.n
    ar = torch.arange(A, device=mr.device)
    a3 = ar[:, None, None]
    used = torch.zeros((A, n), dtype=torch.bool, device=mr.device)
    rmap = tb.map0.expand(A, n)
    level = 0
    piv = torch.empty((A, tb.c.num_steps), dtype=torch.long, device=mr.device)
    for lv, steps, cols, cands in tb.stages:
        while level < lv:
            rmap = _next_map(rmap, used, tb.maps[level])
            level += 1
        rows = rmap[:, cands]                              # (A, S, C)
        vr = mr[a3, rows, cols[None, :, None]]             # (A, S, C)
        vi = mi[a3, rows, cols[None, :, None]]
        was = used[a3, rows]
        metric = vr.abs() + vi.abs()
        metric = torch.where(was, torch.full_like(metric, -1.0), metric)
        k = torch.argmax(metric, dim=2, keepdim=True)      # first max
        p = rows.gather(2, k)[..., 0]                      # (A, S)
        piv[:, steps] = p
        pr, pi = vr.gather(2, k), vi.gather(2, k)
        den = _inv_den(pr, pi)
        ir, ii = pr / den, -pi / den
        fr = (vr * ir - vi * ii)[..., None]
        fi = (vr * ii + vi * ir)[..., None]
        live = (~was & (rows != p[..., None]))[..., None]
        prr = mr[ar[:, None], p][:, :, None, :]            # (A, S, 1, W)
        pri = mi[ar[:, None], p][:, :, None, :]
        old_r, old_i = mr[a3, rows], mi[a3, rows]          # (A, S, C, W)
        mr[a3, rows] = torch.where(live, old_r - (fr * prr - fi * pri), old_r)
        mi[a3, rows] = torch.where(live, old_i - (fr * pri + fi * prr), old_i)
        used[ar[:, None], p] = True
    # Back-substitution, one step at a time from the last, as the kernel.
    xsr = mr.new_zeros((A, WIDTH))
    xsi = mr.new_zeros((A, WIDTH))
    xsr[:, n] = -1.0
    for st in range(tb.c.num_steps - 1, -1, -1):
        col = tb.step_cols[st]
        prr, pri = mr[ar, piv[:, st]], mi[ar, piv[:, st]]  # (A, W)
        sr, si = (_lane_sum(v) for v in _cmul(prr, pri, xsr, xsi))
        den = _inv_den(prr[:, col], pri[:, col])
        xsr[:, col], xsi[:, col] = _cmul(sr, si, -prr[:, col] / den,
                                         pri[:, col] / den)
    out = (xsr[:, :n], xsi[:, :n])
    return (out, piv) if return_pivots else out


def _next_map(rmap, used, spec):
    """Rows of the next level: the k-th unused of each spec's src rows."""
    src = spec[:, :3]
    ok = src >= 0
    phys = rmap[:, src.clamp(min=0)]                       # (A, N, 3)
    free = ~torch.gather(used, 1, phys.reshape(len(rmap), -1)).reshape(
        phys.shape) & ok
    rank = torch.cumsum(free.to(torch.int32), dim=2) - 1
    pick = free & (rank == spec[:, 3:4])
    return (phys * pick).sum(2)


def track_plain(consts: FusedConstants, cfg: HCConfig, x: torch.Tensor,
                xl: torch.Tensor, flags: torch.Tensor, efg: torch.Tensor,
                niter: Optional[int] = None, tables: Optional[_Tables] = None,
                work: Optional[dict] = None):
    """Run up to ``niter`` HC steps (default max_steps + 1) on resumable
    state, in plain torch.  x, xl (B, 30) complex64 in position order,
    flags (B, 8) float32, efg (B, 3, Q) complex64.  Returns new
    (x, xl, flags); the inputs are not modified.

    Paths are independent, so each step runs on the still-active paths
    only (a finished path's state is final, as in the kernel).  ``work``,
    if given, counts what the paths really did: ``steps`` (path-steps
    that ran the predictor) and ``newton`` (path corrector iterations),
    added to its entries; both are known on the host at no cost."""
    tb = tables or _Tables(consts, x.device)
    niter = cfg.max_steps + 1 if niter is None else niter
    st = torch.stack([*_planes(x), *_planes(xl)], dim=1)   # (B, 4, 30)
    ef = efg_planes(efg)
    flags = flags.clone()
    for _ in range(niter):
        t = flags[:, _F_T]
        conv = (t >= 1.0) | (1.0 - t <= cfg.t_converged_eps)
        act = ~conv & (flags[:, _F_INF] < 0.5) & (flags[:, _F_PRN] < 0.5)
        idx = act.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        st[idx], flags[idx] = _step(tb, cfg, st[idx], flags[idx], ef[idx],
                                    work)
    return (torch.complex(st[:, 0], st[:, 1]),
            torch.complex(st[:, 2], st[:, 3]), flags)


def _step(tb: _Tables, cfg: HCConfig, st, fl, ef, work):
    """One HC step on active paths: st (A, 4, 30) = x re/im, xl re/im."""
    t = fl[:, _F_T]
    fl = fl.clone()
    fl[:, _F_EZ] = torch.maximum(
        fl[:, _F_EZ], ((1.0 - t).abs() <= cfg.end_zone_factor).float())
    if cfg.truncate_paths:
        bad = (st[:, 0, tb.depth].min(dim=1).values <= 0.0).float()
        watch = (fl[:, _F_CK] > 0.5) & (t > 0.0)
        fl[:, _F_CK] = torch.where(watch, bad, fl[:, _F_CK])
        prune = (t > 0.95) & (fl[:, _F_CK] > 0.5)
        fl[:, _F_PRN] = torch.where(prune, torch.ones_like(t), fl[:, _F_PRN])
        if bool(prune.any()):
            st = st.clone()
            go = (~prune).nonzero()[:, 0]
            st[go], fl[go] = _advance(tb, cfg, st[go], fl[go], ef[go], work)
            return st, fl
    return _advance(tb, cfg, st, fl, ef, work)


def _advance(tb: _Tables, cfg: HCConfig, st, fl, ef, work):
    """RK4 predictor + Newton corrector + step-size policy."""
    t, dt, succ = fl[:, _F_T], fl[:, _F_DT], fl[:, _F_SC]
    dtc = torch.where(fl[:, _F_EZ] > 0.5,
                      torch.minimum(dt, (1.0 - t).abs()),
                      torch.minimum(dt, (0.95 - t).abs()))
    half = 0.5 * dtc
    tb_ = t + half
    tc = tb_ + half
    efg = ef.unbind(1)
    x = (st[:, 0], st[:, 1])

    def stage(a, k, P, R):
        """Solve at x + a * k (k None: at x)."""
        xv = x if k is None else (x[0] + a * k[0], x[1] + a * k[1])
        return solve_plain(tb, _assemble(tb, xv, P, R, want_h=False))

    P, R = _fill(efg, t, rk=True)
    k1 = stage(None, None, P, R)
    P, R = _fill(efg, tb_, rk=True)
    k2 = stage(half[:, None], k1, P, R)
    k3 = stage(half[:, None], k2, P, R)
    P, R = _fill(efg, tc, rk=True)
    k4 = stage(dtc[:, None], k3, P, R)
    # A tensor divisor: PyTorch on CUDA multiplies by the reciprocal of a
    # scalar one, which is not the kernel's (correctly rounded) division.
    sixth = (dtc / torch.full_like(dtc, 6.0))[:, None]
    cur = torch.stack([
        x[j] + sixth * (k1[j] + 2.0 * (k2[j] + k3[j]) + k4[j])
        for j in range(2)], dim=1)                         # (A, 2, 30)

    # Newton corrector at frozen t_c; a path stops at its first success
    # or divergence.
    P, _ = _fill(efg, tc, rk=False)
    A = t.shape[0]
    ok = torch.zeros(A, dtype=torch.bool, device=t.device)
    inf = torch.zeros_like(ok)
    live = torch.arange(A, device=t.device)
    if work is not None:
        work["steps"] = work.get("steps", 0) + A
    for _ in range(cfg.max_correction_steps):
        if work is not None:
            work["newton"] = work.get("newton", 0) + live.numel()
        cw = cur[live]
        Pl = (P[0][live], P[1][live])
        dr, di = solve_plain(
            tb, _assemble(tb, (cw[:, 0], cw[:, 1]), Pl, Pl, want_h=True))
        nr = torch.stack([cw[:, 0] - dr, cw[:, 1] - di], dim=1)
        sq_dx = _lane_sum(_pad_lanes(dr * dr + di * di))
        sq_x = _lane_sum(_pad_lanes(nr[:, 0] * nr[:, 0] + nr[:, 1] * nr[:, 1]))
        s_i = sq_dx < cfg.corrector_tol_sq * sq_x
        i_i = sq_x > cfg.infinity_norm_sq
        cur[live] = nr
        ok[live], inf[live] = s_i, i_i
        live = live[~(s_i | i_i)]
        if live.numel() == 0:
            break

    good = ~inf & ok
    fail = ~inf & ~ok
    take = good | inf
    xs, xls = st[:, 0:2], st[:, 2:4]
    x_new = torch.where(take[:, None, None], cur,
                        torch.where(fail[:, None, None], xls, xs))
    xl_new = torch.where(good[:, None, None], cur, xls)
    fl = fl.clone()
    fl[:, _F_T] = torch.where(take, tc, t)
    succ2 = torch.where(good, succ + 1.0,
                        torch.where(fail, torch.zeros_like(succ), succ))
    bump = good & (succ2 >= cfg.steps_to_increase_delta_t)
    fl[:, _F_DT] = torch.where(fail, dtc * 0.5,
                               torch.where(bump, dtc * 2.0, dtc))
    fl[:, _F_SC] = torch.where(bump, torch.zeros_like(succ2), succ2)
    fl[:, _F_INF] = torch.where(inf, torch.ones_like(t), fl[:, _F_INF])
    fl[:, _F_NST] = fl[:, _F_NST] + 1.0
    return torch.cat([x_new, xl_new], dim=1), fl


# ---------------------------------------------------------------------------
# The wrapper.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrackResult:
    x: torch.Tensor          # (B, V) complex64, original variable order
    converged: torch.Tensor  # (B,) bool
    inf_fail: torch.Tensor   # (B,) bool
    pruned: torch.Tensor     # (B,) bool
    num_steps: torch.Tensor  # (B,) int32


def make_track_fn(problem: TrifocalProblem, cfg: HCConfig):
    """Build ``track(x0 (B, V), target_params (B, P+1)) -> TrackResult``.

    The whole budget (max_steps + 1 steps) runs in one call: one CUDA
    kernel launch for tensors on the card, ``track_plain`` for CPU
    tensors.  Start parameters are the problem's."""
    return _make_tracker(problem, cfg, plain=False)


def make_plain_track_fn(problem: TrifocalProblem, cfg: HCConfig):
    """The same tracker running ``track_plain`` on any device: the
    kernel's reference on the card.  Its ``track`` takes ``work``, a dict
    in which ``track_plain`` counts the path-steps and corrector
    iterations."""
    return _make_tracker(problem, cfg, plain=True)


def device_constants(c: FusedConstants, plain: bool = False):
    """``on(device) -> (perm, inverse perm, aux)``, built once per device:
    aux is the kernel plan on a CUDA device (unless ``plain``), else the
    ``_Tables`` of ``track_plain``.  The inverse permutation is also
    ``pos_of_var``, each variable's position."""
    cache: dict = {}

    def on(device):
        key = str(device)
        if key not in cache:
            kernel = device.type == "cuda" and not plain
            cache[key] = (
                torch.as_tensor(c.perm, dtype=torch.long, device=device),
                torch.as_tensor(np.argsort(c.perm), dtype=torch.long,
                                device=device),
                torch.as_tensor(c.kernel_plan(), device=device) if kernel
                else _Tables(c, device),
            )
        return cache[key]

    return on


def _make_tracker(problem: TrifocalProblem, cfg: HCConfig, plain: bool):
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
    )

    c = FusedConstants.build(problem, solver=cfg.solver)
    on = device_constants(c, plain)

    def track(x0: torch.Tensor, target_params: torch.Tensor,
              work: Optional[dict] = None) -> TrackResult:
        if x0.device != target_params.device:
            raise ValueError("x0 and target_params must share a device")
        perm, inv, aux = on(x0.device)
        efg = build_pair_coefs(problem, target_params)
        x = x0[:, perm].contiguous()
        fl = init_flags(cfg, x.shape[0], x.device)
        if isinstance(aux, _Tables):
            if x.device.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {x.device}")
            x, _, fl = track_plain(c, cfg, x, x, fl, efg, tables=aux,
                                   work=work)
        elif work is not None:
            raise ValueError("work is counted by track_plain only")
        else:
            _kernels.hc_track(x, x.clone(), fl, efg, aux, cfg.max_steps + 1,
                              cfg)
        conv, inf, pruned, steps = flags_outputs(cfg, fl)
        return TrackResult(x=x[:, inv], converged=conv, inf_fail=inf,
                           pruned=pruned, num_steps=steps)

    track.constants = c
    return track
