# Frozen copy of trifocal_pose_estimation_using_improved_gpuhc_torch/ops/fused.py at commit e13ae2fbc8b3,
# the benchmark's plain reference: imports rewritten to hcbench.plain;
# the kernel-launching wrappers at its end (make_track_fn, make_plain_track_fn, handoff_pad, _make_tracker) left out,
# and trimmed to the path the benchmark's configurations run (RK4, solver "reduced", the FP32 evaluation in the
# "efg" basis, no kept elimination replayed).  Left out: the "schedule" solve program (_schedule_program,
# solver_of), predictors "rk3" and "rk2", rk_jacobian_reuse, corrector_jacobian_reuse, predictor_handoff
# (handoff_valid, handoff_refactor, _refactor, _per_tile), resolve_plain and the replay fields of Factor,
# eval_precision "split3_rk2" (_bf16, _r2, _assemble's split2), pair_coef_basis "abc" and build_pair_coefs'
# per-path start parameters.  check_variant refuses each of them.  Never edit it to follow the program.
"""The HC path tracker: host constants and the plain PyTorch twin of the
CUDA kernel.

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
* ``csrc/hc_track.cu`` in the program is the same loop as one warp per
  path; ``kernel_plan`` packs its tables (read here for their size only).

Everything runs in the permuted space of the solve: variable ``perm[i]``
sits at position ``i``, equation ``row_order[r]`` at row ``r``.  The
augmented system is (30, 32): 30 position columns, the right-hand side at
column 30, one zero pad column.

The solve is a program of pivot steps on the whole matrix, built on the
host from the condensed elimination of ``reduce.py`` (``HCConfig.solver``
"reduced").  Family groups of one level run as one stage; the rows a
level's groups leave behind (in ascending slot order) are looked up
through a per-path row map, which is all that the reference's compaction
does.

Each step picks, among its candidate rows not yet used as pivots, the
largest |Re|+|Im| entry of its column (first hit in candidate order, a NaN
winning as in ``torch.argmax``), scales by conj(pivot)/|pivot|^2 with a
zero pivot's |pivot|^2 replaced by 1, and eliminates the column from the
other live candidates.  Back-substitution walks the steps in reverse using
the pivot rows, which no later step modifies.

The evaluation is the FP32 one, which the JAX package's eval_precision
"split3k", "split3" and "highest" and its eval_structure "classic",
"gathered" and "merged" all compute; the pair products are in the
two-point basis "efg".
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hcbench.plain.trifocal import (
    TrifocalProblem,
)
from hcbench.plain import reduce as redu
from hcbench.plain import schedule as sched
from hcbench.plain.config import (
    HCConfig,
    check_hc,
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
FSLOTS = 352     # multipliers a replaying kernel keeps per path (all steps)
MMAX = 288       # monomials the kernel's per-warp table holds


def m_offset(row: int, col: int) -> int:
    """Where entry (row, col) of the augmented system lies in the kernel's
    shared memory: rows of 32 complex, column col ^ row (an XOR swizzle
    that keeps a column's rows in distinct banks without padding)."""
    return int(row) * WIDTH + (int(col) ^ int(row))


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
    plan: redu.ReductionPlan  # the condensed plan
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
    def build(cls, problem: TrifocalProblem) -> "FusedConstants":
        """Constants of the "reduced" program; raises where the Jacobian
        pattern has no condensation (``reduce.build_reduction`` returns
        None), where the program would fall back to the schedule."""
        f = problem.factored
        n = problem.num_vars
        nnz = f.hx_C.shape[1]
        pattern = f.hx_scatter.reshape(n, n) != nnz
        plan = redu.build_reduction(pattern)
        if plan is None:
            raise ValueError("the Jacobian pattern has no condensation: the "
                             "schedule program is not in this copy")
        perm, row_order = _reduced_perm_rows(plan)
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

        stages, map0, maps = _solve_program(plan, pos_of_var, pos_of_row)

        pv = np.append(pos_of_var, n).astype(np.int32)  # homogeneous stays n
        return cls(
            perm=perm, pos_of_var=pos_of_var, row_order=row_order,
            pos_of_row=pos_of_row, nz_order=nz_order, nz_row=nz_row,
            nz_col=nz_col,
            depth_rows=tuple(int(pos_of_var[v]) for v in range(8)),
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

    def monomials(self) -> np.ndarray:
        """The evaluation's monomials in the kernel's table order, (M, 3)
        position indices (a, b, c), c = -1 for a quadratic one: the
        quadratic monomials x[qa] x[qb] (Hx terms' index m), then the cubic
        ones (x[ca] x[cb]) x[cc] (rhs terms' index len(qa) + m)."""
        quad = np.stack([self.qa, self.qb, np.full_like(self.qa, -1)], 1)
        cub = np.stack([self.ca, self.cb, self.cc], 1)
        return np.concatenate([quad, cub]).astype(np.int32)

    def entry_terms(self):
        """The evaluation's entries as term lists, in the order both
        implementations sum them: Hx nonzero j (nz_order), then the rhs of
        row r (entry NNZ + r); a term (coef, q, m) is coef * P[q] * x^m for
        an Hx nonzero, coef * R[q] * x^m for an rhs, m indexing
        ``monomials``."""
        nq = len(self.qa)
        hx = [[(self.hx_C[k, j], self.hx_q[k], self.hx_m[k])
               for k in np.nonzero(self.hx_C[:, j])[0]]
              for j in range(len(self.nz_row))]
        rhs = [[(self.ht_C[k, r], self.ht_q[k], nq + self.ht_m[k])
                for k in np.nonzero(self.ht_C[:, r])[0]]
               for r in range(self.n)]
        return hx + rhs

    def lane_plan(self, rhs_only: bool = False):
        """The evaluation's entries (``entry_terms``) dealt to the 32 lanes
        of a warp, as the kernel runs them: largest first (ties in entry
        order) onto the least-loaded lane (ties to the lowest lane), each
        keeping its terms in order.  With ``rhs_only`` (a replay's rhs)
        only the rhs entries.  Returns, per lane, its entries in the order
        it runs them."""
        sizes = [len(t) for t in self.entry_terms()]
        first = len(self.nz_row) if rhs_only else 0
        load = [0] * CMAX
        lanes: List[List[int]] = [[] for _ in range(CMAX)]
        for e in sorted(range(first, len(sizes)), key=lambda e: (-sizes[e], e)):
            lane = min(range(CMAX), key=lambda i: (load[i], i))
            lanes[lane].append(e)
            load[lane] += sizes[e]
        return lanes

    def _packed_terms(self, rhs_only: bool) -> np.ndarray:
        """The lane plan as one 32-bit word per term, lane i's k-th term
        at word 32 + 32 k + i after the 32 lanes' term counts (unused
        words 0): bits 0-8 the monomial (``monomials`` order), 9-14 the
        pair q, 15 set on an entry's last term, 16-25 the entry's offset in
        the kernel's swizzled system (``m_offset``), 26-31 the signed
        integer coefficient."""
        entries, nnz = self.entry_terms(), len(self.nz_row)
        words: List[List[int]] = [[] for _ in range(CMAX)]
        for lane, es in enumerate(self.lane_plan(rhs_only)):
            for e in es:
                off = (m_offset(self.nz_row[e], self.nz_col[e]) if e < nnz
                       else m_offset(e - nnz, self.n))
                for k, (co, q, m) in enumerate(entries[e]):
                    if co != round(co) or not -32 <= co < 32:
                        raise ValueError(f"coefficient {co} does not fit the "
                                         f"kernel's 6-bit field")
                    last = k == len(entries[e]) - 1
                    words[lane].append(
                        int(m) | int(q) << 9 | int(last) << 15
                        | int(off) << 16 | (int(co) & 63) << 26)
        out = np.zeros((1 + max(map(len, words)), CMAX), np.uint32)
        out[0] = [len(w) for w in words]
        for lane, w in enumerate(words):
            out[1:1 + len(w), lane] = w
        return out.reshape(-1).view(np.int32)

    def kernel_plan(self) -> np.ndarray:
        """Every table the CUDA kernel reads, packed into one int32 array
        behind a 16-int header: counts, the offsets of the parts (map0, the
        pivot steps, the row maps, the monomial table, the packed terms of
        a whole evaluation and of the rhs alone, the depth positions), the
        number of quadratic monomials and of monomials."""
        n = self.n
        if n != 30 or self.q > QMAX:
            raise ValueError(f"the kernel takes n=30 and Q<={QMAX}, got "
                             f"n={n}, Q={self.q}")
        mono = self.monomials()
        if len(mono) > MMAX:
            raise ValueError(f"{len(mono)} monomials, the kernel holds "
                             f"{MMAX}")
        steps = np.full((self.num_steps, STEP_INTS), -1, np.int32)
        for st in self.stages:
            for s, col, cand in zip(st.steps, st.cols, st.cands):
                if len(cand) > CMAX:
                    raise ValueError(f"step {s} has {len(cand)} candidates")
                steps[s, :3] = (st.level, col, len(cand))
                steps[s, 4:4 + len(cand)] = cand
        # Slot 3: where the step's multipliers start in the kernel's
        # per-path multiplier area (one slot per candidate, step order),
        # which the replaying variants keep.
        steps[:, 3] = np.cumsum(steps[:, 2]) - steps[:, 2]
        if steps[:, 2].sum() > FSLOTS:
            raise ValueError(f"{steps[:, 2].sum()} multiplier slots, the "
                             f"kernel keeps {FSLOTS}")
        maps = np.full((len(self.maps), 32, 4), -1, np.int32)
        for lv, m in enumerate(self.maps):
            maps[lv, :len(m)] = m
        # One word per monomial: its position indices a | b << 5 | c << 10
        # (c = 31 for a quadratic one).
        c = np.where(mono[:, 2] < 0, 31, mono[:, 2])
        mono_words = (mono[:, 0] | mono[:, 1] << 5 | c << 10).astype(np.int32)
        parts = [self.map0.astype(np.int32), steps.reshape(-1),
                 maps.reshape(-1), mono_words, self._packed_terms(False),
                 self._packed_terms(True),
                 np.array(self.depth_rows, np.int32)]
        header = np.zeros(16, np.int32)
        header[:4] = (n, self.q, self.num_steps, len(self.maps))
        off = 16
        for i, p in enumerate(parts):
            header[4 + i] = off
            off += p.size
        header[11:13] = (len(self.qa), len(mono))
        return np.concatenate([header] + parts).astype(np.int32)

    def term_lists(self):
        """The evaluation as term lists with the monomials' positions, in
        the order both implementations sum them: per Hx nonzero (in
        nz_order) its (coef, q, a, b) terms, coef * P[q] * x[a] * x[b]; per
        row its rhs (coef, q, a, b, c) terms, coef * R[q] * x[a] * x[b] *
        x[c]."""
        mono, nnz = self.monomials(), len(self.nz_row)
        entries = self.entry_terms()
        return ([[(co, q, *mono[m, :2]) for co, q, m in t]
                 for t in entries[:nnz]],
                [[(co, q, *mono[m]) for co, q, m in t]
                 for t in entries[nnz:]])


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


# ---------------------------------------------------------------------------
# Per-path coefficients and flags.
# ---------------------------------------------------------------------------


def build_pair_coefs(problem: TrifocalProblem, target_params: torch.Tensor
                     ) -> torch.Tensor:
    """Per-path pair-product coefficients, (B, P+1) complex64 target
    parameters -> (B, 3, Q) complex64, in the two-point basis "efg":
    P_q(t) = t^2 E + t(1-t) F + (1-t)^2 G with E = tgt_a tgt_b,
    F = tgt_a s_b + s_a tgt_b, G = s_a s_b (s = the problem's start
    parameters): exact at t = 1."""
    f = problem.factored
    dev = target_params.device
    a = torch.as_tensor(f.pp_a, dtype=torch.long, device=dev)
    b = torch.as_tensor(f.pp_b, dtype=torch.long, device=dev)
    sp = torch.as_tensor(problem.start_params, device=dev)
    sa, sb = sp[a], sp[b]
    g = torch.complex(sa.real * sb.real - sa.imag * sb.imag,
                      sa.real * sb.imag + sa.imag * sb.real)
    ta, tb = target_params[:, a], target_params[:, b]
    e_re = ta.real * tb.real - ta.imag * tb.imag
    e_im = ta.real * tb.imag + ta.imag * tb.real
    f_re = ta.real * sb.real - ta.imag * sb.imag + sa.real * tb.real \
        - sa.imag * tb.imag
    f_im = ta.real * sb.imag + ta.imag * sb.real + sa.real * tb.imag \
        + sa.imag * tb.real
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
    efg: six (A, Q) planes (re/im of E, F, G, see ``build_pair_coefs``),
    t (A,) -> P, R as (re, im)."""
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

    def fold(coef, vr, vi, valid):
        vr = torch.where(valid, coef * vr, 0.0)
        vi = torch.where(valid, coef * vi, 0.0)
        acc_r = acc_i = torch.zeros_like(vr[..., 0])
        for k in range(vr.shape[-1]):
            acc_r, acc_i = acc_r + vr[..., k], acc_i + vi[..., k]
        return acc_r, acc_i

    def sum_terms(coef, q, mono, valid, Z):
        return fold(coef, *_cmul(Z[0][:, q], Z[1][:, q], *mono), valid)

    x2 = _cmul(er[:, tb.rhs_a], ei[:, tb.rhs_a], er[:, tb.rhs_b],
               ei[:, tb.rhs_b])
    rhs = sum_terms(tb.rhs_coef, tb.rhs_q,
                    _cmul(*x2, er[:, tb.rhs_c], ei[:, tb.rhs_c]),
                    tb.rhs_valid, R)
    hx = sum_terms(tb.hx_coef, tb.hx_q,
                   _cmul(er[:, tb.hx_a], ei[:, tb.hx_a],
                         er[:, tb.hx_b], ei[:, tb.hx_b]),
                   tb.hx_valid, P)
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


class Factor(NamedTuple):
    """What back-substitution needs of one elimination, batch-first: the
    eliminated systems (their pivot rows are what back-substitution reads)
    and each step's pivot row."""

    mr: torch.Tensor     # (A, 30, 32)
    mi: torch.Tensor
    piv: torch.Tensor    # (A, steps) long


def factor_plain(tb: _Tables, m) -> Factor:
    """Restricted-pivoting forward elimination of the augmented systems
    m = (re, im), each (A, 30, 32), in place, by the constants' pivot
    program; returns what back-substitution needs."""
    mr, mi = m
    A, n = mr.shape[0], tb.c.n
    dev = mr.device
    ar = torch.arange(A, device=dev)
    a3 = ar[:, None, None]
    used = torch.zeros((A, n), dtype=torch.bool, device=dev)
    rmap, level = tb.map0.expand(A, n), 0
    S = tb.c.num_steps
    piv = torch.full((A, S), -1, dtype=torch.long, device=dev)
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
        fr = vr * ir - vi * ii
        fi = vr * ii + vi * ir
        live = ~was & (rows != p[..., None])
        fr, fi, live = fr[..., None], fi[..., None], live[..., None]
        prr = mr[ar[:, None], p][:, :, None, :]            # (A, S, 1, W)
        pri = mi[ar[:, None], p][:, :, None, :]
        old_r, old_i = mr[a3, rows], mi[a3, rows]          # (A, S, C, W)
        mr[a3, rows] = torch.where(live, old_r - (fr * prr - fi * pri), old_r)
        mi[a3, rows] = torch.where(live, old_i - (fr * pri + fi * prr), old_i)
        used[ar[:, None], p] = True
    return Factor(mr, mi, piv)


def backsub_plain(tb: _Tables, mr, mi, piv):
    """Back-substitution over the pivot rows, one step at a time from the
    last, as the kernel; returns x (re, im), each (A, 30) in position
    order."""
    A, n = mr.shape[0], tb.c.n
    ar = torch.arange(A, device=mr.device)
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
    return xsr[:, :n], xsi[:, :n]


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


def check_variant(cfg: HCConfig) -> None:
    """Raise ValueError for a variant this copy does not run (see the
    header): ``check_hc`` with the tracker's knobs narrowed to the
    benchmark's configurations."""
    check_hc(cfg)


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
    that ran the predictor), ``newton`` (path corrector iterations) and
    ``solves`` (full assemble + eliminate + back-substitute), added to its
    entries; all are known on the host at no cost."""
    tb = tables or _Tables(consts, x.device)
    check_variant(cfg)
    niter = cfg.max_steps + 1 if niter is None else niter
    st = torch.stack([*_planes(x), *_planes(xl)], dim=1)   # (B, 4, 30)
    ef = efg_planes(efg)
    flags = flags.clone()
    for _ in range(niter):
        idx = _active(cfg, flags).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        st[idx], flags[idx] = _step(tb, cfg, st[idx], flags[idx], ef[idx],
                                    work)
    return (torch.complex(st[:, 0], st[:, 1]),
            torch.complex(st[:, 2], st[:, 3]), flags)


def _active(cfg: HCConfig, flags: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the paths that take the next step."""
    t = flags[:, _F_T]
    conv = (t >= 1.0) | (1.0 - t <= cfg.t_converged_eps)
    return ~conv & (flags[:, _F_INF] < 0.5) & (flags[:, _F_PRN] < 0.5)


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
            if go.numel() == 0:
                return st, fl
            st[go], fl[go] = _advance(tb, cfg, st[go], fl[go], ef[go], work)
            return st, fl
    return _advance(tb, cfg, st, fl, ef, work)


def _sub(pair, idx):
    return pair[0][idx], pair[1][idx]


def _advance(tb: _Tables, cfg: HCConfig, st, fl, ef, work):
    """RK4 predictor + Newton corrector + step-size policy; returns
    (st, fl)."""
    t, dt, succ = fl[:, _F_T], fl[:, _F_DT], fl[:, _F_SC]
    dtc = torch.where(fl[:, _F_EZ] > 0.5,
                      torch.minimum(dt, (1.0 - t).abs()),
                      torch.minimum(dt, (0.95 - t).abs()))
    half = 0.5 * dtc
    tb_ = t + half
    tc = tb_ + half
    efg = ef.unbind(1)
    x = (st[:, 0], st[:, 1])
    A = t.shape[0]

    def count(key, k):
        if work is not None:
            work[key] = work.get(key, 0) + k

    def full(xv, P, R, want_h=False):
        count("solves", xv[0].shape[0])
        f = factor_plain(tb, _assemble(tb, xv, P, R, want_h))
        return backsub_plain(tb, f.mr, f.mi, f.piv)

    def fill(tv, rk=True):
        return _fill(efg, tv, rk=rk)

    P, R = fill(t)
    k1 = full(x, P, R)

    def axpy(a, k):
        return x[0] + a * k[0], x[1] + a * k[1]

    P, R = fill(tb_)
    k2 = full(axpy(half[:, None], k1), P, R)
    d = dtc[:, None]
    # A tensor divisor: PyTorch on CUDA multiplies by the reciprocal of a
    # scalar one, which is not the kernel's (correctly rounded) division.
    sixth = (dtc / torch.full_like(dtc, 6.0))[:, None]
    k3 = full(axpy(half[:, None], k2), P, R)
    P, R = fill(tc)
    k4 = full(axpy(d, k3), P, R)
    cur = torch.stack([
        x[j] + sixth * (k1[j] + 2.0 * (k2[j] + k3[j]) + k4[j])
        for j in range(2)], dim=1)

    # Newton corrector at frozen t_c; a path stops at its first success
    # or divergence.
    P, _ = fill(tc, rk=False)
    ok = torch.zeros(A, dtype=torch.bool, device=t.device)
    inf = torch.zeros_like(ok)
    live = torch.arange(A, device=t.device)
    count("steps", A)
    for it in range(cfg.max_correction_steps):
        count("newton", live.numel())
        cw = cur[live]
        xw, Pl = (cw[:, 0], cw[:, 1]), _sub(P, live)
        dr, di = full(xw, Pl, Pl, want_h=True)
        nr = torch.stack([cw[:, 0] - dr, cw[:, 1] - di], dim=1)
        sq_dx = _lane_sum(_pad_lanes(dr * dr + di * di))
        sq_x = _lane_sum(_pad_lanes(nr[:, 0] * nr[:, 0] + nr[:, 1] * nr[:, 1]))
        s_i = sq_dx < cfg.corrector_tol_sq * sq_x
        i_i = sq_x > cfg.infinity_norm_sq
        cur[live] = nr
        ok[live], inf[live] = s_i, i_i
        going = ~(s_i | i_i)
        live = live[going]
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


def device_constants(c: FusedConstants):
    """``on(device) -> (perm, inverse perm, tables)``, built once per
    device: the ``_Tables`` of ``track_plain``.  The inverse permutation is
    also ``pos_of_var``, each variable's position."""
    cache: dict = {}

    def on(device):
        key = str(device)
        if key not in cache:
            cache[key] = (
                torch.as_tensor(c.perm, dtype=torch.long, device=device),
                torch.as_tensor(np.argsort(c.perm), dtype=torch.long,
                                device=device),
                _Tables(c, device),
            )
        return cache[key]

    return on
