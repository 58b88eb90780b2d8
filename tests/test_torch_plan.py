"""The CUDA tracker's evaluation plan (``FusedConstants.kernel_plan``) on
the CPU, for both solve programs.

The kernel forms each monomial once per evaluation into a table, then each
lane walks its part of a packed plan: the 200 entries (170 Hx nonzeros, 30
rhs rows) dealt to the 32 lanes largest first, one 32-bit word per term.
Here the packed words decode to ``term_lists()`` exactly; the critical
lane's load is pinned; and a numpy walk of the plan as the kernel walks it
(monomial table, then per-lane terms, every product and sum rounded once in
float32) equals ``fused._assemble`` bit for bit, in FP32, under the 2-term
split of "split3_rk2" and in the "abc" basis, for a whole evaluation and
for a replay's rhs.  The pivot program's part of the plan is pinned to the
one the kernel read before the evaluation was repacked.
"""

import hashlib
import math
import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused, ransac
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
SOLVERS = ["reduced", "schedule"]
_A = 48  # evaluation points


@pytest.fixture(scope="module")
def problem():
    return trifocal.TrifocalProblem.load(config.EngineConfig(data_root=DATA))


@pytest.fixture(scope="module", params=SOLVERS)
def consts(request, problem):
    return fused.FusedConstants.build(problem, solver=request.param)


def _part(plan, slot):
    """Part ``slot`` of the plan as uint32: its 32 lane counts and its
    (depth, 32) words."""
    nxt = plan[slot + 1] if slot < 10 else plan.size
    part = plan[plan[slot]:nxt].view(np.uint32)
    return part[:32], part[32:].reshape(-1, 32)


def _decode(c, rhs_only):
    """Per lane, its terms as the kernel reads them: (coef, q, monomial,
    last, row, col)."""
    counts, words = _part(c.kernel_plan(), 9 if rhs_only else 8)
    lanes = []
    for lane in range(32):
        terms = []
        for w in words[:counts[lane], lane].tolist():
            off = (w >> 16) & 1023
            row = off // 32
            coef = ((w >> 26) & 63) - (64 if w >> 31 else 0)
            terms.append((coef, (w >> 9) & 63, w & 511, bool(w & 1 << 15),
                          row, (off % 32) ^ row))
        lanes.append(terms)
        assert not words[counts[lane]:, lane].any()
    return lanes


def _expected(c, rhs_only):
    """Per entry (row, col): its (coef, q, monomial) terms from
    term_lists(), in order."""
    nz_terms, rhs_terms = c.term_lists()
    nq = len(c.qa)
    mono = {tuple(m): i for i, m in enumerate(c.monomials().tolist())}
    out = {}
    if not rhs_only:
        for j, terms in enumerate(nz_terms):
            out[(int(c.nz_row[j]), int(c.nz_col[j]))] = [
                (int(co), int(q), mono[(int(a), int(b), -1)])
                for co, q, a, b in terms]
    for r, terms in enumerate(rhs_terms):
        out[(r, c.n)] = [(int(co), int(q), mono[(int(a), int(b), int(cc))])
                         for co, q, a, b, cc in terms]
        assert all(mono[(int(a), int(b), int(cc))] >= nq
                   for _, _, a, b, cc in terms)
    return out


@pytest.mark.parametrize("rhs_only", [False, True])
def test_packed_plan_decodes_to_the_term_lists(consts, rhs_only):
    """Every term once, each entry's terms in term-list order and
    contiguous on one lane, its last term marked and carrying the entry's
    place in the swizzled system."""
    c = consts
    want = _expected(c, rhs_only)
    got = {}
    for terms in _decode(c, rhs_only):
        entry = []
        for coef, q, m, last, row, col in terms:
            entry.append((coef, q, m))
            if last:
                assert (row, col) not in got, (row, col)
                got[(row, col)] = entry
                entry = []
        assert entry == []
    assert got == want


def test_monomial_table(consts):
    """The table's words name the monomials of term_lists(): the quadratic
    ones (qa, qb), then the cubic ones (ca, cb, cc); position 31 marks a
    quadratic one (the homogeneous 1 is position 30)."""
    c = consts
    plan = c.kernel_plan()
    words = plan[plan[7]:plan[8]]
    assert len(words) == plan[12] == len(c.qa) + len(c.ca) <= fused.MMAX
    assert plan[11] == len(c.qa)
    dec = np.stack([words & 31, words >> 5 & 31, words >> 10 & 31], 1)
    want = c.monomials()
    want[want[:, 2] < 0, 2] = 31
    assert np.array_equal(dec, want)


@pytest.mark.parametrize("rhs_only", [False, True])
def test_lane_loads(consts, rhs_only):
    """Largest-first onto the least-loaded lane: the critical lane carries
    at most ceil(total / 32) plus the largest entry, 48 terms of a whole
    evaluation on the committed problem (the mean is 45.4; one row per
    lane ran 59), and each lane's count is its words'."""
    c = consts
    nz_terms, rhs_terms = c.term_lists()
    sizes = ([] if rhs_only else [len(t) for t in nz_terms]) + \
        [len(t) for t in rhs_terms]
    lanes = c.lane_plan(rhs_only)
    first = len(nz_terms) if rhs_only else 0
    assert sorted(e for es in lanes for e in es) == \
        list(range(first, first + len(sizes)))
    loads = [sum(sizes[e - first] for e in es) for es in lanes]
    assert max(loads) <= math.ceil(sum(sizes) / 32) + max(sizes)
    assert max(loads) == (22 if rhs_only else 48)
    counts, _ = _part(c.kernel_plan(), 9 if rhs_only else 8)
    assert counts.tolist() == loads


# The pivot program's part of the plan (map0, steps, row maps), as the
# kernel read it before the evaluation was repacked: (ints, sha256 prefix).
_PIVOT_PART = {"reduced": (1366, "d31ee46dd1eb3f88"),
               "schedule": (1110, "a4d476cbe9fc55e2")}


def test_pivot_program_is_unchanged(consts):
    plan = consts.kernel_plan()
    part = plan[plan[4]:plan[7]]
    assert (part.size, hashlib.sha256(part.tobytes()).hexdigest()[:16]) == \
        _PIVOT_PART[consts.solver]


# --- the numpy walk -------------------------------------------------------


def _bf16(v):
    """float32 -> bfloat16 (to nearest, ties to even) -> float32, finite v."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + (u >> 16 & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _r2(v):
    h = _bf16(v)
    return h + _bf16(v - h)


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _walk(c, x, P, R, want_h, rhs_only, split2):
    """The kernel's evaluation in numpy float32 over A points: x (re, im)
    (A, 30), P, R (re, im) (A, Q).  Returns the system (re, im) (A, 30, 32)
    in row/column order, or with rhs_only the rhs (re, im) (A, 30)."""
    plan = c.kernel_plan()
    A = x[0].shape[0]
    f32 = np.float32
    v = [np.zeros((A, 32), f32), np.zeros((A, 32), f32)]
    for j in range(2):
        v[j][:, :30] = _r2(x[j]) if split2 else x[j]
    v[0][:, 30] = 1.0
    nq, n_mono = plan[11], plan[12]
    defs = plan[plan[7]:plan[7] + n_mono]
    mono = [np.zeros((A, n_mono), f32), np.zeros((A, n_mono), f32)]
    for i in range(nq if rhs_only else 0, n_mono):
        d = int(defs[i])
        a, b, cc = d & 31, d >> 5 & 31, d >> 10 & 31
        m = _cmul((v[0][:, a], v[1][:, a]), (v[0][:, b], v[1][:, b]))
        if cc != 31:
            m = _cmul(m, (v[0][:, cc], v[1][:, cc]))
        for j in range(2):
            mono[j][:, i] = _r2(m[j]) if split2 else m[j]
    m_out = [np.zeros((A, 30 * 32), f32), np.zeros((A, 30 * 32), f32)]
    counts, words = _part(plan, 9 if rhs_only else 8)
    for lane in range(32):
        acc = [np.zeros(A, f32), np.zeros(A, f32)]
        lo = [np.zeros(A, f32), np.zeros(A, f32)]
        for w in words[:counts[lane], lane].tolist():
            mi, q = w & 511, w >> 9 & 63
            coef = f32(((w >> 26) & 63) - (64 if w >> 31 else 0))
            pq = R if mi >= nq else P
            val = _cmul((pq[0][:, q], pq[1][:, q]),
                        (mono[0][:, mi], mono[1][:, mi]))
            for j in range(2):
                if split2:
                    h = _bf16(val[j])
                    acc[j] = acc[j] + coef * h
                    lo[j] = lo[j] + coef * _bf16(val[j] - h)
                else:
                    acc[j] = acc[j] + coef * val[j]
            if w & 1 << 15:
                for j in range(2):
                    s = acc[j] + lo[j] if split2 else acc[j]
                    m_out[j][:, (w >> 16) & 1023] = \
                        -s if mi >= nq and not want_h else s
                acc = [np.zeros(A, f32), np.zeros(A, f32)]
                lo = [np.zeros(A, f32), np.zeros(A, f32)]
    # Undo the swizzle: entry (r, col) at r * 32 + (col ^ r).
    rows = np.arange(30)[:, None]
    idx = rows * 32 + (np.arange(32)[None, :] ^ rows)
    out = [mo[:, idx] for mo in m_out]
    return tuple(o[:, :, 30] for o in out) if rhs_only else tuple(out)


@pytest.fixture(scope="module")
def points(problem):
    """Seeded evaluation points near the start roots, and the pair
    coefficients of view 0's first hypothesis in both bases."""
    rng = np.random.default_rng(7)
    roots = np.asarray(problem.start_sols)[rng.integers(0, problem.num_tracks,
                                                        _A)]
    x = roots + 0.05 * (rng.standard_normal(roots.shape)
                        + 1j * rng.standard_normal(roots.shape))
    view = data_io.load_ransac_view(config.ransac_data_dir(
        config.EngineConfig(data_root=DATA)), 0)
    s = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1)
    tgt = torch.as_tensor(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s)).repeat(_A, 1)
    t = torch.as_tensor(rng.uniform(0.0, 1.0, _A), dtype=torch.float32)
    efg = {b: fused.efg_planes(fused.build_pair_coefs(problem, tgt, b))
           for b in ("efg", "abc")}
    return torch.as_tensor(x.astype(np.complex64)), t, efg


@pytest.mark.parametrize("variant", ["fp32", "split2", "abc"])
@pytest.mark.parametrize("want_h", [False, True])
def test_numpy_walk_equals_assemble(consts, points, variant, want_h):
    """The plan walked as the kernel walks it gives fused._assemble's
    system bit for bit (and, rhs alone, its rhs)."""
    c = consts
    x, t, efg = points
    split2 = variant == "split2" and not want_h  # the corrector stays FP32
    basis = "abc" if variant == "abc" else "efg"
    tb = fused._Tables(c, "cpu")
    xc = x[:, torch.as_tensor(c.perm, dtype=torch.long)]
    xp = (xc.real.contiguous(), xc.imag.contiguous())
    P, R = fused._fill(efg[basis].unbind(1), t, rk=not want_h, basis=basis)
    ref = fused._assemble(tb, xp, P, R, want_h, split2=split2)
    ref_rhs = fused._assemble(tb, xp, P, R, want_h, rhs_only=True,
                              split2=split2)

    def np2(pair):
        return tuple(a.numpy() for a in pair)

    got = _walk(c, np2(xp), np2(P), np2(R), want_h, False, split2)
    got_rhs = _walk(c, np2(xp), np2(P), np2(R), want_h, True, split2)
    for g, r in zip(got + got_rhs, ref + ref_rhs):
        r = r.numpy()
        assert np.isfinite(r).all()
        assert np.array_equal(g.view(np.int32), r.view(np.int32))
