#!/usr/bin/env python
"""Generate the trifocal 2op1p problem tables, a start system and synthetic
RANSAC views, in the reference data-root layout.

    python tools/make_synth_data.py [--out data/synth_trifocal] [--views 3]
    python tools/make_synth_data.py --p2c-only data/synth_trifocal

Writes, under ``--out``:

  problems/trifocal_2op1p_30x30/
      dHdx_indx.txt, dHdt_indx.txt   index tables (README "Adding a new
                                     minimal problem" encoding)
      dHdx_indx_P2C.txt, dHdt_indx_P2C.txt
                                     the same system over coefficients
                                     (``p2c_tables_from_ph``; ``--p2c-only``
                                     writes just these two from the
                                     committed PH tables)
      start_params.txt, start_sols.txt
      problem.json                   the table dimensions both packages read
  RANSAC_Data/trifocal_2op1p_30x30/Synthetic/
      Triplet_Edgels/Triplet_Edgels_%03d.txt, GT_Poses21/, GT_Poses31/,
      Intrinsic_Matrix.txt

The system (SURVEY.md D4) is derived symbolically with sympy.  Three points
are seen in three views; the first two carry tangents.  With the
unnormalised Cayley numerator M(r) and s = 1 + |r|^2 (so R = M / s), the
equations a_pv g_pv = R a_p1 g_p1 + T_v are multiplied through by s; the
unknowns keep their metric values:

  point p, view v:    s (a_pv g_pv - T_v) - M(r_v) a_p1 g_p1            = 0
  tangent p, view v:  s (u_pv g_pv + e_pv t_pv) - M(r_v)(u_p1 g_p1 +
                      e_p1 t_p1)                                        = 0

for v in {2, 3}.  g = (x, y, 1) are metric image points, t = (tx, ty, 0)
image tangents.  Gauge constants fix a_11, e_11 and e_21 (parameters 30-32,
the (1.0, 0.5, 1.0) of ``ops/ransac.build_target_params``).  This gives
22 H terms per equation and 175 cubic monomials (the reference's problem
has 16 and 115).  Letting the view-v unknowns absorb s instead drops to
16 terms, but that system has extraneous roots (1 + |r|^2 = 0): its
monodromy root count passes 312 and keeps growing.

Variables (``models/trifocal.py`` layout): x[0:8] depths (a12, a13, a21,
a22, a23, a31, a32, a33), x[8:18] (u11, u12, u13, e12, e13, u21, u22, u23,
e22, e23), x[18:21] T21, x[21:24] T31, x[24:27] Cayley r21, x[27:30]
Cayley r31.  Parameters: 0-17 the three points' (x, y) in views 1..3,
18-29 the first two points' tangents, 30-32 the gauge constants.

The start system: random complex gauge constants and a random complex x0
make the equations linear in the other 30 parameters, which are solved
for, so x0 is a root by construction.  Monodromy
(``models/monodromy.monodromy_solve`` on the CPU oracle tracker) grows the
root set until it stops growing; every root is then Newton-polished in
complex128.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NV, NP = 30, 33
PROBLEM = "trifocal_2op1p_30x30"

# Intrinsics of the synthcurves-style camera (focal length ~2585 px on a
# ~500 px image): the narrow field of view the reference's views have.
K_MAT = np.array([[2584.93250981950, 0.0, 249.771375872214],
                  [0.0, 2584.79186060577, 278.312679379194],
                  [0.0, 0.0, 1.0]])


# ---------------------------------------------------------------------------
# The symbolic system.
# ---------------------------------------------------------------------------


def _cayley_numerator(r):
    r1, r2, r3 = r
    return [
        [1 + r1 * r1 - r2 * r2 - r3 * r3, 2 * (r1 * r2 - r3), 2 * (r1 * r3 + r2)],
        [2 * (r1 * r2 + r3), 1 + r2 * r2 - r1 * r1 - r3 * r3, 2 * (r2 * r3 - r1)],
        [2 * (r1 * r3 - r2), 2 * (r2 * r3 + r1), 1 + r3 * r3 - r1 * r1 - r2 * r2],
    ]


def build_equations():
    """The 30 polynomial equations as sympy expressions in x0..x29, p0..p32."""
    import sympy as sp

    x = sp.symbols(f"x0:{NV}")
    p = sp.symbols(f"p0:{NP}")
    a11, e11, e21 = p[30], p[31], p[32]
    depth = {(1, 1): a11}
    for k, pv in enumerate([(1, 2), (1, 3), (2, 1), (2, 2), (2, 3),
                            (3, 1), (3, 2), (3, 3)]):
        depth[pv] = x[k]
    u = {(1, 1): x[8], (1, 2): x[9], (1, 3): x[10],
         (2, 1): x[13], (2, 2): x[14], (2, 3): x[15]}
    e = {(1, 1): e11, (1, 2): x[11], (1, 3): x[12],
         (2, 1): e21, (2, 2): x[16], (2, 3): x[17]}
    trans = {2: x[18:21], 3: x[21:24]}
    cay = {2: x[24:27], 3: x[27:30]}

    def g(pt, v):  # metric point (x, y, 1)
        b = 6 * (pt - 1) + 2 * (v - 1)
        return [p[b], p[b + 1], 1]

    def tg(pt, v):  # image tangent (tx, ty, 0)
        b = 18 + 6 * (pt - 1) + 2 * (v - 1)
        return [p[b], p[b + 1], 0]

    eqs = []
    for v in (2, 3):
        r = cay[v]
        s = 1 + r[0] ** 2 + r[1] ** 2 + r[2] ** 2
        m = _cayley_numerator(r)
        for pt in (1, 2, 3):
            g1, gv = g(pt, 1), g(pt, v)
            for i in range(3):
                rot = sum(m[i][j] * g1[j] for j in range(3)) * depth[(pt, 1)]
                eqs.append(s * (depth[(pt, v)] * gv[i] - trans[v][i]) - rot)
    for v in (2, 3):
        r = cay[v]
        s = 1 + r[0] ** 2 + r[1] ** 2 + r[2] ** 2
        m = _cayley_numerator(r)
        for pt in (1, 2):
            d1 = [u[(pt, 1)] * g(pt, 1)[j] + e[(pt, 1)] * tg(pt, 1)[j]
                  for j in range(3)]
            gv, tv = g(pt, v), tg(pt, v)
            for i in range(3):
                rot = sum(m[i][j] * d1[j] for j in range(3))
                eqs.append(s * (u[(pt, v)] * gv[i] + e[(pt, v)] * tv[i]) - rot)
    assert len(eqs) == NV
    return x, p, eqs


def _term_indices(exps):
    """Monomial exponent vector over (x..., p...) -> (vars, params) lists."""
    vs, ps = [], []
    for i, k in enumerate(exps):
        (vs if i < NV else ps).extend([i if i < NV else i - NV] * k)
    return vs, ps


def build_tables(x, p, eqs):
    """Equations -> (hx_table (NV, Tx, 5, NV), ht_table (Tt, 6, NV)) in
    the reference encoding: param index NP = constant 1, var index NV =
    homogeneous 1."""
    import sympy as sp

    gens = list(x) + list(p)
    ht_terms = [[] for _ in range(NV)]
    hx_terms = [[[] for _ in range(NV)] for _ in range(NV)]  # [v][e]
    for ei, eq in enumerate(eqs):
        for exps, c in sp.Poly(sp.expand(eq), *gens).terms():
            vs, ps = _term_indices(exps)
            assert len(vs) <= 3 and len(ps) <= 2, (ei, exps)
            ps = ps + [NP] * (2 - len(ps))
            vs = vs + [NV] * (3 - len(vs))
            ht_terms[ei].append((int(c), ps[0], ps[1], vs[0], vs[1], vs[2]))
        for v in range(NV):
            d = sp.diff(eq, x[v])
            if d == 0:
                continue
            for exps, c in sp.Poly(sp.expand(d), *gens).terms():
                vs, ps = _term_indices(exps)
                assert len(vs) <= 2 and len(ps) <= 2
                ps = ps + [NP] * (2 - len(ps))
                vs = vs + [NV] * (2 - len(vs))
                hx_terms[v][ei].append((int(c), ps[0], ps[1], vs[0], vs[1]))
    tt = max(len(t) for t in ht_terms)
    tx = max(len(hx_terms[v][e]) for v in range(NV) for e in range(NV))
    ht = np.zeros((tt, 6, NV), np.int64)
    for e_, terms in enumerate(ht_terms):
        for j, term in enumerate(terms):
            ht[j, :, e_] = term
    hx = np.zeros((NV, tx, 5, NV), np.int64)
    for v in range(NV):
        for e_ in range(NV):
            for j, term in enumerate(hx_terms[v][e_]):
                hx[v, j, :, e_] = term
    return hx, ht


# ---------------------------------------------------------------------------
# Numeric evaluation straight from the tables (complex128).
# ---------------------------------------------------------------------------


def eval_h(ht, x, p):
    """H(x, p): x (..., NV), p (..., NP) complex -> (..., NV)."""
    xp = np.concatenate([x, np.ones(x.shape[:-1] + (1,), x.dtype)], -1)
    pp = np.concatenate([p, np.ones(p.shape[:-1] + (1,), p.dtype)], -1)
    c = ht[:, 0, :]
    v = (pp[..., ht[:, 1, :]] * pp[..., ht[:, 2, :]] * xp[..., ht[:, 3, :]]
         * xp[..., ht[:, 4, :]] * xp[..., ht[:, 5, :]])
    return np.sum(c * v, axis=-2)


def eval_hx(hx, x, p):
    """Hx(x, p): (..., NV eqs, NV vars)."""
    xp = np.concatenate([x, np.ones(x.shape[:-1] + (1,), x.dtype)], -1)
    pp = np.concatenate([p, np.ones(p.shape[:-1] + (1,), p.dtype)], -1)
    c = hx[:, :, 0, :]
    v = (pp[..., hx[:, :, 1, :]] * pp[..., hx[:, :, 2, :]]
         * xp[..., hx[:, :, 3, :]] * xp[..., hx[:, :, 4, :]])
    out = np.sum(c * v, axis=-2)  # (..., v, e)
    return np.swapaxes(out, -1, -2)


def newton_polish(hx, ht, x, p, iters=20):
    for _ in range(iters):
        x = x - np.linalg.solve(eval_hx(hx, x, p), eval_h(ht, x, p)[..., None])[..., 0]
    return x


# ---------------------------------------------------------------------------
# Start system.
# ---------------------------------------------------------------------------


def linear_start_params(ht, x0, gauge):
    """Solve H(x0, p) = 0 for the 30 location/tangent params, gauge fixed.

    H is affine in those params once x0 and the gauge are fixed, so its
    coefficients come from evaluating at the zero vector and unit vectors."""
    free = 30
    base = np.zeros(NP, np.complex128)
    base[30:33] = gauge
    h0 = eval_h(ht, x0, base)
    a = np.zeros((NV, free), np.complex128)
    for k in range(free):
        pk = base.copy()
        pk[k] = 1.0
        a[:, k] = eval_h(ht, x0, pk) - h0
    sol = np.linalg.solve(a, -h0)
    p = base.copy()
    p[:free] = sol
    return p


def grow_roots(hx, ht, p0, x0, max_loops, patience, seed):
    """Monodromy on the JAX CPU oracle tracker, from one known root."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
        monodromy,
        trifocal,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import tracker
    from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (
        HCConfig,
    )

    sp = np.concatenate([p0, [1.0]]).astype(np.complex64)
    problem = trifocal.TrifocalProblem(
        num_vars=NV, num_params=NP, num_tracks=1,
        start_params=sp, start_sols=x0[None].astype(np.complex64),
        hx_table=hx.astype(np.int32), ht_table=ht.astype(np.int32),
        factored=trifocal._factor_tables(hx.astype(np.int32),
                                         ht.astype(np.int32)),
    )
    # Monodromy legs run between random complex parameter points: no depth
    # pruning, and a longer step budget than a RANSAC round's 80.
    hc = dataclasses.replace(HCConfig(), truncate_paths=False, max_steps=200,
                             backend="xla")
    track = tracker.make_track_fn(problem, hc, dynamic_start=True)
    sols = x0[None].astype(np.complex64)
    stagnant = 0
    # One loop per call, so progress shows; each loop's waypoints come
    # from its own seed.
    for loop in range(max_loops):
        res = monodromy.monodromy_solve(
            problem, hc, seed_sols=sols, target_count=10_000, max_loops=1,
            patience=1, rng_seed=seed * 1000 + loop, track_fn=track,
            leg_batch=64,
        )
        grew = res.solutions.shape[0] > sols.shape[0]
        sols = res.solutions
        stagnant = 0 if grew else stagnant + 1
        print(f"monodromy loop {loop}: {sols.shape[0]} roots", flush=True)
        if stagnant >= patience:
            break
    return sols.astype(np.complex128)


def dedup(sols, tol=1e-6):
    out = []
    for s in sols:
        if all(np.max(np.abs(s - o)) > tol * max(1.0, np.abs(s).max())
               for o in out):
            out.append(s)
    return np.array(out)


# ---------------------------------------------------------------------------
# Synthetic views.
# ---------------------------------------------------------------------------


def _rotation(axis, angle):
    axis = axis / np.linalg.norm(axis)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def make_view(rng, n_edgels, depth=1000.0):
    """One random scene: camera 1 = world frame, cameras 2 and 3 rotated
    about the object centre; n_edgels 3D points with 3D tangent directions
    projected into all three views.  Returns (edgels (N, 12), poses)."""
    centre = np.array([0.0, 0.0, depth])
    poses = {}
    for v in (2, 3):
        axis = rng.standard_normal(3)
        axis[2] *= 0.3  # mostly orbit about the object, little roll
        r = _rotation(axis, rng.uniform(np.deg2rad(8), np.deg2rad(25)))
        t = np.array([0.0, 0.0, depth]) - r @ centre
        t += rng.standard_normal(3) * np.array([20.0, 20.0, 50.0])
        poses[v] = (r, t)
    half = 0.06 * depth  # object radius: stays inside every view
    rows = []
    while len(rows) < n_edgels:
        pw = centre + rng.uniform(-half, half, 3)
        dw = rng.standard_normal(3)
        dw /= np.linalg.norm(dw)
        row = []
        ok = True
        for v in (1, 2, 3):
            r, t = (np.eye(3), np.zeros(3)) if v == 1 else poses[v]
            pc = r @ pw + t
            dc = r @ dw
            g = pc / pc[2]
            tan = dc[:2] - g[:2] * dc[2]
            nrm = np.linalg.norm(tan)
            pix = K_MAT @ g
            if nrm < 1e-3 or not (0 < pix[0] < 500 and 0 < pix[1] < 560):
                ok = False
                break
            row += [g[0], g[1], tan[0] / nrm, tan[1] / nrm]
        if ok:
            rows.append(row)
    return np.array(rows), poses


def true_solution(edgels, idx, poses, gauge=(1.0, 0.5, 1.0)):
    """The real root of the target system for one sampled edgel triple."""
    a11, e11, e21 = gauge
    g = {(pt, v): np.array([edgels[i, 4 * (v - 1)], edgels[i, 4 * (v - 1) + 1], 1.0])
         for pt, i in zip((1, 2, 3), idx) for v in (1, 2, 3)}
    tn = {(pt, v): np.array([edgels[i, 4 * (v - 1) + 2], edgels[i, 4 * (v - 1) + 3], 0.0])
          for pt, i in zip((1, 2), idx[:2]) for v in (1, 2, 3)}
    x = np.zeros(NV)
    # Depths: triangulate each point in view 1 from view 2, then scale.
    dep = {}
    for pt in (1, 2, 3):
        r, t = poses[2]
        a = np.stack([r @ g[(pt, 1)], -g[(pt, 2)]], axis=1)
        lam = np.linalg.lstsq(a, -t, rcond=None)[0]
        p1 = lam[0] * g[(pt, 1)]
        dep[(pt, 1)] = p1[2]
        for v in (2, 3):
            rv, tv = poses[v]
            dep[(pt, v)] = (rv @ p1 + tv)[2]
    scale = a11 / dep[(1, 1)]
    for k, pv in enumerate([(1, 2), (1, 3), (2, 1), (2, 2), (2, 3),
                            (3, 1), (3, 2), (3, 3)]):
        x[k] = dep[pv] * scale
    base = {1: 8, 2: 13}
    for pt, e1 in ((1, e11), (2, e21)):
        # D1 = u1 g1 + e1 t1 with the gauge's e1; views 2/3 follow by R.
        # Any 3D direction projecting onto t1 at g1 is u g1 + e t1.
        dvec = _tangent_direction(g, tn, pt, poses)
        u1, lam1 = _decompose(dvec, g[(pt, 1)], tn[(pt, 1)])
        dvec = dvec * (e1 / lam1)
        u1 *= e1 / lam1
        b = base[pt]
        x[b] = u1
        for j, v in enumerate((2, 3)):
            dv = poses[v][0] @ dvec
            uv, ev = _decompose(dv, g[(pt, v)], tn[(pt, v)])
            x[b + 1 + j] = uv
            x[b + 3 + j] = ev
    x[18:21] = poses[2][1] * scale
    x[21:24] = poses[3][1] * scale
    for v, sl in ((2, slice(24, 27)), (3, slice(27, 30))):
        x[sl] = _rotation_to_cayley(poses[v][0])
    return x


def _tangent_direction(g, tn, pt, poses):
    """3D direction (camera-1 frame) consistent with the tangents in views
    1 and 2: the intersection of the two back-projected tangent planes."""
    n1 = np.cross(g[(pt, 1)], tn[(pt, 1)])
    r2 = poses[2][0]
    n2 = r2.T @ np.cross(g[(pt, 2)], tn[(pt, 2)])
    d = np.cross(n1, n2)
    return d / np.linalg.norm(d)


def _decompose(d, g, t):
    """d = u g + e t  ->  (u, e)."""
    a = np.stack([g, t], axis=1)
    u, e = np.linalg.lstsq(a, d, rcond=None)[0]
    return u, e


def _rotation_to_cayley(r):
    """Cayley parameters c with R = M(c) / (1 + |c|^2)."""
    q = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return q / (1.0 + np.trace(r))


# ---------------------------------------------------------------------------
# Writers.
# ---------------------------------------------------------------------------


def _write_complex(path, z):
    with open(path, "w") as f:
        for v in np.asarray(z).reshape(-1):
            f.write(f"{v.real:.17g}\t{v.imag:.17g}\n")


def _write_ints(path, rows):
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(str(int(v)) for v in row) + "\n")


def write_problem(out, hx, ht, p0, sols):
    d = os.path.join(out, "problems", PROBLEM)
    os.makedirs(d, exist_ok=True)
    _write_ints(os.path.join(d, "dHdx_indx.txt"), hx.reshape(-1, NV))
    _write_ints(os.path.join(d, "dHdt_indx.txt"), ht.reshape(-1, NV))
    _write_complex(os.path.join(d, "start_params.txt"), p0)
    _write_complex(os.path.join(d, "start_sols.txt"), sols)
    with open(os.path.join(d, "problem.json"), "w") as f:
        json.dump({
            "name": PROBLEM, "num_vars": NV, "num_params": NP,
            "num_tracks": int(sols.shape[0]),
            "hx_max_terms": int(hx.shape[1]), "hx_max_parts": 5,
            "ht_max_terms": int(ht.shape[0]), "ht_max_parts": 6,
        }, f, indent=1)
        f.write("\n")


# ---------------------------------------------------------------------------
# P2C coefficient tables (numpy only).
# ---------------------------------------------------------------------------


def _canonical(poly):
    """A pair-product polynomial {(pa, pb): c} -> (canonical key, weight):
    the polynomial over the gcd of its coefficients, signed so that its
    first pair's coefficient is positive, and that gcd with the sign."""
    pairs = sorted(poly)
    g = int(np.gcd.reduce([abs(poly[q]) for q in pairs]))
    w = g if poly[pairs[0]] > 0 else -g
    return tuple((q, poly[q] // w) for q in pairs), w


def _group(terms):
    """Terms (c, pa, pb, v...) of one entry -> {sorted v...: {pair: c}},
    zero sums and zero coefficients left out."""
    groups = {}
    for c, pa, pb, *vs in terms:
        if c == 0:
            continue
        poly = groups.setdefault(tuple(sorted(vs)), {})
        q = (min(pa, pb), max(pa, pb))
        poly[q] = poly.get(q, 0) + int(c)
    out = {}
    for mono, poly in sorted(groups.items()):
        poly = {q: c for q, c in poly.items() if c}
        if poly:
            out[mono] = poly
    return out


def p2c_tables_from_ph(hx, ht):
    """The PH index tables -> the P2C coefficient tables.

    hx (NV, Tx, 5, NV) and ht (Tt, 6, NV) are the reference encoding
    (``build_tables``).  Each equation's H terms, and each Hx entry's terms,
    are grouped by their x-monomial; each group's pair-product polynomial,
    up to an integer weight, is one coefficient (indices in the sorted order
    of the canonical polynomials), and the group becomes one term
    [weight, coefficient, v...].  Padding terms are [0, Z, NV, ...] with Z
    the zero-pad coefficient, the last index.  Returns (hx_p2c (NV eqs,
    NV vars, Tx', 4), ht_p2c (NV eqs, Tt', 5)), parts innermost, the
    layout the P2C loaders reshape."""
    n = hx.shape[0]
    h_groups = [_group(ht[:, :, e]) for e in range(n)]
    x_groups = [[_group(hx[v, :, :, e]) for v in range(n)]
                for e in range(n)]
    keys = set()
    for groups in h_groups + [g for row in x_groups for g in row]:
        keys.update(_canonical(p)[0] for p in groups.values())
    index = {k: i for i, k in enumerate(sorted(keys))}
    zero = len(index)

    def terms(groups, width):
        rows = []
        for mono, poly in groups.items():
            key, w = _canonical(poly)
            rows.append([w, index[key], *mono])
        return rows, [0, zero] + [n] * width

    tt = max(len(g) for g in h_groups)
    tx = max(len(g) for row in x_groups for g in row)
    ht_p2c = np.zeros((n, tt, 5), np.int64)
    hx_p2c = np.zeros((n, n, tx, 4), np.int64)
    for e in range(n):
        rows, pad = terms(h_groups[e], 3)
        ht_p2c[e] = rows + [pad] * (tt - len(rows))
        for v in range(n):
            rows, pad = terms(x_groups[e][v], 2)
            hx_p2c[e, v] = rows + [pad] * (tx - len(rows))
    return hx_p2c, ht_p2c


def read_ph_tables(out):
    """The committed PH tables of a data root, (hx, ht) as ``build_tables``
    returns them."""
    d = os.path.join(out, "problems", PROBLEM)
    hx = np.loadtxt(os.path.join(d, "dHdx_indx.txt"), dtype=np.int64)
    ht = np.loadtxt(os.path.join(d, "dHdt_indx.txt"), dtype=np.int64)
    return hx.reshape(NV, -1, 5, NV), ht.reshape(-1, 6, NV)


def write_p2c(out, hx, ht):
    """Write dHdx_indx_P2C.txt and dHdt_indx_P2C.txt (one term per line)."""
    hx_p2c, ht_p2c = p2c_tables_from_ph(hx, ht)
    d = os.path.join(out, "problems", PROBLEM)
    _write_ints(os.path.join(d, "dHdx_indx_P2C.txt"), hx_p2c.reshape(-1, 4))
    _write_ints(os.path.join(d, "dHdt_indx_P2C.txt"), ht_p2c.reshape(-1, 5))
    return hx_p2c, ht_p2c


def write_views(out, views):
    d = os.path.join(out, "RANSAC_Data", PROBLEM, "Synthetic")
    for sub in ("Triplet_Edgels", "GT_Poses21", "GT_Poses31"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    with open(os.path.join(d, "Intrinsic_Matrix.txt"), "w") as f:
        for row in K_MAT:
            f.write("\t".join(f"{v:.15g}" for v in row) + "\n")
    for i, (edgels, poses) in enumerate(views):
        with open(os.path.join(d, "Triplet_Edgels",
                               f"Triplet_Edgels_{i:03d}.txt"), "w") as f:
            for row in edgels:
                f.write("\t".join(f"{v:.9g}" for v in row) + "\n")
        for v, sub in ((2, "GT_Poses21"), (3, "GT_Poses31")):
            r, t = poses[v]
            with open(os.path.join(d, sub, f"{sub}_{i:03d}.txt"), "w") as f:
                for row in np.concatenate([r, t[None]], axis=0):
                    f.write("\t".join(f"{v:.17g}" for v in row) + "\n")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="data/synth_trifocal")
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--edgels", type=int, default=5000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-loops", type=int, default=80)
    ap.add_argument("--patience", type=int, default=6)
    ap.add_argument("--p2c-only", metavar="DATA_ROOT", default=None,
                    help="only write the P2C tables of DATA_ROOT's committed "
                         "PH tables (no sympy, no root growing)")
    args = ap.parse_args(argv)
    if args.p2c_only:
        hx_p2c, ht_p2c = write_p2c(args.p2c_only,
                                   *read_ph_tables(args.p2c_only))
        print(f"P2C tables: hx {hx_p2c.shape}, ht {ht_p2c.shape}, "
              f"{int(hx_p2c[..., 1].max()) + 1} coefficient slots")
        return 0
    rng = np.random.default_rng(args.seed)

    t0 = time.time()
    x, p, eqs = build_equations()
    hx, ht = build_tables(x, p, eqs)
    print(f"tables: hx {hx.shape}, ht {ht.shape} ({time.time() - t0:.1f}s)",
          flush=True)

    # Views first: their true roots check the tables.
    views = [make_view(rng, args.edgels) for _ in range(args.views)]
    for edgels, poses in views:
        xs = true_solution(edgels, (0, 1, 2), poses)
        tgt = np.concatenate([edgels[[0, 1, 2]][:, [0, 1, 4, 5, 8, 9]].reshape(-1),
                              edgels[[0, 1]][:, [2, 3, 6, 7, 10, 11]].reshape(-1),
                              [1.0, 0.5, 1.0]])
        res = np.abs(eval_h(ht, xs.astype(complex), tgt.astype(complex))).max()
        print(f"view: {edgels.shape[0]} edgels, true-root residual {res:.2e}")
        assert res < 1e-9, res

    # Unit-modulus random gauge and x0; of many draws keep the best-scaled
    # parameters, so float32 tracking and the monodromy refiner's absolute
    # residual gate (1e-3) see O(1) coefficients.
    best = None
    for _ in range(200):
        gauge = np.exp(2j * np.pi * rng.random(3))
        x0 = np.exp(2j * np.pi * rng.random(NV))
        p0 = linear_start_params(ht, x0, gauge)
        if best is None or np.abs(p0).max() < np.abs(best[1]).max():
            best = (x0, p0)
    x0, p0 = best
    print(f"start params: max |p0| {np.abs(p0).max():.3f}")
    print(f"seed root residual {np.abs(eval_h(ht, x0, p0)).max():.2e}")
    sols = grow_roots(hx, ht, p0, x0, args.max_loops, args.patience,
                      args.seed)
    sols = newton_polish(hx, ht, sols, p0)
    res = np.abs(eval_h(ht, sols, p0)).max(axis=1)
    sols = dedup(sols[res < 1e-8])
    print(f"roots: {sols.shape[0]} (max residual "
          f"{np.abs(eval_h(ht, sols, p0)).max():.2e})")

    write_problem(args.out, hx, ht, p0, sols)
    write_p2c(args.out, hx, ht)
    write_views(args.out, views)
    print(f"wrote {args.out} ({time.time() - t0:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
