"""The port's P2C strategy (ops/p2c.py) against the JAX package's, both on
the CPU, on the committed generated problem.

* The generator: ``tools/make_synth_data.py --p2c-only`` rebuilds the
  committed P2C tables byte for byte from the committed PH tables and
  leaves those as they are.
* The JAX ``load_p2c_tables`` defaults to the reference's 16 H terms; the
  generated system has 22.  The JAX side is called with its loader bound
  to 8 and 22 terms (a monkeypatch local to these tests).  The port's
  loader reads the term counts from the files' sizes.
* ``derive_coeff_map`` (60 samples, as the JAX test): the same tables,
  the same coefficient count and a coefficient map within 1e-4 (both fit
  complex64 PH probes by complex128 least squares: their probes differ in
  float32 rounding only).  The zero-pad slot maps to 0.
* The evaluator against the JAX evaluator and against the port's PH
  evaluation at rtol = atol = 1e-4, the JAX test's bound; corrupted tables
  are refused, as in the JAX test.
* ``make_p2c_problem`` on the same tables: the integer tables exactly, the
  weights and start coefficients to 1e-6.  Its plan is the PH plan's
  shape: the same monomials (padding terms leave the tables) and 34
  pseudo pairs; ops/bound.py counts the same operations on it.
* The coefficient builder: the pseudo-pair coefficients K1 gets are the
  pair coefficients through the map (the identity here, to 1e-6).
* The P2C tracker (``track_plain`` on K1's P2C plan) against the JAX P2C
  kernel in interpret mode: 32 paths, 12 steps, tile 32, as
  tests/test_torch_tracker.py holds K1: flags and steps equal on the paths
  whose flags four 1e-7 relative nudges of x0 do not change, x within
  1e-3 relative on the paths the nudges do not move by 1e-4.
"""

import dataclasses
import functools
import importlib.util
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import eval as jev
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import p2c as jp2c
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    bound,
    fused,
    p2c,
    ransac,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import eval as ev
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "synth_trifocal")
PROBLEM_DIR = os.path.join(DATA, "problems", "trifocal_2op1p_30x30")
_SAMPLES = 60
_TR, _STEPS, _PERTURBATIONS = 32, 12, 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads, as in the other tracker tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "tools", "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problems():
    cfg = config.EngineConfig(data_root=DATA)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    return (cfg, trifocal.TrifocalProblem.load(cfg),
            jtrifocal.TrifocalProblem.load(jcfg))


@pytest.fixture(scope="module")
def tables(problems):
    """(port tables, JAX tables), both derived with _SAMPLES samples."""
    _, port, jp = problems
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp2c, "load_p2c_tables", functools.partial(
            jp2c.load_p2c_tables, hx_terms=8, ht_terms=22))
        jt = jp2c.derive_coeff_map(jp, PROBLEM_DIR, samples=_SAMPLES)
    return p2c.derive_coeff_map(port, PROBLEM_DIR, samples=_SAMPLES), jt


def _as_port(jt) -> p2c.P2CTables:
    return p2c.P2CTables(hx=np.asarray(jt.hx), ht=np.asarray(jt.ht),
                         n_coeffs=int(jt.n_coeffs),
                         coeff_map=np.asarray(jt.coeff_map))


def test_generator_rebuilds_the_committed_tables(tmp_path):
    """--p2c-only writes the two P2C files byte for byte from the PH
    tables, and no other file."""
    out = tmp_path / "problems" / "trifocal_2op1p_30x30"
    out.mkdir(parents=True)
    for f in ("dHdx_indx.txt", "dHdt_indx.txt"):
        shutil.copy(os.path.join(PROBLEM_DIR, f), out / f)
    assert _generator().main(["--p2c-only", str(tmp_path)]) == 0
    assert sorted(p.name for p in out.iterdir()) == [
        "dHdt_indx.txt", "dHdt_indx_P2C.txt", "dHdx_indx.txt",
        "dHdx_indx_P2C.txt"]
    for f in os.listdir(out):
        with open(os.path.join(PROBLEM_DIR, f), "rb") as a:
            assert (out / f).read_bytes() == a.read(), f


def test_each_coefficient_is_one_pair_product():
    """On the generated system every (equation, x-monomial) group of H
    holds one parameter-pair term, so the P2C coefficients are the 34 pair
    products with integer weights +-1, +-2, and the zero-pad slot is the
    35th."""
    gen = _generator()
    hx, ht = gen.read_ph_tables(DATA)
    groups = [gen._group(ht[:, :, e]) for e in range(30)]
    assert sum(map(len, groups)) == 528
    assert {len(p) for g in groups for p in g.values()} == {1}
    hx_p, ht_p = gen.p2c_tables_from_ph(hx, ht)
    for t in (hx_p, ht_p):
        assert set(np.unique(t[..., 0])) == {-2, -1, 0, 1, 2}
        assert t[..., 1].max() == 34
        assert (t[..., 1][t[..., 0] == 0] == 34).all()


def test_load_takes_term_counts_from_the_files(tmp_path):
    hx, ht = p2c.load_p2c_tables(PROBLEM_DIR)
    assert hx.shape == (30, 30, 8, 4) and ht.shape == (30, 22, 5)
    for f in ("dHdx_indx_P2C.txt", "dHdt_indx_P2C.txt"):
        shutil.copy(os.path.join(PROBLEM_DIR, f), tmp_path / f)
    with open(tmp_path / "dHdt_indx_P2C.txt", "a") as f:
        f.write("0\t34\t30\t30\t30\n")
    with pytest.raises(ValueError, match="not"):
        p2c.load_p2c_tables(str(tmp_path))


def test_coeff_map_matches_jax(tables):
    t, jt = tables
    assert np.array_equal(t.hx, np.asarray(jt.hx))
    assert np.array_equal(t.ht, np.asarray(jt.ht))
    assert t.n_coeffs == jt.n_coeffs == 35
    assert t.coeff_map.shape == np.asarray(jt.coeff_map).shape == (35, 34)
    assert t.coeff_map.dtype == np.complex64
    assert np.abs(t.coeff_map - np.asarray(jt.coeff_map)).max() <= 1e-4


def test_zero_pad_coefficient_maps_to_zero(tables):
    t, jt = tables
    assert not t.coeff_map[-1].any()
    assert not np.asarray(jt.coeff_map)[-1].any()


@pytest.fixture(scope="module")
def evaluations(problems, tables):
    _, port, jp = problems
    t, jt = tables
    rng = np.random.default_rng(99)
    B = 4
    x = (rng.standard_normal((B, 30))
         + 1j * rng.standard_normal((B, 30))).astype(np.complex64)
    start = np.asarray(port.start_params)
    tgt = (rng.standard_normal((B, 34))
           + 1j * rng.standard_normal((B, 34))).astype(np.complex64)
    tgt[:, 33] = 1.0
    tt = rng.uniform(0.1, 0.9, B).astype(np.float32)
    got = p2c.make_p2c_evaluator(port, t)(
        torch.as_tensor(x), torch.as_tensor(start), torch.as_tensor(tgt),
        torch.as_tensor(tt))
    ref = jp2c.make_p2c_evaluator(jp, jt)(
        jnp.asarray(x), jnp.asarray(start), jnp.asarray(tgt), jnp.asarray(tt))
    xt, tg = torch.as_tensor(x), torch.as_tensor(tgt)
    p_t = ev.param_homotopy(torch.as_tensor(tt), torch.as_tensor(start), tg)
    ph = (ev.eval_Hx_direct(port, xt, p_t), ev.eval_H_direct(port, xt, p_t),
          ev.eval_minus_Ht_direct(port, xt, p_t, tg - torch.as_tensor(start)))
    jph = jev.eval_H_direct(jp, x, np.asarray(p_t))
    return ([a.numpy() for a in got], [np.asarray(a) for a in ref],
            [a.numpy() for a in ph], np.asarray(jph))


@pytest.mark.parametrize("out", ["hx", "h", "minus_ht"])
def test_evaluator_matches_jax_and_ph(evaluations, out):
    got, ref, ph, jph = evaluations
    i = ["hx", "h", "minus_ht"].index(out)
    assert got[i].shape == ref[i].shape == ph[i].shape
    np.testing.assert_allclose(got[i], ref[i], **TOL)
    np.testing.assert_allclose(got[i], ph[i], **TOL)
    # The two packages' PH evaluations agree on these inputs too.
    np.testing.assert_allclose(ph[1], jph, **TOL)


def test_corrupted_tables_are_refused(problems, tmp_path):
    """The derivation validates itself: a shifted coefficient index column
    leaves a residual and raises."""
    _, port, _ = problems
    for f in ("dHdx_indx_P2C.txt", "dHdt_indx_P2C.txt"):
        shutil.copy(os.path.join(PROBLEM_DIR, f), tmp_path / f)
    raw = np.loadtxt(tmp_path / "dHdx_indx_P2C.txt", dtype=np.int64)
    flat = raw.reshape(30, 30, 8, 4)
    flat[..., 1] = (flat[..., 1] + 7) % 35
    np.savetxt(tmp_path / "dHdx_indx_P2C.txt", flat.reshape(raw.shape),
               fmt="%d")
    with pytest.raises(ValueError, match="table interpretation mismatch"):
        p2c.derive_coeff_map(port, str(tmp_path), samples=8)


@pytest.fixture(scope="module")
def pseudo(problems, tables):
    """make_p2c_problem of both packages on the JAX tables."""
    _, port, jp = problems
    jt = tables[1]
    return (p2c.make_p2c_problem(port, _as_port(jt)),
            jp2c.make_p2c_problem(jp, jt))


def test_pseudo_problem_equals_jax(pseudo):
    pp, jpp = pseudo
    assert (pp.num_vars, pp.num_params, pp.num_tracks) == (
        jpp.num_vars, jpp.num_params, jpp.num_tracks) == (30, 35, 307)
    assert np.array_equal(pp.hx_table, np.asarray(jpp.hx_table))
    assert np.array_equal(pp.ht_table, np.asarray(jpp.ht_table))
    np.testing.assert_allclose(pp.start_params, np.asarray(jpp.start_params),
                               rtol=0, atol=1e-6)
    for k, v in vars(pp.factored).items():
        theirs = np.asarray(getattr(jpp.factored, k))
        if v.dtype.kind == "f":
            np.testing.assert_allclose(v, theirs, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(v, theirs), k


def test_pseudo_plan_has_the_ph_plan_shape(problems, pseudo):
    """The constant 1 sits at index 35; every pseudo pair is (coefficient,
    35); padding terms leave no monomial, so the plan holds the PH plan's
    282 monomials and its solve program, and fits the kernel."""
    _, port, _ = problems
    pp = pseudo[0]
    assert (pp.factored.pp_b == 35).all()
    assert np.array_equal(pp.factored.pp_a, np.arange(34))
    c = fused.FusedConstants.build(pp)
    c_ph = fused.FusedConstants.build(port)
    assert c.q == 34 and len(c.monomials()) == 282 <= fused.MMAX
    assert np.array_equal(c.monomials(), c_ph.monomials())
    assert np.array_equal(c.perm, c_ph.perm)
    assert np.array_equal(c.row_order, c_ph.row_order)
    assert tuple(c.kernel_plan()[:4]) == (30, 34, 30, len(c.maps))
    # Each coefficient is one pair product: the same work as PH.
    assert bound.solve_flops(c) == bound.solve_flops(c_ph)


def test_bound_takes_the_p2c_plan(problems, pseudo):
    """ops/bound.py counts the P2C plan from its own constants: for the same
    work, the same operations as the PH plan (each coefficient is one pair
    product) and the same bound."""
    _, port, _ = problems
    c = fused.FusedConstants.build(pseudo[0])
    c_ph = fused.FusedConstants.build(port)
    work = dict(steps=2000, newton=4000, solves=12000)
    assert bound.tracker_flops(c, work) == bound.tracker_flops(c_ph, work)
    got = bound.tracker_bound(c, work, 614)
    assert got == bound.tracker_bound(c_ph, work, 614)
    assert got[1] == "operations" and got[0] > 0


@pytest.mark.parametrize("basis", ["efg", "abc"])
def test_coef_builder_maps_the_pair_coefficients(problems, tables, basis):
    """The builder maps build_pair_coefs' (B, 3, Q) through the coefficient
    map's rows: on this problem the map is the identity up to the fit's
    noise, so P' is P to float32 rounding."""
    cfg, port, _ = problems
    hc = dataclasses.replace(cfg.hc, pair_coef_basis=basis, max_steps=0)
    track = p2c.make_fused_p2c_track_fn(port, tables[0], hc)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    s = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 3)
    tgt = torch.as_tensor(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s))
    got = []
    orig = fused.track_plain

    def spy(consts, hc_, x, xl, fl, efg, **kw):
        got.append(efg)
        return orig(consts, hc_, x, xl, fl, efg, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "track_plain", spy)
        track(torch.as_tensor(port.start_sols[:3]), tgt)
    base = fused.build_pair_coefs(port, tgt, basis)
    assert got[0].shape == base.shape == (3, 3, 34)
    assert got[0].dtype == torch.complex64
    scale = base.abs().amax(dim=2, keepdim=True)
    assert float(((got[0] - base).abs() / scale).max()) < 1e-6


def test_coef_builder_is_checked(problems):
    cfg, port, _ = problems
    with pytest.raises(ValueError, match="dynamic_start"):
        fused.make_track_fn(port, cfg.hc, dynamic_start=True,
                            coef_builder=lambda t: t)
    track = fused.make_track_fn(
        port, cfg.hc, coef_builder=lambda t: torch.zeros(
            (t.shape[0], 3, 33), dtype=torch.complex64))
    x0 = torch.as_tensor(port.start_sols[:2])
    with pytest.raises(ValueError, match="coef_builder gave"):
        track(x0, torch.as_tensor(port.start_params).repeat(2, 1))


def test_p2c_tracker_matches_jax_kernel_12_steps(problems, tables):
    """K1's P2C plan through track_plain against the JAX P2C kernel in
    interpret mode, on the same tables."""
    cfg, port, jp = problems
    jt = tables[1]
    hc = dataclasses.replace(cfg.hc, max_steps=_STEPS)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    s = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], 1)
    tgt = np.repeat(ransac.build_target_params(
        view.edge_locations, view.edge_tangents, s), _TR, axis=0)
    x0 = np.asarray(port.start_sols)[:_TR]
    ref = jp2c.make_fused_p2c_track_fn(jp, jt, hc, tile=_TR, interpret=True)(
        x0, tgt, tgt - jp.start_params)
    track = p2c.make_fused_p2c_track_fn(port, _as_port(jt), hc)

    def run(x):
        return track(torch.as_tensor(x), torch.as_tensor(tgt))

    got = run(x0)
    flags = ("num_steps", "converged", "pruned", "inf_fail")
    noise = np.random.default_rng(7)
    stable = np.ones(_TR, bool)
    calm = np.ones(_TR, bool)
    scale = max(np.abs(ref.x).max(), 1.0)
    for _ in range(_PERTURBATIONS):
        nudge = 1 + 1e-7 * noise.standard_normal(x0.shape)
        moved = run((x0 * nudge).astype(x0.dtype))
        for f in flags:
            stable &= (getattr(moved, f) == getattr(got, f)).numpy()
        calm &= (np.abs(moved.x.numpy() - got.x.numpy()).max(axis=1)
                 / scale < 1e-4)
    assert stable.sum() >= 0.9 * _TR and (calm & stable).sum() >= 0.9 * _TR
    for f in flags:
        np.testing.assert_array_equal(getattr(got, f).numpy()[stable],
                                      np.asarray(getattr(ref, f))[stable])
    assert int(got.num_steps.max()) == _STEPS + 1
    both = calm & stable
    assert np.abs(got.x.numpy() - ref.x)[both].max() / scale < 1e-3
