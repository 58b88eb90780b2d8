"""The CUDA path tracker (csrc/hc_track.cu) on the card.

These tests need a CUDA GPU and skip without one.  This file imports no
jax, so it runs on a GPU host that has none:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Workload: view 0, seed 0, 2 hypotheses (2 x the problem's roots paths).
The kernel is built without FMA contraction and track_plain writes out
every product and sum in the kernel's order, so the two agree bit for bit:
x, flags and step counts must be equal, for both solve programs, for every
variant's build (the step variants, the RK stages' 2-term split of
"split3_rk2" alone and with each replaying variant, the basis "abc"), and
for segmented tracking against one launch (under the predictor handoff,
which restarts at every launch, against track_plain over the same
segments).  The kernel's solve and replay are also held alone
(hc_solve_replay) to their plain twins; the default build's ptxas line and
blocks per SM are pinned; eval_structure "gathered" and "merged" launch the
default build.  The grid is persistent (warps take paths from a counter):
one block equals the full grid, and a second launch starts its queue
afresh.
"""

import dataclasses
import os
import re

import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    _kernels,
    fused,
    ransac,
    segmented,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")
_H = 2


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel runs only on a GPU")
    cfg = config.EngineConfig(data_root=DATA)
    port = trifocal.TrifocalProblem.load(cfg)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    samples = ransac.sample_edgel_triplets(0, view.edge_locations.shape[0], _H)
    tgt = ransac.build_target_params(view.edge_locations, view.edge_tangents,
                                     samples)
    dev = torch.device("cuda")
    _kernels.build_hc_track([dataclasses.replace(cfg.hc, **k)
                             for k in _VARIANTS.values()])
    T = port.num_tracks
    tgt_d = torch.as_tensor(tgt, device=dev).repeat_interleave(T, dim=0)
    x0 = torch.as_tensor(port.start_sols, device=dev).repeat(_H, 1)
    return cfg, port, x0, tgt_d


def _assert_same(k, p):
    for f in ("x", "converged", "inf_fail", "pruned", "num_steps"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f


@pytest.mark.gpu
def test_cuda_kernel_matches_track_plain(setup):
    cfg, port, x0, tgt = setup
    before = _kernels.hc_track.launches
    k = fused.make_track_fn(port, cfg.hc)(x0, tgt)
    assert _kernels.hc_track.launches == before + 1
    p = fused.make_plain_track_fn(port, cfg.hc)(x0, tgt)
    torch.cuda.synchronize()
    assert int(k.converged.sum()) > 0
    _assert_same(k, p)


@pytest.mark.gpu
def test_cuda_schedule_kernel_matches_track_plain(setup):
    """K1e: the static-schedule program, bit for bit."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, solver="schedule")
    track = fused.make_track_fn(port, hc)
    assert track.constants.solver == "schedule"
    k = track(x0, tgt)
    p = fused.make_plain_track_fn(port, hc)(x0, tgt)
    torch.cuda.synchronize()
    assert int(k.converged.sum()) > 0
    _assert_same(k, p)


@pytest.mark.gpu
@pytest.mark.parametrize("compact", [True, False])
def test_cuda_segmented_matches_one_launch(setup, compact):
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, compact_survivors=compact)
    one = fused.make_track_fn(port, hc)(x0, tgt)
    before = _kernels.hc_track.launches
    seg = segmented.make_segmented_track_fn(port, hc)(x0, tgt)
    torch.cuda.synchronize()
    assert _kernels.hc_track.launches - before > 1
    _assert_same(seg.track, one)


@pytest.mark.gpu
def test_cuda_kernel_resumes_bit_exactly(setup):
    """Steps split over two launches on carried state equal one launch:
    the kernel's per-path arithmetic does not depend on the launch."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, max_steps=9)
    c = fused.FusedConstants.build(port)
    plan = torch.as_tensor(c.kernel_plan(), device=x0.device)
    perm = torch.as_tensor(c.perm, dtype=torch.long, device=x0.device)
    efg = fused.build_pair_coefs(port, tgt, hc.pair_coef_basis)
    x = x0[:, perm].contiguous()

    def fresh():
        return x.clone(), x.clone(), fused.init_flags(hc, x.shape[0],
                                                      x.device)

    one = fresh()
    _kernels.hc_track(*one, efg, plan, 10, hc)
    two = fresh()
    _kernels.hc_track(*two, efg, plan, 4, hc)
    _kernels.hc_track(*two, efg, plan, 6, hc)
    torch.cuda.synchronize()
    for u, v in zip(one, two):
        assert torch.equal(u, v)


def _fresh_state(port, hc, x0, tgt):
    c = fused.FusedConstants.build(port, solver=fused.solver_of(hc))
    plan = torch.as_tensor(c.kernel_plan(), device=x0.device)
    perm = torch.as_tensor(c.perm, dtype=torch.long, device=x0.device)
    x = x0[:, perm].contiguous()
    efg = fused.build_pair_coefs(port, tgt, hc.pair_coef_basis)

    def fresh():
        return (x.clone(), x.clone(),
                fused.init_flags(hc, x.shape[0], x.device))

    return fresh, efg, plan


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_cuda_one_block_equals_the_full_grid(setup, solver):
    """The persistent grid's queue order does not matter: one block of
    warps taking every path equals the occupancy-sized grid, path for
    path."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, solver=solver)
    fresh, efg, plan = _fresh_state(port, hc, x0, tgt)
    full, one = fresh(), fresh()
    _kernels.hc_track(*full, efg, plan, hc.max_steps + 1, hc)
    _kernels.hc_track(*one, efg, plan, hc.max_steps + 1, hc, blocks=1)
    torch.cuda.synchronize()
    assert _kernels.hc_track_blocks_per_sm(hc) > 0
    for u, v in zip(full, one):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_cuda_launches_reset_the_path_counter(setup):
    """Each launch starts its path queue at 0: the second of two launches
    in a row on fresh state equals a fresh process's first, on every
    path."""
    cfg, port, x0, tgt = setup
    fresh, efg, plan = _fresh_state(port, cfg.hc, x0, tgt)
    first, second = fresh(), fresh()
    _kernels.hc_track(*first, efg, plan, 12, cfg.hc)
    _kernels.hc_track(*second, efg, plan, 12, cfg.hc)
    torch.cuda.synchronize()
    c = fused.FusedConstants.build(port)
    p = fused.track_plain(c, cfg.hc, *fresh(), efg, niter=12)
    for u, v, w in zip(first, second, p):
        assert torch.equal(u, v)
        assert torch.equal(v, w)
    assert int(second[2][:, fused._F_NST].max()) == 12


@pytest.mark.gpu
def test_cuda_wrapper_takes_schedule_plan(setup):
    """The schedule program's plan (steps of up to 30 candidates) goes
    through the wrapper and its launch succeeds."""
    cfg, port, x0, tgt = setup
    c = fused.FusedConstants.build(port, solver="schedule")
    assert max(len(cd) for st in c.stages for cd in st.cands) == 30
    plan = torch.as_tensor(c.kernel_plan(), device=x0.device)
    perm = torch.as_tensor(c.perm, dtype=torch.long, device=x0.device)
    x = x0[:, perm].contiguous()
    fl = fused.init_flags(cfg.hc, x.shape[0], x.device)
    before = _kernels.hc_track.launches
    _kernels.hc_track(x, x.clone(), fl,
                      fused.build_pair_coefs(port, tgt,
                                             cfg.hc.pair_coef_basis),
                      plan, 2, cfg.hc)
    torch.cuda.synchronize()
    assert _kernels.hc_track.launches == before + 1
    assert int(fl[:, fused._F_NST].max()) == 2


@pytest.mark.gpu
def test_cuda_wrapper_checks_inputs(setup):
    cfg, port, x0, tgt = setup
    c = fused.FusedConstants.build(port)
    plan = torch.as_tensor(c.kernel_plan(), device=x0.device)
    efg = fused.build_pair_coefs(port, tgt, cfg.hc.pair_coef_basis)
    fl = fused.init_flags(cfg.hc, x0.shape[0], x0.device)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.hc_track(x0.t().contiguous().t(), x0.clone(), fl, efg, plan,
                          2, cfg.hc)
    with pytest.raises(ValueError, match="float32"):
        _kernels.hc_track(x0.clone(), x0.clone(), fl.double(), efg, plan, 2,
                          cfg.hc)


_VARIANTS = {"rk2": dict(predictor="rk2"), "rk3": dict(predictor="rk3"),
             "cjr1": dict(corrector_jacobian_reuse=1),
             "cjr2": dict(corrector_jacobian_reuse=2),
             "cph": dict(predictor_handoff=True, tile=1),
             "rkj": dict(rk_jacobian_reuse=True),
             "cjr2-cph": dict(corrector_jacobian_reuse=2,
                              predictor_handoff=True, tile=1),
             "split2": dict(eval_precision="split3_rk2"),
             "abc": dict(pair_coef_basis="abc"),
             # The split's rhs-only assembly in a replay: the handoff's
             # stage 1 and the frozen RK stages; and beside the
             # corrector's replays, which stay FP32.
             "cph-split2": dict(predictor_handoff=True, tile=1,
                                eval_precision="split3_rk2"),
             "rkj-split2": dict(rk_jacobian_reuse=True,
                                eval_precision="split3_rk2"),
             "cjr2-split2": dict(corrector_jacobian_reuse=2,
                                 eval_precision="split3_rk2"),
             "rk2-abc-split2": dict(predictor="rk2", pair_coef_basis="abc",
                                    eval_precision="split3_rk2")}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_VARIANTS))
def test_cuda_variant_matches_track_plain(setup, name):
    """Each step variant's build, bit for bit, on 1 x the roots."""
    cfg, port, x0, tgt = setup
    T = port.num_tracks
    hc = dataclasses.replace(cfg.hc, **_VARIANTS[name])
    before = _kernels.hc_track.launches
    k = fused.make_track_fn(port, hc)(x0[:T], tgt[:T])
    assert _kernels.hc_track.launches == before + 1
    p = fused.make_plain_track_fn(port, hc)(x0[:T], tgt[:T])
    torch.cuda.synchronize()
    _assert_same(k, p)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_VARIANTS))
def test_cuda_variant_segmented(setup, name):
    """Segmented equals one launch; under the handoff, which restarts at
    every launch, it equals track_plain called once per segment."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, **_VARIANTS[name])
    seg = segmented.make_segmented_track_fn(port, hc)(x0, tgt).track
    if hc.predictor_handoff:
        ref = segmented.make_segmented_track_fn(port, hc, plain=True)(
            x0, tgt).track
    else:
        ref = fused.make_track_fn(port, hc)(x0, tgt)
    torch.cuda.synchronize()
    _assert_same(seg, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["reduced", "schedule"])
def test_cuda_replay_is_the_solve_on_its_rhs(setup, solver):
    """The kernel's solve and replay alone (hc_solve_replay) on seeded
    systems with the Jacobian's sparsity and a magnitude spread: the
    replay on the system's own rhs gives the solve's x bit for bit, and
    both, and the replay on a fresh rhs, equal their plain twins."""
    import numpy as np

    _, port, x0, _ = setup
    dev = x0.device
    c = fused.FusedConstants.build(port, solver=solver)
    f = port.factored
    pattern = f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1]
    rng = np.random.default_rng(29)
    A = 512
    shape = (A, 30, 30)
    a = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
         * pattern * 10.0 ** rng.uniform(-2, 3, (A, 1, 30)))
    b, b2 = rng.standard_normal((2, A, 30)) + 1j * rng.standard_normal(
        (2, A, 30))
    m = np.zeros((A, 30, fused.WIDTH), np.complex64)
    m[:, :, :30] = a[:, c.row_order][:, :, c.perm]
    m[:, :, 30] = b[:, c.row_order]
    m = torch.as_tensor(m, device=dev)
    fresh = torch.as_tensor(
        np.ascontiguousarray(b2[:, c.row_order], dtype=np.complex64),
        device=dev)
    plan = torch.as_tensor(c.kernel_plan(), device=dev)
    xs, xr = _kernels.hc_solve_replay(m, m[:, :, 30].contiguous(), plan)
    xs2, xr2 = _kernels.hc_solve_replay(m, fresh, plan)
    tb = fused._Tables(c, dev)
    kept = fused.factor_plain(tb, (m.real.contiguous(), m.imag.contiguous()))
    ps = torch.complex(*fused.backsub_plain(tb, kept.mr, kept.mi, kept.piv))
    pr = torch.complex(*fused.resolve_plain(
        tb, kept, (fresh.real.contiguous(), fresh.imag.contiguous())))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(xs).all())
    for u, v in ((xr, xs), (xs, ps), (xs2, ps), (xr2, pr)):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_cuda_rkj_refuses_a_condensed_plan(setup):
    """Under rk_jacobian_reuse the wrapper raises on the condensed plan
    rather than launch it."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, rk_jacobian_reuse=True)
    c = fused.FusedConstants.build(port)
    plan = torch.as_tensor(c.kernel_plan(), device=x0.device)
    x = x0[:, torch.as_tensor(c.perm, device=x0.device)].contiguous()
    before = _kernels.hc_track.launches
    with pytest.raises(ValueError, match="schedule"):
        _kernels.hc_track(x, x.clone(), fused.init_flags(hc, x.shape[0],
                                                        x.device),
                          fused.build_pair_coefs(port, tgt,
                                                 hc.pair_coef_basis),
                          plan, 2, hc)
    assert _kernels.hc_track.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("structure", ["gathered", "merged"])
def test_cuda_structures_launch_the_default_build(setup, structure):
    """The evaluation structures are one function here: each launches the
    default build, and its result is the default's bit for bit."""
    cfg, port, x0, tgt = setup
    T = port.num_tracks
    hc = dataclasses.replace(cfg.hc, eval_structure=structure)
    assert _kernels.hc_track_label(hc) == _kernels.hc_track_label(cfg.hc)
    before = _kernels.hc_track.launches
    k = fused.make_track_fn(port, hc)(x0[:T], tgt[:T])
    assert _kernels.hc_track.launches == before + 1
    ref = fused.make_track_fn(port, cfg.hc)(x0[:T], tgt[:T])
    torch.cuda.synchronize()
    _assert_same(k, ref)


def _resources(log, entry):
    """(registers, static shared bytes, spill stores, spill loads) that
    ptxas -v reported for the kernel entry whose name holds ``entry``."""
    out, on, spills = None, False, [None, None]
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = entry in line
        elif on and "spill stores" in line:
            spills = [int(v) for v in re.findall(r"(\d+) bytes spill", line)]
        elif on and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out = (regs, int(smem.group(1)) if smem else 0, *spills)
    return out


@pytest.mark.gpu
def test_cuda_default_build_resources(setup, tmp_path, monkeypatch):
    """The default build's resources: 83 registers, 45,568 bytes of
    static shared memory (4 warps of 11,392: the swizzled system, the pair
    products, one 32-entry vector and the monomial table), no spills (a
    fresh build, so that ptxas reports it); 5 blocks per SM."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    job = _kernels._hc_track_job(config.HCConfig())
    _kernels.build([job])
    assert _resources(_kernels.build_logs[job[1]], "hc_track_kernel") == \
        (83, 45568, 0, 0)
    assert _kernels.hc_track_blocks_per_sm(config.HCConfig()) == 5
