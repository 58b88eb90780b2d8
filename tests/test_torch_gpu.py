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
segments).  The handoff decided per tile (HCConfig.tile 1, 2, 7, 32, 128
and 256: the per-path kernel at 1, hc_track_tile_kernel above) equals
track_plain's tile rule, with the elimination it keeps (the tile's last
corrector iteration's), bit for bit in one launch (an active copy of path
0 pads the last tile) and segmented; the tiled kernel gives the same
paths in clusters of 1, 2, 4 and 8 blocks, raises on a cluster the card
refuses, and keeps its registers and its 16 warps per SM.  The kernel's
solve and replay are
also held alone
(hc_solve_replay) to their plain twins; the default build's ptxas line and
blocks per SM are pinned; eval_structure "gathered" and "merged" launch the
default build.  The grid is persistent (warps take paths from a counter):
one block equals the full grid, and a second launch starts its queue
afresh.  K1's phases alone (ops/phases.py, the phase kernels of the same
source) equal their plain versions bit for bit on 3,070 paths (10 x the
roots) for both programs, "replay" in the corrector_jacobian_reuse build
and the evaluation phases in the split2 and abc builds, and each phase
kernel fits as many blocks per SM as the tracker in its build.

The serving surface at H = 100 (30,700 paths per view): the collecting
round equals the default round path for path; run_stream (with the
segmented and the one-call tracker) and the stream-abort pipeline (chunks
of 10) equal run_round and the abort round per view on views 0-2; and a readback (segmented.Readback, the stream's
and the segment loop's) is ready while work queued after it still runs,
as its event shows.

The oracle slice: the kernel with per-path start systems (dynamic_start,
start = target - diff) and TrunPaths off, monodromy's configuration,
equals track_plain bit for bit on an arbitrary leg; monodromy_solve on the
kernel equals it on track_plain (history and roots); the oracle tracker
(ops/tracker.py) on the card agrees with itself on the CPU within the
engine tests' band (3.2 % of flags; x within 1e-3 where both converge, on
the paths 1e-7 nudges do not move by 1e-3).

The P2C slice: the kernel on the P2C coefficient plan (ops/p2c.py) equals
its track_plain bit for bit, TrunPaths on and off, and the P2C engine's
round launches it once.

Hypothesis sharding on the one card (``["cuda:0"] * 2``, each shard on its
own stream): the sharded segmented and one-call trackers equal one launch
bit for bit, shard 0's abort stops shard 1, and
the sharded engine round (H = 3, padded to 4) equals the unsharded round
on the real paths.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
    monodromy,
    trifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    _kernels,
    fused,
    p2c,
    phases,
    ransac,
    segmented,
    tracker,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.parallel import (
    mesh as pmesh,
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
                                    eval_precision="split3_rk2"),
             # The tiled kernel with the corrector's replays.
             "cjr2-cph-tile128": dict(corrector_jacobian_reuse=2,
                                      predictor_handoff=True, tile=128)}


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [1, 2, 7, 32, 128, 256])
@pytest.mark.parametrize("driver", ["one_launch", "segmented"])
def test_cuda_tiled_handoff_matches_track_plain(setup, tile, driver):
    """The handoff decided per tile of ``tile`` paths, bit for bit with
    track_plain on 2 x the roots (614 paths: the last tile of 7, 32, 128
    or 256 is partial), in one launch (padded with an active copy of path
    0) and segmented (no pad, a launch per segment over the active
    prefix)."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, predictor_handoff=True, tile=tile)
    before = _kernels.hc_track.launches
    if driver == "one_launch":
        k = fused.make_track_fn(port, hc)(x0, tgt)
        assert _kernels.hc_track.launches == before + 1
        p = fused.make_plain_track_fn(port, hc)(x0, tgt)
    else:
        k = segmented.make_segmented_track_fn(port, hc)(x0, tgt).track
        assert _kernels.hc_track.launches > before + 1
        p = segmented.make_segmented_track_fn(port, hc, plain=True)(
            x0, tgt).track
    torch.cuda.synchronize()
    _assert_same(k, p)


@pytest.mark.gpu
def test_cuda_tiled_handoff_any_cluster(setup):
    """The tiled tracker at tile 128 gives the same paths in clusters of
    1, 2, 4 and 8 blocks as at its chosen geometry, and in a grid of one
    cluster: which block of a cluster runs a path changes nothing."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, predictor_handoff=True, tile=128)
    fresh, efg, plan = _fresh_state(port, hc, x0, tgt)
    chosen = fresh()
    _kernels.hc_track(*chosen, efg, plan, hc.max_steps + 1, hc)
    runs = {}
    for c in (1, 2, 4, 8):
        for blocks in (None, c):
            runs[c, blocks] = fresh()
            _kernels.hc_track(*runs[c, blocks], efg, plan, hc.max_steps + 1,
                              hc, blocks=blocks, cluster=c)
    torch.cuda.synchronize()
    resident = _kernels.hc_track_tile_clusters(hc)
    assert sorted(resident) == list(range(1, _kernels.MAX_CLUSTER + 1))
    assert all(n > 0 for n in resident.values()), resident
    for key, run in runs.items():
        for u, v in zip(chosen, run):
            assert torch.equal(u, v), key


@pytest.mark.gpu
def test_cuda_tiled_handoff_refused_cluster_raises(setup):
    """A cluster the card refuses (32 blocks: above the portable 8, and the
    kernel does not allow more) raises, launches nothing, and leaves no
    error behind for the next launch."""
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, predictor_handoff=True, tile=128)
    fresh, efg, plan = _fresh_state(port, hc, x0, tgt)
    before = _kernels.hc_track.launches
    with pytest.raises(RuntimeError, match="cluster"):
        _kernels.hc_track(*fresh(), efg, plan, 4, hc, cluster=32)
    assert _kernels.hc_track.launches == before
    state = fresh()
    _kernels.hc_track(*state, efg, plan, 4, hc)
    torch.cuda.synchronize()
    assert _kernels.hc_track.launches == before + 1
    assert int(state[2][:, fused._F_NST].max()) == 4


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


@pytest.mark.gpu
def test_cuda_tile_kernel_resources(setup, tmp_path, monkeypatch):
    """The handoff build's tiled tracker: at most 116 registers (its
    count before clusters), no spills, one block of 16 warps per SM (the
    replaying builds' 16 warps); the build's per-path tracker keeps its
    86 registers."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    hc = config.HCConfig(predictor_handoff=True, tile=128)
    job = _kernels._hc_track_job(hc)
    _kernels.build([job])
    regs, _, spill_st, spill_ld = _resources(_kernels.build_logs[job[1]],
                                             "hc_track_tile_kernel")
    assert regs <= 116 and (spill_st, spill_ld) == (0, 0)
    assert _resources(_kernels.build_logs[job[1]], "hc_track_kernel")[0] == 86
    assert _kernels.hc_track_blocks_per_sm(hc) == 1
    lib = _kernels._hc_track_lib(hc)
    assert _kernels._occupancy_of(lib, torch.device("cuda", 0), 128)[1] == 16


_PHASE_PATHS = 10   # x the roots


def _phase_state(setup, **knobs):
    cfg, port, _, _ = setup
    cfg = dataclasses.replace(cfg, hc=dataclasses.replace(cfg.hc, **knobs))
    return phases.make_state(port, cfg, batch=_PHASE_PATHS * port.num_tracks)


def _phase_matches_plain(state, phase, niter):
    """The phase kernel against plain_phase on the same state: out, the
    pivots and the running sum equal as bits, on every path."""
    before = sum(_kernels.hc_phase.phase_launches.values())
    before_phase = _kernels.hc_phase.phase_launches.get(phase, 0)
    k = phases.run_phase(state, phase, niter)
    assert sum(_kernels.hc_phase.phase_launches.values()) == before + 1
    assert _kernels.hc_phase.phase_launches[phase] == before_phase + 1
    p = phases.plain_phase(state, phase, niter)
    torch.cuda.synchronize()
    # Into the outputs of an earlier call (as the timing reuses them).
    again = phases.run_phase(state, phase, niter,
                             outputs=tuple(t.clone() for t in k))
    torch.cuda.synchronize()
    for u, v, w in zip(k, p, again):
        if u.is_complex():
            u, v, w = (torch.view_as_real(a) for a in (u, v, w))
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
        assert torch.equal(u, w)
    assert bool(torch.isfinite(k[0]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("niter", [1, 3])
@pytest.mark.parametrize("solver", ["reduced", "schedule"])
@pytest.mark.parametrize("phase", _kernels.PHASES)
def test_cuda_phase_matches_plain(setup, phase, solver, niter):
    """Each phase kernel, bit for bit with its plain version; the
    family/reduced split of the elimination raises on the schedule
    program."""
    state = _phase_state(setup, solver=solver)
    if phase in ("elimfam", "elimtail") and solver == "schedule":
        with pytest.raises(ValueError, match="condensed"):
            phases.run_phase(state, phase, niter)
        return
    _phase_matches_plain(state, phase, niter)


@pytest.mark.gpu
@pytest.mark.parametrize("build", ["split2", "abc"])
@pytest.mark.parametrize("phase", ["fill", "monomials", "walk", "walk_bf16",
                                   "evrhs", "elim", "back", "evsolve",
                                   "replay"])
def test_cuda_phase_variant_builds(setup, build, phase):
    """The phases in the evaluation variants' builds: the RK-stage
    evaluation at 2-term splits (split2) and the basis "abc"."""
    state = _phase_state(setup, **_VARIANTS[build])
    _phase_matches_plain(state, phase, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", _kernels.PHASES)
def test_cuda_phase_blocks_per_sm(setup, phase):
    """A phase kernel fits the tracker's blocks per SM in its build (5 in
    the default build, 4 in the replaying one "replay" runs in), so the
    tracker's launch shape is its own."""
    cfg = setup[0]
    hc = phases.phase_config(cfg.hc, phase)
    assert _kernels.hc_phase_blocks_per_sm(phase, hc) == \
        _kernels.hc_track_blocks_per_sm(hc) == (4 if phase == "replay"
                                                else 5)


_H_SERVE = 100


@pytest.fixture(scope="module")
def serving_engines(setup):
    """The default engine, the one-call engine (compact_survivors off) and
    the abort engine (chunks of 10), on cuda:0."""
    cfg = setup[0]
    cfg_o = dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, compact_survivors=False))
    cfg_a = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=True, abort_chunk=10,
        stream_abort_chunk=10))
    return {"segmented": engine.TrifocalPoseEngine(cfg),
            "one_call": engine.TrifocalPoseEngine(cfg_o),
            "abort": engine.TrifocalPoseEngine(cfg_a)}


@pytest.mark.gpu
def test_cuda_collecting_round_equals_the_default_round(serving_engines):
    e = serving_engines["segmented"]
    view = e.load_view(0)
    rr = e.run_round(view, 0, _H_SERVE)
    rc = e.run_round(view, 0, _H_SERVE, collect_solutions=True)
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(getattr(rc, f), getattr(rr, f)), f
        assert np.array_equal(getattr(rc.solutions, f), getattr(rr, f)), f
    assert rc.solutions.x.shape == (_H_SERVE * e.problem.num_tracks, 30)
    assert (rc.num_candidates, rc.best_support21, rc.best_support31,
            rc.found_pose) == (rr.num_candidates, rr.best_support21,
                               rr.best_support31, rr.found_pose)
    assert rc.cand_f21.shape == (rc.num_candidates, 3, 3)
    assert rc.min_residuals is not None and rc.any_within_gt


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["segmented", "one_call", "abort"])
def test_cuda_stream_equals_rounds_per_view(serving_engines, kind):
    e = serving_engines[kind]
    abort = kind == "abort"
    views = [0, 1, 2]
    results, vps = e.run_stream(views, _H_SERVE, 0)
    assert len(results) == len(views) and vps > 0
    for vi, r in zip(views, results):
        q = e.run_round(e.load_view(vi), 0, _H_SERVE)
        assert (r.found_pose, r.best_support21, r.best_support31) == (
            q.found_pose, q.best_support21, q.best_support31), vi
        if abort:
            assert r.chunks_run == q.chunks_run, vi
        else:
            assert (dataclasses.astuple(r.stats)
                    == dataclasses.astuple(q.stats)), vi
            assert r.num_candidates == q.num_candidates, vi


@pytest.mark.gpu
def test_cuda_readback_does_not_wait_for_later_work(setup):
    """A copy queued before a long kernel is ready, by its event, while
    that kernel still runs: waiting for it does not wait for the stream."""
    t = torch.arange(39, dtype=torch.float32, device="cuda") * 2
    torch.cuda.synchronize()
    pending = segmented.Readback(t)
    torch.cuda._sleep(2_000_000_000)  # about a second of spinning
    later = torch.cuda.Event()
    later.record()
    host = pending.wait()
    assert not later.query()
    assert host.tolist() == [2.0 * i for i in range(39)]
    torch.cuda.synchronize()
    assert later.query()


def _leg(port, x0):
    """A monodromy-like leg: the committed roots from the start parameters
    to a random complex point of the same scale (per-path starts)."""
    rng = np.random.default_rng(3)
    n, p = x0.shape[0], len(port.start_params)
    p_from = torch.as_tensor(port.start_params, device=x0.device).expand(
        n, p)
    p_to = p_from + torch.as_tensor(
        (rng.standard_normal(p) + 1j * rng.standard_normal(p)).astype(
            np.complex64), device=x0.device)
    p_to[:, -1] = 1.0
    return p_to.contiguous(), (p_to - p_from).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("basis", ["efg", "abc"])
def test_cuda_dynamic_start_untruncated_matches_track_plain(setup, basis):
    cfg, port, x0, _ = setup
    hc = dataclasses.replace(cfg.hc, truncate_paths=False,
                             pair_coef_basis=basis)
    _kernels.build_hc_track([hc])
    T = port.num_tracks
    tgt, diff = _leg(port, x0[:T])
    before = _kernels.hc_track.launches
    k = fused.make_track_fn(port, hc, dynamic_start=True)(x0[:T], tgt, diff)
    assert _kernels.hc_track.launches == before + 1
    p = fused.make_plain_track_fn(port, hc, dynamic_start=True)(
        x0[:T], tgt, diff)
    torch.cuda.synchronize()
    assert int(k.converged.sum()) > 0 and not bool(k.pruned.any())
    _assert_same(k, p)


@pytest.mark.gpu
def test_cuda_monodromy_on_the_kernel_equals_track_plain(setup):
    cfg, port, _, _ = setup
    hc = dataclasses.replace(cfg.hc, truncate_paths=False)
    kw = dict(seed_sols=np.asarray(port.start_sols)[:24], target_count=40,
              max_loops=1, rng_seed=2, leg_batch=32)
    before = _kernels.hc_track.launches
    ours = monodromy.monodromy_solve(port, cfg.hc, **kw)
    assert _kernels.hc_track.launches == before + 3
    ref = monodromy.monodromy_solve(
        port, hc, track_fn=fused.make_plain_track_fn(port, hc,
                                                     dynamic_start=True),
        device="cuda", **kw)
    assert ours.history == ref.history and ours.history[-1] > 24
    assert np.array_equal(ours.solutions, ref.solutions)


@pytest.mark.gpu
def test_cuda_oracle_matches_the_cpu_oracle(setup):
    """Flags within the band on every path; x within 1e-3 where both
    converge, on the paths that four 1e-7 relative nudges (run on the card
    in one batch with the inputs) move by less than 1e-3: on the CPU alone
    such a nudge moves one of these paths' converged x by 35-48 %."""
    cfg, port, x0, tgt = setup
    track = tracker.make_track_fn(port, cfg.hc)
    n = x0.shape[0]
    runs = [(x0, tgt)]
    for k in range(4):
        gen = torch.Generator(device="cuda").manual_seed(k)
        runs.append(tuple(
            a * (1 + 1e-7 * torch.randn(a.shape, generator=gen,
                                        device="cuda"))
            for a in (x0, tgt)))
    g = track(*(torch.cat(parts) for parts in zip(*runs)))
    c = track(x0.cpu(), tgt.cpu())
    gx = g.x.cpu().reshape(len(runs), n, -1)
    for f in ("converged", "inf_fail", "pruned"):
        assert int((getattr(g, f).cpu()[:n] != getattr(c, f)).sum()) <= int(
            0.032 * n), f
    scale = gx[0].abs().max(dim=1).values.clamp(min=1.0)
    calm = ((gx[1:] - gx[0]).abs().max(dim=2).values / scale < 1e-3).all(0)
    both = g.converged.cpu()[:n] & c.converged
    assert int((both & calm).sum()) >= 0.75 * int(both.sum()) > 0
    err = (gx[0] - c.x).abs().max(dim=1).values / c.x.abs().max(
        dim=1).values.clamp(min=1.0)
    assert float(err[both & calm].max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("truncate", [True, False])
def test_cuda_p2c_plan_matches_track_plain(setup, truncate):
    cfg, port, x0, tgt = setup
    hc = dataclasses.replace(cfg.hc, truncate_paths=truncate)
    tables = p2c.derive_coeff_map(port, config.problem_dir(cfg))
    before = _kernels.hc_track.launches
    k = p2c.make_fused_p2c_track_fn(port, tables, hc)(x0, tgt)
    assert _kernels.hc_track.launches == before + 1
    p = p2c.make_fused_p2c_track_fn(port, tables, hc, plain=True)(x0, tgt)
    torch.cuda.synchronize()
    assert int(k.converged.sum()) > 0
    assert truncate or not bool(k.pruned.any())
    _assert_same(k, p)


@pytest.mark.gpu
def test_cuda_p2c_round_launches_the_kernel_once(setup):
    cfg, _, _, _ = setup
    cfg_p = dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, backend="p2c", truncate_paths=False),
        ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True))
    e = engine.TrifocalPoseEngine(cfg_p)
    before = _kernels.hc_track.launches
    rr = e.run_round(e.load_view(0), seed=0, num_hypotheses=_H)
    assert _kernels.hc_track.launches == before + 1
    assert rr.stats.num_converged > 0 and not rr.pruned.any()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["segmented", "fused"])
def test_cuda_sharded_equals_unsharded(setup, backend):
    """Two shards sharing the card, each on its own stream, launch the
    kernel on their blocks and give the unsharded call bit for bit."""
    cfg, port, x0, tgt = setup
    one = fused.make_track_fn(port, cfg.hc)(x0, tgt)
    track = pmesh.make_sharded_track_fn(port, cfg.hc, ["cuda:0"] * 2,
                                        backend=backend)
    before = _kernels.hc_track.launches
    res = track(x0, tgt)
    torch.cuda.synchronize()
    assert _kernels.hc_track.launches - before >= 2
    _assert_same(res.track if backend == "segmented" else res, one)


@pytest.mark.gpu
def test_cuda_cross_shard_abort_stops_the_other_shard(setup):
    """Shard 0's hypothesis targets the start parameters (pass ratio 0,
    imaginary tolerance huge, TrunPaths off): its hit stops shard 1 on the
    same card before its budget."""
    cfg, port, x0, tgt = setup
    T = port.num_tracks
    tgt = tgt.clone()
    tgt[:T] = torch.as_tensor(port.start_params, device=tgt.device)
    hc = dataclasses.replace(cfg.hc, segment_steps=2, init_delta_t=0.5,
                             truncate_paths=False)
    rc = dataclasses.replace(cfg.ransac, abort_by_good_sol=True,
                             pass_inlier_support_ratio=0.0, imag_part_tol=1e9)
    view = data_io.load_ransac_view(config.ransac_data_dir(cfg), 0)
    edgels = torch.as_tensor(view.edge_locations[:64], device=tgt.device)
    res = pmesh.make_sharded_track_fn(port, hc, ["cuda:0"] * 2,
                                      ransac_cfg=rc)(
        x0, tgt, edgels, torch.eye(3, device=tgt.device), 64)
    assert res.found and 0 <= res.found_path < T
    assert int(res.track.num_steps[T:].max()) < hc.max_steps
    assert not bool(res.track.converged[T:].any())


@pytest.mark.gpu
def test_cuda_sharded_round_equals_unsharded_round(setup):
    """H = 3 over two shards on the card (padded to 4): the round's real
    paths equal the unsharded round's, flags and steps."""
    cfg, _, _, _ = setup
    e1 = engine.TrifocalPoseEngine(cfg)
    e2 = engine.TrifocalPoseEngine(dataclasses.replace(cfg, num_devices=2),
                                   device=["cuda:0"] * 2)
    view = e1.load_view(0)
    r1, r2 = (e.run_round(view, seed=0, num_hypotheses=3) for e in (e1, e2))
    assert r2.stats.num_paths == r1.stats.num_paths
    for f in ("converged", "inf_fail", "pruned", "num_steps"):
        assert np.array_equal(getattr(r1, f), getattr(r2, f)), f
