"""The CUDA path tracker (csrc/hc_track.cu) on the card.

These tests need a CUDA GPU and skip without one.  This file imports no
jax, so it runs on a GPU host that has none:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Workload: view 0, seed 0, 2 hypotheses (2 x the problem's roots paths).
The kernel is built without FMA contraction and track_plain writes out
every product and sum in the kernel's order, so the two agree bit for bit:
x, flags and step counts must be equal, for both solve programs and for
segmented tracking against one launch.
"""

import dataclasses
import os

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
    efg = fused.build_pair_coefs(port, tgt)
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
    _kernels.hc_track(x, x.clone(), fl, fused.build_pair_coefs(port, tgt),
                      plan, 2, cfg.hc)
    torch.cuda.synchronize()
    assert _kernels.hc_track.launches == before + 1
    assert int(fl[:, fused._F_NST].max()) == 2


@pytest.mark.gpu
def test_cuda_wrapper_checks_inputs(setup):
    cfg, port, x0, tgt = setup
    c = fused.FusedConstants.build(port)
    plan = torch.as_tensor(c.kernel_plan(), device=x0.device)
    efg = fused.build_pair_coefs(port, tgt)
    fl = fused.init_flags(cfg.hc, x0.shape[0], x0.device)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.hc_track(x0.t().contiguous().t(), x0.clone(), fl, efg, plan,
                          2, cfg.hc)
    with pytest.raises(ValueError, match="float32"):
        _kernels.hc_track(x0.clone(), x0.clone(), fl.double(), efg, plan, 2,
                          cfg.hc)
