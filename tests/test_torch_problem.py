"""The port's problem compiler and tracker constants against the JAX
package's, on the committed data root: bit-equal, since both compile the
same integer tables with the same numpy code."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    trifocal as jtrifocal,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import fused as jfused
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import fused
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import config

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")


@pytest.fixture(scope="module")
def cfg():
    return config.EngineConfig(data_root=DATA)


@pytest.fixture(scope="module")
def problems(cfg):
    port = trifocal.TrifocalProblem.load(cfg)
    jcfg = dataclasses.replace(cfg, problem=config.problem_config(cfg))
    return port, jtrifocal.TrifocalProblem.load(jcfg)


def test_problem_json_dimensions(cfg):
    with open(os.path.join(config.problem_dir(cfg), "problem.json")) as f:
        dims = json.load(f)
    prob = config.problem_config(cfg)
    for k, v in dims.items():
        assert getattr(prob, k) == v


@pytest.mark.parametrize(
    "field", [f.name for f in dataclasses.fields(trifocal.FactoredSystem)])
def test_factored_system_bit_equal(problems, field):
    port, ref = problems
    a = getattr(port.factored, field)
    b = getattr(ref.factored, field)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_problem_arrays_bit_equal(problems):
    port, ref = problems
    for name in ("start_params", "start_sols", "hx_table", "ht_table"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    again = trifocal.TrifocalProblem.from_arrays(ref)
    assert np.array_equal(again.factored.hx_C, ref.factored.hx_C)


def test_pad_slots(problems):
    """pad_params / pad_vars append the constant-1 slots the tables index
    (parameter num_params, variable num_vars)."""
    port, _ = problems
    p = torch.as_tensor(port.start_params)
    assert torch.equal(trifocal.pad_params(p[:-1]), p)
    x = trifocal.pad_vars(torch.as_tensor(port.start_sols))
    assert x.shape == (port.num_tracks, port.num_vars + 1)
    assert bool((x[:, -1] == 1).all())


@pytest.fixture(scope="module")
def constants(problems):
    port, ref = problems
    return fused.FusedConstants.build(port), jfused.FusedConstants.build(ref)


def test_constants_layout_bit_equal(constants):
    c, j = constants
    assert j.reduced is not None  # the reference takes its condensed path
    for name in ("perm", "pos_of_var", "row_order"):
        assert np.array_equal(getattr(c, name), getattr(j, name)), name
    assert c.depth_rows == j.depth_rows
    # Hx nonzero order: the reference's fold matrix columns in that order.
    assert np.array_equal(c.hx_C.T, j.chx[:, :j.k2])
    assert np.array_equal(c.ht_C.T, j.cht[:, :j.k3])


def test_solve_program_covers_every_column(constants):
    c, j = constants
    cols = [col for st in c.stages for col in st.cols]
    assert sorted(cols) == list(range(30))
    steps = [s for st in c.stages for s in st.steps]
    assert steps == list(range(30))
    # The reference's reduced system: its size and column offset.
    assert len(c.plan.final_cols) == j.reduced.n2
    assert 30 - len(c.plan.final_cols) == j.reduced.col_off


def test_kernel_plan_header(constants):
    c, _ = constants
    plan = c.kernel_plan()
    assert plan.dtype == np.int32
    assert tuple(plan[:4]) == (30, c.q, 30, len(c.maps))
    offs = plan[4:11]
    assert offs[0] == 16 and np.all(np.diff(offs) > 0) and offs[-1] < plan.size
    assert tuple(plan[11:13]) == (len(c.qa), len(c.qa) + len(c.ca))


@pytest.mark.parametrize("knob,value", [
    ("solver", "dense"), ("pair_coef_basis", "ab"), ("predictor", "rk5"),
    ("eval_structure", "dense"), ("predictor", "euler"),
    ("backend", "pallas"), ("backend", "cuda"),
    ("eval_precision", "bf16"), ("corrector_jacobian_reuse", 3),
    ("truncate_paths", None), ("num_devices", 2), ("num_devices", 8)])
def test_non_shipped_config_rejected(cfg, knob, value):
    if knob == "num_devices":
        # Sharded P2C: the JAX engine would track with its oracle instead.
        bad = dataclasses.replace(cfg, num_devices=value,
                                  hc=dataclasses.replace(cfg.hc,
                                                         backend="p2c"))
    else:
        bad = dataclasses.replace(cfg, hc=dataclasses.replace(
            cfg.hc, **{knob: value}))
    with pytest.raises(ValueError, match=knob):
        config.check_shipped(bad)


def test_handoff_with_frozen_rk_stages_rejected(cfg):
    """The JAX kernel refuses predictor_handoff with rk_jacobian_reuse."""
    bad = dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, predictor_handoff=True, rk_jacobian_reuse=True))
    with pytest.raises(ValueError, match="predictor_handoff"):
        config.check_shipped(bad)


def test_shipped_config_accepted(cfg):
    """The defaults, one device, all visible ones or a sharded mesh, the
    schedule solve and the TrunRANSAC abort round, the oracle and the P2C
    backends, and TrunPaths off."""
    config.check_shipped(cfg)
    for backend in ("xla", "p2c"):
        config.check_shipped(dataclasses.replace(
            cfg, hc=dataclasses.replace(cfg.hc, backend=backend,
                                        truncate_paths=False)))
    for devices in (None, 1, 2, 8):
        config.check_shipped(dataclasses.replace(cfg, num_devices=devices))
    config.check_shipped(dataclasses.replace(
        cfg, num_devices=4, hc=dataclasses.replace(cfg.hc, backend="xla")))
    config.check_shipped(dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, solver="schedule"),
        ransac=dataclasses.replace(cfg.ransac, abort_by_good_sol=True)))
    bad = dataclasses.replace(cfg, ransac=dataclasses.replace(
        cfg.ransac, abort_by_good_sol=1.5))
    with pytest.raises(ValueError, match="abort_by_good_sol"):
        config.check_shipped(bad)


def test_handoff_needs_tile_one(cfg):
    """The JAX kernel decides the handoff per tile of hc.tile paths, the
    port per path: only tile 1 is the same function (shown on the JAX
    kernel in tests/test_torch_variants_handoff.py)."""
    for tile in (128, 32):
        bad = dataclasses.replace(cfg, hc=dataclasses.replace(
            cfg.hc, predictor_handoff=True, tile=tile))
        with pytest.raises(ValueError, match="per tile"):
            config.check_shipped(bad)
    config.check_shipped(dataclasses.replace(cfg, hc=dataclasses.replace(
        cfg.hc, predictor_handoff=True, tile=1)))


_EVAL_VARIANTS = [dict(eval_precision="split3_rk2"),
                  dict(pair_coef_basis="abc"),
                  dict(eval_structure="gathered"),
                  dict(eval_structure="merged")]
_STEP_VARIANTS = [dict(predictor="rk2"), dict(predictor="rk3"),
                  dict(corrector_jacobian_reuse=1),
                  dict(corrector_jacobian_reuse=2),
                  dict(predictor_handoff=True, tile=1),
                  dict(rk_jacobian_reuse=True)]


@pytest.mark.parametrize("knobs", [
    *_STEP_VARIANTS,
    dict(corrector_jacobian_reuse=2, predictor_handoff=True, tile=1),
    dict(corrector_jacobian_reuse=1, predictor="rk3"),
    dict(eval_precision="split3"), dict(eval_precision="highest"),
    *_EVAL_VARIANTS,
    *({**e, **v} for e in _EVAL_VARIANTS for v in _STEP_VARIANTS),
    dict(eval_precision="split3_rk2", pair_coef_basis="abc",
         eval_structure="merged")],
    ids=lambda k: ",".join(f"{a}={v}" for a, v in k.items()))
def test_step_variants_accepted(cfg, knobs):
    """The step variants, alone and in the combinations the JAX kernel
    takes, the evaluation precisions that compute the FP32 function, and
    the evaluation variants, alone and with each step variant."""
    config.check_shipped(dataclasses.replace(
        cfg, hc=dataclasses.replace(cfg.hc, **knobs)))
