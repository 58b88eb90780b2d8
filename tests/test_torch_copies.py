"""The port's own copies of the JAX package's host modules against the
originals: configuration, data IO, host evaluation and the symbolic solve
plans.  They must agree exactly: field for field, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import reduce as jredu
from trifocal_pose_estimation_using_improved_gpuhc_tpu.ops import (
    schedule as jsched,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
    config as jconfig,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
    data_io as jdata_io,
)
from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils import (
    evaluation as jevl,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import trifocal
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import reduce as redu
from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
    schedule as sched,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    config,
    data_io,
)
from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
    evaluation as evl,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data", "synth_trifocal")


@pytest.mark.parametrize("name", ["ProblemConfig", "HCConfig", "RansacConfig",
                                  "EngineConfig"])
def test_config_fields_and_defaults(name, monkeypatch):
    """Same fields, same defaults; the data root is the repository's own
    generated one (the reference's tree is not part of the repository)."""
    for var in [v for v in os.environ if v.startswith("TPUHC_")]:
        monkeypatch.delenv(var)
    ours = dataclasses.fields(getattr(config, name))
    theirs = dataclasses.fields(getattr(jconfig, name))
    assert [f.name for f in ours] == [f.name for f in theirs]
    a, b = getattr(config, name)(), getattr(jconfig, name)()
    for f in ours:
        if name == "EngineConfig" and f.name == "data_root":
            assert os.path.samefile(a.data_root, DATA)
        elif dataclasses.is_dataclass(getattr(a, f.name)):
            assert (dataclasses.asdict(getattr(a, f.name))
                    == dataclasses.asdict(getattr(b, f.name))), f.name
        else:
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def _patterns():
    """The committed problem's Jacobian pattern and seeded random ones
    (a full diagonal, so that each is structurally solvable)."""
    problem = trifocal.TrifocalProblem.load(config.EngineConfig(data_root=DATA))
    f = problem.factored
    out = [f.hx_scatter.reshape(30, 30) != f.hx_C.shape[1]]
    rng = np.random.default_rng(4)
    for n, density in ((12, 0.2), (20, 0.15), (30, 0.1)):
        p = rng.random((n, n)) < density
        np.fill_diagonal(p, True)
        out.append(p)
    return out


@pytest.fixture(scope="module")
def patterns():
    return _patterns()


def test_schedule_equal_field_for_field(patterns):
    for p in patterns:
        s, js = sched.build_schedule(p), jsched.build_schedule(p)
        assert dataclasses.astuple(s) == dataclasses.astuple(js)
        assert s.update_volume == js.update_volume
        assert np.array_equal(sched.find_interval_row_order(s),
                              jsched.find_interval_row_order(js))


def test_reduction_plan_equal_field_for_field(patterns):
    plans = [(redu.build_reduction(p), jredu.build_reduction(p))
             for p in patterns]
    assert plans[0][0] is not None  # the committed problem condenses
    for ours, theirs in plans:
        assert (ours is None) == (theirs is None)
        if ours is not None:
            assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
            assert ours.num_group_pivots == theirs.num_group_pivots


def test_problem_data_bit_equal():
    cfg = config.EngineConfig(data_root=DATA)
    prob = config.problem_config(cfg)
    kw = dict(num_vars=prob.num_vars, num_tracks=prob.num_tracks,
              hx_terms=prob.hx_max_terms, hx_parts=prob.hx_max_parts,
              ht_terms=prob.ht_max_terms, ht_parts=prob.ht_max_parts)
    a = data_io.load_problem_data(config.problem_dir(cfg), **kw)
    b = jdata_io.load_problem_data(config.problem_dir(cfg), **kw)
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        assert u.dtype == v.dtype and np.array_equal(u, v), f.name


@pytest.mark.parametrize("view_index", [0, 1, 2])
def test_views_bit_equal(view_index):
    d = config.ransac_data_dir(config.EngineConfig(data_root=DATA))
    a = data_io.load_ransac_view(d, view_index)
    b = jdata_io.load_ransac_view(d, view_index)
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        assert u.dtype == v.dtype and np.array_equal(u, v), f.name
    k = data_io.load_intrinsic_matrix(d)
    assert k.dtype == np.float32
    assert np.array_equal(k, jdata_io.load_intrinsic_matrix(d))


def test_measure_pose_error_equal():
    """Seeded random poses (orthonormalised) against view 0's ground
    truth: the same residuals, exactly; the ground truth against itself is
    within the tolerances."""
    d = config.ransac_data_dir(config.EngineConfig(data_root=DATA))
    view = data_io.load_ransac_view(d, 0)
    rng = np.random.default_rng(9)
    for _ in range(8):
        r21, r31 = (np.linalg.qr(rng.standard_normal((3, 3)))[0]
                    .astype(np.float32) for _ in range(2))
        t21, t31 = rng.standard_normal((2, 3)).astype(np.float32)
        args = (r21, r31, t21, t31, view.gt_pose21, view.gt_pose31)
        a, b = evl.measure_pose_error(*args), jevl.measure_pose_error(*args)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    gt = evl.measure_pose_error(view.gt_pose21[:, :3], view.gt_pose31[:, :3],
                                view.gt_pose21[:, 3], view.gt_pose31[:, 3],
                                view.gt_pose21, view.gt_pose31)
    assert gt.within(config.RansacConfig())
    assert evl.SolutionStats(3, 1, 2, 10).pct_converged == 0.3
