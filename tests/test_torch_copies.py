"""The port's own copies of the JAX package's host modules against the
originals: configuration, data IO, host evaluation, the symbolic solve
plans and monodromy's host helpers.  They must agree exactly: field for
field, bit for bit."""

import dataclasses
import os

import numpy as np
import pytest

from trifocal_pose_estimation_using_improved_gpuhc_tpu.models import (
    monodromy as jmonodromy,
)
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
from trifocal_pose_estimation_using_improved_gpuhc_torch.models import (
    monodromy,
    trifocal,
)
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


def _seeded_solutions(rng, n=64, v=30):
    """Seeded solutions, some with imaginary parts below the real-solution
    tolerance, with exact and near duplicates (within 1e-5), and seeded
    flags."""
    x = (rng.standard_normal((n, v)) + 1j * rng.standard_normal((n, v))
         ).astype(np.complex64)
    rows = rng.random(n) < 0.4
    x[rows] = x[rows].real + 1j * np.float32(5e-5)
    for i in rng.choice(n, 12, replace=False):
        x[i] = x[rng.integers(n)] + np.complex64(1e-5)
    return x, rng.random(n) < 0.6, rng.random(n) < 0.1


def test_collect_stats_equal():
    rng = np.random.default_rng(11)
    for _ in range(4):
        x, conv, inf = _seeded_solutions(rng)
        rc = config.RansacConfig()
        a = evl.collect_stats(x, conv, inf, rc)
        b = jevl.collect_stats(x, conv, inf, jconfig.RansacConfig())
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_find_unique_solutions_equal():
    rng = np.random.default_rng(12)
    for _ in range(4):
        x, conv, _ = _seeded_solutions(rng)
        a = evl.find_unique_solutions(x, conv, tol=1e-4)
        b = jevl.find_unique_solutions(x, conv, tol=1e-4)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    none = np.zeros(8, bool)
    assert np.array_equal(evl.find_unique_solutions(x[:8], none),
                          jevl.find_unique_solutions(x[:8], none))


def test_find_unique_solutions_reference_equal():
    """Seeded batches over two RANSAC iterations of num_tracks paths, and a
    batch built to hit the replaced skip set: path 0 has the later
    duplicates 1 and 3 (so it is not counted, and {1, 3} are skipped), path
    2 the duplicate 4, which replaces the skip set by {4}; so path 3, a
    duplicate of path 0, is counted (an accumulated skip set would count
    path 5 alone)."""
    rng = np.random.default_rng(13)
    for _ in range(4):
        x, conv, _ = _seeded_solutions(rng)
        a = evl.find_unique_solutions_reference(x, conv, 24)
        b = jevl.find_unique_solutions_reference(x, conv, 24)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    x = (rng.standard_normal((6, 30))).astype(np.complex64)
    x[1] = x[3] = x[0]
    x[4] = x[2]
    conv = np.ones(6, bool)
    a = evl.find_unique_solutions_reference(x, conv, 6)
    assert np.array_equal(a, jevl.find_unique_solutions_reference(x, conv, 6))
    assert a.tolist() == [3, 5]
    assert evl.find_unique_solutions(x, conv).tolist() == [0, 2, 5]


def _seeded_poses(rng, n):
    r = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0]
                  for _ in range(2 * n)]).astype(np.float32)
    t = rng.standard_normal((2 * n, 3)).astype(np.float32)
    return r[:n], r[n:], t[:n], t[n:]


def test_min_residuals_over_sols_equal():
    """Seeded poses with the ground truth among them (so one is within
    tolerance), without it, and the empty set (residuals 100, False)."""
    d = config.ransac_data_dir(config.EngineConfig(data_root=DATA))
    view = data_io.load_ransac_view(d, 0)
    rng = np.random.default_rng(14)
    r21, r31, t21, t31 = _seeded_poses(rng, 16)
    gt = (view.gt_pose21, view.gt_pose31)
    with_gt = [a.copy() for a in (r21, r31, t21, t31)]
    with_gt[0][5], with_gt[1][5] = gt[0][:, :3], gt[1][:, :3]
    with_gt[2][5], with_gt[3][5] = gt[0][:, 3], gt[1][:, 3]
    cases = [(r21, r31, t21, t31), tuple(with_gt),
             tuple(a[:0] for a in (r21, r31, t21, t31))]
    got = []
    for c in cases:
        a = evl.min_residuals_over_sols(*c, *gt, config.RansacConfig())
        b = jevl.min_residuals_over_sols(*c, *gt, jconfig.RansacConfig())
        assert dataclasses.astuple(a[0]) == dataclasses.astuple(b[0])
        assert a[1] == b[1]
        got.append(a)
    assert got[1][1] and not got[0][1]
    assert got[2] == (evl.PoseErrors(100.0, 100.0, 100.0, 100.0), False)


def test_format_gt_deviation_equal():
    d = config.ransac_data_dir(config.EngineConfig(data_root=DATA))
    view = data_io.load_ransac_view(d, 1)
    rng = np.random.default_rng(15)
    r21, r31, t21, t31 = _seeded_poses(rng, 3)
    for i in range(3):
        args = (r21[i], r31[i], t21[i], t31[i], view.gt_pose21,
                view.gt_pose31)
        assert evl.format_gt_deviation(*args) == jevl.format_gt_deviation(
            *args)


def test_writers_byte_equal(tmp_path):
    """The four output files, written by both packages from the same
    seeded inputs (two RANSAC iterations of 24 tracks), byte for byte."""
    rng = np.random.default_rng(16)
    x, conv, inf = _seeded_solutions(rng, n=48)
    timings = list(rng.random(5) * 300.0) + [27559.09338099991, 1.0]
    stats = [evl.SolutionStats(int(a), int(b), int(c), 48)
             for a, b, c in rng.integers(0, 40, (4, 3))]
    jstats = [jevl.SolutionStats(*dataclasses.astuple(s)) for s in stats]
    steps = rng.integers(0, 81, 7).astype(np.int32)
    for mod, st, sub in ((evl, stats, "port"), (jevl, jstats, "jax")):
        out = tmp_path / sub
        out.mkdir()
        mod.write_timings(str(out / "GPU_Timings.txt"), timings)
        mod.write_sols_statistics(str(out / "GPU_Sols_Statistics.txt"), st)
        mod.write_converged_sols(str(out / "GPU_Converged_HC_tracks.txt"),
                                 x, conv, 24)
        mod.write_hc_steps(str(out / "GPUHC_Steps_of_Actual_Solutions.txt"),
                           steps)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 4
    for name in names:
        a = (tmp_path / "port" / name).read_bytes()
        assert a and a == (tmp_path / "jax" / name).read_bytes(), name


def test_timing_summary_equal():
    rng = np.random.default_rng(17)
    for n in (1, 2, 9):
        t = list(rng.random(n) * 500.0)
        assert evl.timing_summary(t) == jevl.timing_summary(t)


_YAML = """%YAML:1.0
# settings of the trifocal problem, in the reference's format
problem_name: trifocal_2op1p_30x30
Num_Of_Vars: 30
Num_Of_Params: 33
Num_Of_Tracks: 307
dHdx_Max_Terms: 8
dHdx_Max_Parts: 5
dHdt_Max_Terms: 22
dHdt_Max_Parts: 6
Max_Order_Of_T: 2
GPUHC_Max_Steps: 60
GPUHC_Max_Correction_Steps: 3
GPUHC_Num_Of_Steps_to_Increase_Delta_t: 5
Abort_RANSAC_by_Good_Sol: true
RANSAC_Dataset: Synthetic
Num_Of_GPUs: {gpus}
Num_Of_Cores: 12
"""


@pytest.mark.parametrize("gpus", [1, 2])
def test_load_problem_yaml_equal(tmp_path, monkeypatch, gpus):
    """A reference-format file with its %YAML:1.0 line: the same
    configuration field for field (the data root apart, whose default is
    each package's own); Num_Of_GPUs 1 means num_devices None."""
    for var in [v for v in os.environ if v.startswith("TPUHC_")]:
        monkeypatch.delenv(var)
    p = tmp_path / "gpuhc_settings.yaml"
    p.write_text(_YAML.format(gpus=gpus))
    a = config.load_problem_yaml(str(p))
    b = jconfig.load_problem_yaml(str(p))
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.pop("data_root") == config.DEFAULT_DATA_ROOT
    db.pop("data_root")
    assert da == db
    assert a.num_devices == (None if gpus == 1 else 2)
    assert a.hc.max_steps == 60 and a.ransac.abort_by_good_sol
    p.write_text("%YAML:1.0\n")
    assert (dataclasses.asdict(config.load_problem_yaml(str(p)))["hc"]
            == dataclasses.asdict(config.EngineConfig().hc))


def test_num_ransac_views_equal():
    d = config.ransac_data_dir(config.EngineConfig(data_root=DATA))
    assert data_io.num_ransac_views(d) == jdata_io.num_ransac_views(d) == 3


def test_monodromy_dedup_equal():
    """Seeded rows, some repeated within the tolerance, some just outside,
    some far: the same rows are kept in the same order."""
    rng = np.random.default_rng(5)
    sols = (rng.standard_normal((6, 30))
            + 1j * rng.standard_normal((6, 30))).astype(np.complex64)
    new = np.concatenate([
        sols[[1, 4]] + 2e-4, sols[[0]] + 5e-3,
        (3 * rng.standard_normal((4, 30))).astype(np.complex64),
        sols[[2]]]).astype(np.complex64)
    new = np.concatenate([new, new[5:7]])   # duplicates among the new rows
    for start in (sols, sols[:0]):
        ours = monodromy._dedup(start, new, 1e-3)
        theirs = jmonodromy._dedup(start, new, 1e-3)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
        assert len(sols[:0]) < len(ours) < len(start) + len(new)


def test_write_start_system_byte_equal(tmp_path):
    p = trifocal.TrifocalProblem.load(config.EngineConfig(data_root=DATA))
    res = monodromy.MonodromyResult(
        params=np.asarray(p.start_params),
        solutions=np.asarray(p.start_sols)[:7], loops_run=2, history=[7, 7])
    jres = jmonodromy.MonodromyResult(**dataclasses.asdict(res))
    for mod, r, d in ((monodromy, res, "ours"), (jmonodromy, jres, "jax")):
        (tmp_path / d).mkdir()
        mod.write_start_system(str(tmp_path / d / "start_params.txt"),
                               str(tmp_path / d / "start_sols.txt"), r)
    for name in ("start_params.txt", "start_sols.txt"):
        assert ((tmp_path / "ours" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
