#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 hcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; everything else is found by name under ``hcbench/``:
the configuration ``configs/<config>.json`` (``EngineConfig`` overrides),
the traffic mix ``traffic/<traffic>.json`` (read by ``views.make_pool``
and by the driver ``drivers/<driver>.py`` it names), the limits of the
correctness check ``limits/<cell>.json`` and each metric's reader
``metrics/<metric>.py``.

A run builds the port's ``TrifocalPoseEngine`` on ``cuda:0``, makes the
cell's pool of views from ``--seed``, warms up one round of the cell's own
shape (all of that is ``setup_s``), then drives ``run_round`` for
``--seconds``.  With ``--trace 1`` the window's first seconds run under
``torch.profiler`` (``trace.Session``) and the per-layer metrics are
reported in place of the end-to-end ones.
After the window: the check that no module of JAX or the JAX package was
loaded; the device's memory peak; every request's pose held to the view's
ground truth (``failed``: no pose, or one outside the configuration's
residual tolerances); then, the program's state freed, one request drawn
from the seed is recomputed by the plain reference (``reference.py``) and
compared path by path and pose by pose (``correct``).  The compared numbers
and their limits are the last lines on standard error and the last key of
the result, which is the last line on standard output.  Exits nonzero,
with no result, without a card, and if a forbidden module was loaded.
"""

import time

_T0 = time.perf_counter()  # process start, for setup_s

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax",
             "trifocal_pose_estimation_using_improved_gpuhc_tpu")
NO_POSE = 100.0  # a request without a pose reads this residual


def forbidden_modules(names) -> list:
    """The names whose top-level module (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """The module in a file of the benchmark, found by its name."""
    name = "hcbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> dict:
    """A cell of BENCHMARK.json and the files it names."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return dict(
        workload=w,
        config=load_json(os.path.join(ROOT, config["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       f"{w['traffic']}.json")),
        limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def build(default, over: dict):
    """``default`` (a dataclass) with the values of ``over``, nested
    dataclasses from nested objects; an unknown key raises."""
    kw = {}
    for k, v in over.items():
        cur = getattr(default, k)
        kw[k] = build(cur, v) if dataclasses.is_dataclass(cur) else v
    return dataclasses.replace(default, **kw)


def engine_config(config_module, over: dict):
    """The EngineConfig of a configuration file's ``engine`` overrides, its
    data root taken from the checkout's root."""
    over = dict(over)
    if not os.path.isabs(over.get("data_root", "/")):
        over["data_root"] = os.path.join(ROOT, over["data_root"])
    return build(config_module.EngineConfig(), over)


@dataclasses.dataclass
class Request:
    """One request of the window, as the client saw it."""

    index: int
    view: int               # pool index
    sample_seed: int
    latency_ms: float       # handed over -> pose on the host
    error: Optional[str] = None
    track_ms: float = 0.0
    total_ms: float = 0.0
    chunks_run: int = 0
    best_pose: Optional[tuple] = None
    converged: Optional[np.ndarray] = None
    inf_fail: Optional[np.ndarray] = None
    pruned: Optional[np.ndarray] = None
    num_steps: Optional[np.ndarray] = None


@dataclasses.dataclass
class RunRecord:
    """What the metrics' readers read (``metrics/<name>.py``:
    ``read(run) -> float or None``)."""

    setup_s: float
    window_s: float
    requests: list
    failed: int
    launches: int            # hc_track launches in the window
    trace: object = None     # trace.Trace of a --trace 1 run
    checked: int = -1        # the request the reference recomputed
    bound_ms: Optional[float] = None  # its tracking's bound (--trace 1)


def pose_gap(a, b) -> float:
    """The largest entry of the difference of two poses (R21, R31, t21,
    t31), the translations as unit vectors, in float64; NO_POSE where one
    of them has no pose."""
    if a is None or b is None:
        return 0.0 if a is None and b is None else NO_POSE
    gap = 0.0
    for i, (p, q) in enumerate(zip(a, b)):
        p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
        if i >= 2:
            p, q = p / np.linalg.norm(p), q / np.linalg.norm(q)
        gap = max(gap, float(np.abs(p - q).max()))
    return gap


def residuals(best_pose, view) -> tuple:
    """(rotation, translation) residual of a pose against the view's ground
    truth, the worse of the two view pairs: the angle of R_gt^T R, and
    |<t_gt/|t_gt|, t/|t|> - 1|, in float64."""
    if best_pose is None:
        return NO_POSE, NO_POSE
    r21, r31, t21, t31 = (np.asarray(p, np.float64) for p in best_pose)
    rot = tr = 0.0
    for r, t, (rg, tg) in ((r21, t21, view.pose21), (r31, t31, view.pose31)):
        c = np.clip((np.trace(rg.T @ r) - 1.0) / 2.0, -1.0, 1.0)
        rot = max(rot, float(np.arccos(c)))
        tr = max(tr, abs(float(t @ tg / (np.linalg.norm(t)
                                         * np.linalg.norm(tg))) - 1.0))
    return rot, tr


def merged(over: dict, more: dict) -> dict:
    """Nested overrides ``over`` with ``more`` laid on top."""
    out = dict(over)
    for k, v in more.items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda:0", t0: float = _T0,
             program: Optional[dict] = None) -> tuple:
    """One run of a cell: (result dict, compared numbers).  ``device`` is
    the card, or "cpu" for a rehearsal on the CPU; ``program`` overrides
    the configuration of the program alone, not the reference's (the
    control)."""
    import torch

    from hcbench import reference, views
    from hcbench import trace as tracing
    from hcbench.plain import config as plain_config
    from hcbench.plain.data_io import load_intrinsic_matrix
    from trifocal_pose_estimation_using_improved_gpuhc_torch import engine
    from trifocal_pose_estimation_using_improved_gpuhc_torch.ops import (
        _kernels,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config as port_config,
    )
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.data_io import (
        RansacView,
    )

    over = cell["config"]["engine"]
    cfg = engine_config(port_config, merged(over, program or {}))
    plain_cfg = engine_config(plain_config, over)
    rc = plain_cfg.ransac
    traffic = cell["traffic"]
    k_mat = load_intrinsic_matrix(plain_config.ransac_data_dir(plain_cfg))
    pool = views.make_pool(traffic, seed, k_mat.astype(np.float64))
    eng = engine.TrifocalPoseEngine(cfg, device=device)

    def gt(pose):
        return np.concatenate([pose[0], pose[1][:, None]],
                              axis=1).astype(np.float32)

    handed = [RansacView(v.edge_locations, v.edge_tangents, gt(v.pose21),
                         gt(v.pose31)) for v in pool]
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    eng.run_round(handed[0], views.request_seed(seed, 0, views.WARMUP_STREAM))
    sync()
    setup_s = time.perf_counter() - t0

    def serve(i, view_index, sample_seed):
        view = handed[view_index]
        a = time.perf_counter()
        try:
            rr = eng.run_round(view, sample_seed)
        except Exception:  # a failed request; the loop goes on
            return Request(i, view_index, sample_seed,
                           (time.perf_counter() - a) * 1e3,
                           error=traceback.format_exc())
        lat = (time.perf_counter() - a) * 1e3
        return Request(i, view_index, sample_seed, lat, None, rr.track_ms,
                       rr.total_ms, rr.chunks_run, rr.best_pose,
                       rr.converged, rr.inf_fail, rr.pruned, rr.num_steps)

    driver = load_module(os.path.join(HERE, "drivers",
                                      f"{traffic['driver']}.py"))
    indices = list(range(len(pool)))
    launches0 = _kernels.hc_track.launches
    session = tracing.Session(cuda, sync) if trace else None
    requests, window_s = driver.drive(
        serve, indices, seed, seconds, traffic,
        session.annotate if trace else lambda i: contextlib.nullcontext())
    launches = _kernels.hc_track.launches - launches0
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules(sys.modules)
    if found:
        raise ForbiddenModules(found)
    if trace:
        session.stop()
    traced = tracing.read(session) if trace else None

    # The program's state goes before the reference runs on the device.
    del eng, session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    errors = [r.error for r in requests if r.error]
    if errors:
        print(f"hcbench: {len(errors)} requests raised; the first:\n"
              f"{errors[0]}", file=sys.stderr)
    rot = tr = 0.0
    failed = 0
    for r in requests:
        r_rot, r_tr = residuals(r.best_pose, pool[r.view])
        rot, tr = max(rot, r_rot), max(tr, r_tr)
        failed += bool(r.error or r.best_pose is None
                       or r_rot > rc.rot_residual_tol
                       or r_tr > rc.transl_residual_tol)
    # The reference recomputes a request drawn from the seed (a traced one
    # in a traced run, so that its kernel time is known for the roofline).
    checked = int(views.rng_for(seed, views.CHECK_STREAM).integers(
        traced.requests if trace else len(requests)))
    req = requests[checked]
    t_ref = time.perf_counter()
    plain = reference.PlainRound(plain_cfg, device)
    work = {} if trace else None
    view = pool[req.view]
    ref, n_paths = plain.run(view.edge_locations, view.edge_tangents,
                             req.sample_seed, work)
    print(f"hcbench: setup {setup_s:.3f} s, window {window_s:.3f} s, "
          f"{len(requests)} requests ({failed} failed; worst residual to "
          f"the ground truth {rot!r} rad, {tr!r}), reference of request "
          f"{checked} {time.perf_counter() - t_ref:.3f} s ({ref.chunks_run} "
          f"chunks, {n_paths} paths)", file=sys.stderr)
    limits = cell["limits"]
    numbers = {
        "paths_differ": (reference.paths_differ(req, ref)
                         if req.error is None else 1.0,
                         limits["paths_differ"]),
        "pose_differ": (pose_gap(req.best_pose, ref.best_pose)
                        if req.error is None else NO_POSE,
                        limits["pose_differ"]),
    }
    correct = not errors and all(v <= lim for v, lim in numbers.values())

    run = RunRecord(setup_s=setup_s, window_s=window_s, requests=requests,
                    failed=failed, launches=launches, trace=traced,
                    checked=checked,
                    bound_ms=(reference.bound_ms(plain, work, n_paths)
                              if trace else None))
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = load_module(os.path.join(HERE, "metrics",
                                         f"{m['name']}.py")).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result, numbers


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hcbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result, numbers = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace))
    except ForbiddenModules as e:
        print(f"hcbench: forbidden modules loaded: {', '.join(e.args[0])}",
              file=sys.stderr)
        return 3
    for k, (v, lim) in numbers.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
