"""BENCHMARK.json against its contract, and every cell, traffic mix and
metric found by name: a new traffic file and cell are taken with no edit
to a file that is there."""

import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run  # noqa: E402

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    assert len(names) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        per = [m for m in BENCH["per_layer"] if run.applies(m, cell)]
        assert per and any(m["name"] != "setup_s"
                           for m in BENCH["end_to_end"]
                           if run.applies(m, cell))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = run.load_cell(cell, BENCH)
    assert c["traffic"]["driver"]
    assert os.path.exists(os.path.join(ROOT, "hcbench", "drivers",
                                       c["traffic"]["driver"] + ".py"))
    assert set(c["limits"]) == {"paths_differ", "pose_differ"}
    for m in c["end_to_end"] + c["per_layer"]:
        mod = run.load_module(os.path.join(ROOT, "hcbench", "metrics",
                                           m["name"] + ".py"))
        assert callable(mod.read)
    # Every key the configuration changes is a field of the engine's
    # configuration, in the program and in the frozen copy alike.
    from hcbench.plain import config as plain_config
    from trifocal_pose_estimation_using_improved_gpuhc_torch.utils import (
        config as port_config,
    )

    over = c["config"]["engine"]
    assert run.engine_config(plain_config, over).ransac.num_iterations \
        == run.engine_config(port_config, over).ransac.num_iterations
    entry = {x["name"]: x for x in BENCH["configs"]}[c["workload"]["config"]]
    assert c["config"]["reduced"] == entry["reduced"]
    # The root count listed under ``reduced`` is the committed problem's.
    from hcbench.plain import trifocal

    problem = trifocal.TrifocalProblem.load(
        run.engine_config(plain_config, over))
    assert problem.num_tracks == c["config"]["start_system_roots"]
    assert c["config"]["source"] == entry["source"]


def test_unknown_configuration_key_raises():
    from hcbench.plain import config as plain_config

    with pytest.raises(AttributeError):
        run.engine_config(plain_config, {"hc": {"no_such_knob": 1}})


def test_new_files_are_taken_without_edits(tmp_path):
    """A copy of the benchmark gains a traffic file, a limits file and a
    cell in its BENCHMARK.json, and nothing else: its run.py finds them."""
    shutil.copytree(os.path.join(ROOT, "hcbench"), tmp_path / "hcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in (tmp_path / "hcbench").rglob(
        "*") if p.is_file()}
    traffic = dict(json.load(open(os.path.join(
        ROOT, "hcbench", "traffic", "clean.json"))))
    traffic.update(mismatch_share=0.09, pool_views=2, edgels_per_view=300,
                   why="9% mismatched")
    (tmp_path / "hcbench" / "traffic" / "outliers10.json").write_text(
        json.dumps(traffic))
    (tmp_path / "hcbench" / "limits" / "trunransac.outliers10.json"
     ).write_text(json.dumps({"paths_differ": 0.0}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "trunransac.outliers10",
                               "config": "trunransac",
                               "traffic": "outliers10", "chips": 1,
                               "why": "the abort at its edge"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    copy = run.load_module(str(tmp_path / "hcbench" / "run.py"))
    assert copy.ROOT == str(tmp_path)
    cell = copy.load_cell("trunransac.outliers10")
    assert cell["traffic"]["mismatch_share"] == 0.09
    assert [m["name"] for m in cell["per_layer"]] == [
        m["name"] for m in BENCH["per_layer"] if "workloads" not in m]
    from hcbench import views

    pool = views.make_pool(cell["traffic"], 5, np.eye(3) * [100, 100, 1]
                           + [[0, 0, 250], [0, 0, 280], [0, 0, 0]])
    assert len(pool) == 2 and int(pool[0].mismatched.sum()) == 27
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
