"""The control of the correctness check, on the card at each cell's own size:
the program's own lower-precision path (``eval_precision="split3_rk2"``,
the RK stages' evaluations at 2-term bfloat16 splits, about 16 significant
bits) in the program's configuration, against the reference at the cell's
own precision, must come out not correct.

    python -m pytest -p no:cacheprovider -m gpu -s hcbench/tests/test_control.py

Each run is ``run.run_cell`` with a two-second window, as a run compares
one request; the compared numbers are printed (the upper readings in
PERF.md).  Skips without a card.
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from hcbench import run  # noqa: E402

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_is_not_correct(card, name):
    for seed in SEEDS:
        result, numbers = run.run_cell(
            run.load_cell(name), seed, 2.0, False,
            program={"hc": {"eval_precision": "split3_rk2"}})
        print(f"control {name} seed {seed}: "
              + ", ".join(f"{k} {v!r} (limit {lim!r})"
                          for k, (v, lim) in numbers.items()), flush=True)
        assert not result["correct"]
