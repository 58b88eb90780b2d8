"""What the port's measurement tools (``tools/*_torch.py``) share: the
``--platform`` and ``--data-root`` arguments, the device they name, the
card's line, and the real-count and quantile summaries of tracked paths.

A tool runs on ``cuda:0`` unless it is given ``--platform cpu`` (the plain
twins there), and without a card it says so and exits 2: it never falls
back to the CPU by itself.  Its data is the generated root
``data/synth_trifocal`` unless ``--data-root`` names another.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (
    DEFAULT_DATA_ROOT,
)


# The imaginary-part tolerances of the real-count sweep; the reference's
# real count uses 1e-4 (RansacConfig.zero_imag_part_tol).
TOLS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2)


def real_counts(x: np.ndarray, conv: np.ndarray, tols=TOLS) -> dict:
    """{tol: converged paths whose every |imag(x_v)| <= tol}."""
    mi = np.abs(x.imag).max(axis=-1)
    return {t: int((conv & (mi <= t)).sum()) for t in tols}


def quantiles(v, ps=(10, 50, 90, 99)) -> dict:
    """{p: the p-th percentile of the finite values of v}, {} if none."""
    v = np.asarray(v, dtype=np.float64)
    v = v[np.isfinite(v)]
    return {p: float(np.percentile(v, p)) for p in ps} if v.size else {}


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu: cuda:0 (the default); cpu: the plain twins")
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)


def device(platform: str, tool: str) -> Optional[torch.device]:
    """cuda:0 for "gpu", the CPU for "cpu"; None (said on stderr) when
    "gpu" finds no card."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; pass --platform cpu to run on the "
              f"CPU", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's mark: every figure a tool prints is that device's."""
    if dev.type != "cuda":
        return "device: cpu (plain twins; no device metric)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()
    return f"device: {dev} {smi[dev.index or 0]}"


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
