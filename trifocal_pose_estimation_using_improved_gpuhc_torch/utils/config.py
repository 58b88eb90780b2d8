"""Configuration for the port: the reference's dataclasses plus two checks.

The dataclasses are the JAX package's own (``utils/config.py`` there imports
no jax).  The port implements only the shipped configuration, so
``check_shipped`` rejects every other value of the knobs that change what
the tracker computes.  ``problem_config`` reads the table dimensions a
data root declares in ``problem.json`` (written by
``tools/make_synth_data.py``), since generated tables need not have the
reference's term counts.
"""

from __future__ import annotations

import dataclasses
import json
import os

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (  # noqa: F401
    EngineConfig,
    HCConfig,
    ProblemConfig,
    RansacConfig,
    problem_dir,
    ransac_data_dir,
)

# Knob -> the one value the port implements (the reference's defaults).
_SHIPPED_HC = {
    "solver": "reduced",
    "pair_coef_basis": "efg",
    "predictor": "rk4",
    "eval_structure": "classic",
    "rk_jacobian_reuse": False,
    "corrector_jacobian_reuse": 0,
    "predictor_handoff": False,
    "truncate_paths": True,
}
_SHIPPED_RANSAC = {"abort_by_good_sol": False}


def check_shipped(cfg: EngineConfig) -> None:
    """Raise ValueError unless every semantic knob has its shipped value."""
    for section, shipped in (("hc", _SHIPPED_HC), ("ransac", _SHIPPED_RANSAC)):
        sub = getattr(cfg, section)
        for name, want in shipped.items():
            got = getattr(sub, name)
            if got != want:
                raise ValueError(
                    f"{section}.{name}={got!r} is not supported by the torch "
                    f"port (only the shipped value {want!r} is)"
                )


def resolve_data_root(cfg: EngineConfig, verbose: bool = True) -> EngineConfig:
    """Absolute data root; prints which one was resolved."""
    root = os.path.abspath(cfg.data_root)
    if verbose:
        print(f"data root: {root}", flush=True)
    return dataclasses.replace(cfg, data_root=root)


def problem_config(cfg: EngineConfig) -> ProblemConfig:
    """cfg.problem, with the dimensions the data root's problem.json
    declares (if it has one) taking precedence."""
    path = os.path.join(problem_dir(cfg), "problem.json")
    if not os.path.exists(path):
        return cfg.problem
    with open(path) as f:
        dims = json.load(f)
    fields = {f.name for f in dataclasses.fields(ProblemConfig)}
    return dataclasses.replace(
        cfg.problem, **{k: v for k, v in dims.items() if k in fields}
    )
