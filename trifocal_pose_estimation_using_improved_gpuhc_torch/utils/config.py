"""Configuration for the port: the reference's dataclasses plus two checks.

``ProblemConfig``, ``HCConfig``, ``RansacConfig`` and ``EngineConfig`` have
the JAX package's fields and defaults (its ``utils/config.py``), without
the environment overrides its TPU measurement campaigns read.  One default
differs: ``EngineConfig.data_root`` is this repository's generated data
root ``data/synth_trifocal``, since the reference's data tree is not part
of the repository.  The field comments say what each knob does; the JAX
package's module holds the history behind each default.

The port implements the configurations ``check_shipped`` accepts and
rejects every other value of the knobs that change what the tracker
computes.  ``problem_config`` reads the table dimensions a data root
declares in ``problem.json`` (written by ``tools/make_synth_data.py``),
since generated tables need not have the reference's term counts.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

DEFAULT_DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "synth_trifocal")


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    """Static problem dimensions."""

    name: str = "trifocal_2op1p_30x30"
    num_vars: int = 30
    num_params: int = 33
    num_tracks: int = 312
    hx_max_terms: int = 8
    hx_max_parts: int = 5
    ht_max_terms: int = 16
    ht_max_parts: int = 6
    max_order_of_t: int = 2
    num_coeffs_from_params: int = 37  # used by the P2C ablation variant


@dataclasses.dataclass(frozen=True)
class HCConfig:
    """Path-tracker hyper-parameters."""

    max_steps: int = 80                 # HC step budget (the tracker runs +1)
    max_correction_steps: int = 3       # Newton iterations per step
    steps_to_increase_delta_t: int = 4  # successes before dt doubles
    init_delta_t: float = 0.01
    end_zone_factor: float = 0.0500001  # end-zone radius around t = 1
    t_converged_eps: float = 1e-7       # converged when 1 - t <= eps
    corrector_tol_sq: float = 1e-6      # ||dx||^2 < tol ||x||^2: success
    infinity_norm_sq: float = 1e14      # ||x||^2 above: diverged
    truncate_paths: bool = True         # TrunPaths depth-sign pruning
    # Track in segments of segment_steps steps and pack the surviving
    # paths to the front between segments.  Scheduling only: flags, step
    # counts and solutions are those of one call over the whole budget.
    compact_survivors: bool = True
    segment_steps: int = 8
    rk_jacobian_reuse: bool = False     # frozen-Jacobian RK stages
    predictor: str = "rk4"              # "rk4" | "rk3" | "rk2"
    corrector_jacobian_reuse: int = 0   # modified-Newton iterations (0: off)
    predictor_handoff: bool = False     # corrector -> predictor handoff
    eval_precision: str = "split3k"     # the TPU's bf16-split matmul mode
    pair_coef_basis: str = "efg"        # "efg" | "abc"
    eval_structure: str = "classic"     # "classic" | "gathered" | "merged"
    backend: str = "fused"              # "fused" | "xla" | "p2c"
    # The 30x30 solve: "reduced" = the condensed group elimination
    # (ops/reduce.py), "schedule" = the 30-step static schedule
    # (ops/schedule.py); same pivots, different programs.
    solver: str = "reduced"
    # The TPU kernel's paths per tile: tile consecutive batch positions.
    # Only predictor_handoff depends on it (the handoff is decided once per
    # tile); every other knob computes the same per path at any tile.
    tile: int = 128


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC loop settings."""

    num_iterations: int = 100            # hypotheses per round
    imag_part_tol: float = 1e-5          # pose components' imaginary gate
    rot_residual_tol: float = 1e-1
    transl_residual_tol: float = 1e-1
    reproj_inlier_thresh_px: float = 2.0
    pass_inlier_support_ratio: float = 0.90
    # TrunRANSAC: track hypotheses in chunks of abort_chunk and stop at the
    # first chunk that finds a pose with pass_inlier_support_ratio support.
    abort_by_good_sol: bool = False
    abort_chunk: int = 12
    stream_abort_chunk: int = 10         # the same, in the stream pipeline
    feed_random_seed: bool = False
    test_ransac_times: int = 1
    dataset: str = "Synthetic"
    zero_imag_part_tol: float = 1e-4     # real-solution count
    duplicate_sol_tol: float = 1e-4      # unique-solution dedup


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    problem: ProblemConfig = ProblemConfig()
    hc: HCConfig = HCConfig()
    ransac: RansacConfig = RansacConfig()
    data_root: str = DEFAULT_DATA_ROOT
    output_dir: str = "Output_Write_Files"
    num_devices: Optional[int] = None  # None = all visible devices
    num_cpu_cores: Optional[int] = None


def problem_dir(cfg: EngineConfig) -> str:
    return os.path.join(cfg.data_root, "problems", cfg.problem.name)


def ransac_data_dir(cfg: EngineConfig) -> str:
    return os.path.join(
        cfg.data_root, "RANSAC_Data", cfg.problem.name, cfg.ransac.dataset
    )


# Knob -> the values the port implements (the first is the default).  The
# tracker's knobs, which pick the function the kernel computes:
_TRACKER_HC = {
    "solver": ("reduced", "schedule"),
    # "abc": P(t) = (A t + B) t + C, with its known floor under the
    # imaginary residues, reproduced (the JAX package's round-4 note).
    "pair_coef_basis": ("efg", "abc"),
    "predictor": ("rk4", "rk3", "rk2"),
    # On the TPU, "gathered" and "merged" are other matmul forms of the
    # classic evaluation's function: the port's one evaluation is each.
    "eval_structure": ("classic", "gathered", "merged"),
    "rk_jacobian_reuse": (False, True),
    "corrector_jacobian_reuse": (0, 1, 2),
    "predictor_handoff": (False, True),
    # On the TPU split3k, split3 and highest are matmul modes that all
    # compute the FP32 evaluation (exact 3-term bf16 splits, or HIGHEST):
    # the port's FP32 evaluation is each of them.  "split3_rk2" evaluates
    # the RK stages with 2-term splits (about 16 significant bits).
    "eval_precision": ("split3k", "split3", "highest", "split3_rk2"),
}
# ... and the engine's.
_ENGINE_HC = {
    # False: TrunPaths off (the ablation ladder's first two rungs).
    "truncate_paths": (True, False),
    # "fused": the kernel's tracker; "xla": the full-pivot oracle
    # (ops/tracker.py); "p2c": the kernel on the P2C coefficient plan
    # (ops/p2c.py).
    "backend": ("fused", "xla", "p2c"),
}
_SHIPPED_RANSAC = {"abort_by_good_sol": (False, True)}


def _check_values(section: str, sub, shipped: dict) -> None:
    for name, allowed in shipped.items():
        got = getattr(sub, name)
        if got not in allowed:
            raise ValueError(
                f"{section}.{name}={got!r} is not supported by the torch "
                f"port (only {', '.join(map(repr, allowed))})"
            )


def check_hc(hc: HCConfig) -> None:
    """Raise ValueError unless every tracker knob has a value the port
    implements, in a combination the port computes as the JAX kernel
    does.  The trackers and the kernel's variant key call it."""
    _check_values("hc", hc, _TRACKER_HC)
    if hc.predictor_handoff and hc.rk_jacobian_reuse:
        # Both replay one saved factorization at RK stage 1 or after it;
        # the JAX kernel refuses the pair (ops/fused.py there).
        raise ValueError("hc.predictor_handoff and hc.rk_jacobian_reuse "
                         "cannot be combined")
    if hc.tile < 1:
        raise ValueError(f"hc.tile={hc.tile} is not a number of paths: "
                         f"a tile holds at least one")


def check_shipped(cfg: EngineConfig) -> None:
    """Raise ValueError unless the engine runs this configuration as the
    JAX package does: ``check_hc``, and the engine's own knobs (backend
    "fused", "xla" or "p2c", TrunPaths on or off, the abort on or off, and
    any ``num_devices``: None and values up to 1 are one shard, more shard
    the hypotheses, but not with backend "p2c")."""
    check_hc(cfg.hc)
    _check_values("hc", cfg.hc, _ENGINE_HC)
    _check_values("ransac", cfg.ransac, _SHIPPED_RANSAC)
    if (cfg.num_devices or 1) > 1 and cfg.hc.backend == "p2c":
        # The JAX engine's sharded branch comes before its P2C branch, so
        # there num_devices > 1 with P2C quietly tracks with the oracle
        # (engine.py:97-128); the port copies no silent swap.
        raise ValueError(f"num_devices={cfg.num_devices!r} with hc.backend="
                         f"'p2c' is not supported by the torch port: the "
                         f"JAX engine would track with its oracle instead")


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


def config_for_data_root(data_root: Optional[str] = None,
                         problem: str = "trifocal_2op1p_30x30"
                         ) -> EngineConfig:
    """The command lines' configuration: the problem folder's
    reference-format YAML when it has one, else the defaults with the
    table dimensions of the data root's problem.json (generated tables need
    not have the reference's term counts).  data_root None is
    DEFAULT_DATA_ROOT."""
    root = data_root or DEFAULT_DATA_ROOT
    yaml_path = os.path.join(root, "problems", problem, "gpuhc_settings.yaml")
    if os.path.exists(yaml_path):
        return dataclasses.replace(load_problem_yaml(yaml_path),
                                   data_root=root)
    cfg = EngineConfig(problem=ProblemConfig(name=problem), data_root=root)
    return dataclasses.replace(cfg, problem=problem_config(cfg))


def load_problem_yaml(path: str) -> EngineConfig:
    """A reference-format gpuhc_settings.yaml as an EngineConfig: the
    reference's key set, with its defaults for absent keys.  Parsed with
    PyYAML (on the GPU host too), after dropping the OpenCV-style
    ``%YAML:1.0`` directive, which PyYAML rejects."""
    import yaml

    with open(path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines() if not ln.startswith("%")]
    doc = yaml.safe_load("\n".join(lines)) or {}

    prob = ProblemConfig(
        name=doc.get("problem_name", "trifocal_2op1p_30x30"),
        num_vars=int(doc.get("Num_Of_Vars", 30)),
        num_params=int(doc.get("Num_Of_Params", 33)),
        num_tracks=int(doc.get("Num_Of_Tracks", 312)),
        hx_max_terms=int(doc.get("dHdx_Max_Terms", 8)),
        hx_max_parts=int(doc.get("dHdx_Max_Parts", 5)),
        ht_max_terms=int(doc.get("dHdt_Max_Terms", 16)),
        ht_max_parts=int(doc.get("dHdt_Max_Parts", 6)),
        max_order_of_t=int(doc.get("Max_Order_Of_T", 2)),
        num_coeffs_from_params=int(doc.get("Num_Of_Coeffs_From_Params", 37)),
    )
    hc = HCConfig(
        max_steps=int(doc.get("GPUHC_Max_Steps", 80)),
        max_correction_steps=int(doc.get("GPUHC_Max_Correction_Steps", 3)),
        steps_to_increase_delta_t=int(
            doc.get("GPUHC_Num_Of_Steps_to_Increase_Delta_t", 4)
        ),
    )
    ransac = RansacConfig(
        abort_by_good_sol=bool(doc.get("Abort_RANSAC_by_Good_Sol", False)),
        dataset=str(doc.get("RANSAC_Dataset", "Synthetic")),
    )
    # Num_Of_GPUs is the hypothesis sharding's device count; 1 is one card.
    ndev = int(doc.get("Num_Of_GPUs", 1))
    cores = doc.get("Num_Of_Cores")
    return EngineConfig(
        problem=prob, hc=hc, ransac=ransac,
        num_devices=ndev if ndev > 1 else None,
        num_cpu_cores=int(cores) if cores is not None else None,
    )
