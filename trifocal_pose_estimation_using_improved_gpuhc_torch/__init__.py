"""PyTorch/CUDA port of the homotopy-continuation trifocal pose engine.

The JAX package ``trifocal_pose_estimation_using_improved_gpuhc_tpu`` is the
reference; this package computes the same RANSAC round on an NVIDIA GPU.
It imports torch and numpy, never jax: the modules it shares with the
reference (configuration, data IO, host evaluation, the symbolic solve
plan) import no jax either.

Layering (bottom-up):
  csrc/     - the hand-written CUDA path-tracker kernel (hc_track.cu).
  ops/      - evaluators, the kernel's host-side constants and its plain
              PyTorch twin, the kernel binding, RANSAC sampling/scoring.
  models/   - the trifocal 2op1p problem (factored evaluation tables).
  utils/    - the shipped-configuration check and data-root resolution.
"""

__version__ = "0.1.0"

from trifocal_pose_estimation_using_improved_gpuhc_tpu.utils.config import (  # noqa: F401
    EngineConfig,
    HCConfig,
    ProblemConfig,
    RansacConfig,
)


def __getattr__(name):
    # Lazy: the engine pulls in torch; keep the bare package import light.
    if name == "TrifocalPoseEngine":
        from trifocal_pose_estimation_using_improved_gpuhc_torch.engine import (
            TrifocalPoseEngine,
        )

        return TrifocalPoseEngine
    raise AttributeError(name)
