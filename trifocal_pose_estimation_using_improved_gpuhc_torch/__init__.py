"""PyTorch/CUDA port of the homotopy-continuation trifocal pose engine.

The JAX package ``trifocal_pose_estimation_using_improved_gpuhc_tpu`` is the
reference; this package computes the same RANSAC round on an NVIDIA GPU.
It imports torch and numpy, never jax and nothing of the JAX package: the
host modules it needs from there (configuration, data IO, host
evaluation, the symbolic solve plans) are its own copies.

Layering (bottom-up):
  csrc/     - the hand-written CUDA path-tracker kernel (hc_track.cu).
  ops/      - the symbolic solve plans (schedule, reduce), evaluators, the
              kernel's host-side constants and its plain PyTorch twin, the
              kernel binding, the segment loop, RANSAC sampling/scoring.
  models/   - the trifocal 2op1p problem (factored evaluation tables).
  utils/    - configuration, data IO, host evaluation.
"""

__version__ = "0.2.0"

from trifocal_pose_estimation_using_improved_gpuhc_torch.utils.config import (  # noqa: F401
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
