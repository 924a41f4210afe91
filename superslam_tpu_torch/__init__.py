"""superslam_tpu_torch — the PyTorch/CUDA port of superslam_tpu.

The JAX package ``superslam_tpu`` is the reference and stays as it is; this
package mirrors its layout and module names so each counterpart is easy to
find, imports ``torch`` and never ``jax``, and imports nothing of
``superslam_tpu`` (it keeps its own copies of the numpy-only host modules).
Every TPU kernel on its path is a hand-written Hopper kernel under
``ops/cuda/``; entry points run on CUDA unless the caller passes
``device="cpu"``.

Layering (bottom-up):
  geometry/  SE(3) + stereo camera (host numpy)
  ops/       the fused per-frame step, precision control, CUDA kernels
  models/    SuperPoint / LightGlue / EigenPlaces as functions on tensors
  frontend/  extractor, matcher and recognizer backends, the fused stereo
             and RGB-D pipelines and their pipelined trackers
  core/      device-free estimation core (tracker, smoother, pose graph)
  parallel/  multi-sequence batched tracking, the device mesh, the
             matcher's training step
  io/, eval/ trajectory writers, ATE/RPE metrics, rendered sequences
  slam.py    the SuperSLAM facade (stereo and RGB-D, loop closure)
"""

__version__ = "0.1.0"

from .core import VoEstimator  # noqa: F401
from .geometry import Pose3, StereoCalib  # noqa: F401


def __getattr__(name):
    # Lazy: `from superslam_tpu_torch import SuperSLAM` without importing
    # torch on import of the device-free core.
    if name == "SuperSLAM":
        from .slam import SuperSLAM

        return SuperSLAM
    raise AttributeError(name)
