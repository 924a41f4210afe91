from .metrics import (
    AteResult,
    RpeResult,
    ate,
    kitti_segment_errors,
    rpe,
    umeyama_alignment,
)

__all__ = [
    "AteResult",
    "RpeResult",
    "ate",
    "kitti_segment_errors",
    "rpe",
    "umeyama_alignment",
]
