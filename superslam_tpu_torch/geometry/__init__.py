from .se3 import Pose3, skew, so3_expmap, so3_logmap
from .stereo_camera import (
    CheiralityError,
    StereoCalib,
    mono_project_jacobian,
    stereo_project,
    stereo_project_jacobian,
    stereo_project_point_jacobian,
)

__all__ = [
    "Pose3",
    "skew",
    "so3_expmap",
    "so3_logmap",
    "CheiralityError",
    "StereoCalib",
    "stereo_project",
    "stereo_project_jacobian",
    "stereo_project_point_jacobian",
    "mono_project_jacobian",
]
