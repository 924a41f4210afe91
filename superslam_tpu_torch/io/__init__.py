from .trajectory import (
    load_trajectory_kitti,
    load_trajectory_tum,
    save_map_ply,
    save_trajectory_kitti,
    save_trajectory_tum,
)
from .undistort import RectifyMap, undistort_points

__all__ = [
    "load_trajectory_kitti",
    "load_trajectory_tum",
    "save_map_ply",
    "save_trajectory_kitti",
    "save_trajectory_tum",
    "RectifyMap",
    "undistort_points",
]
