"""Output-only sparse point-cloud map (``src/SparseMap.cc``).

Holds each keyframe's depth-valid feature points in the keyframe camera
frame; ``cloud()`` lifts them to world using the (loop-corrected) keyframe
anchors. Not used for tracking.
"""

from __future__ import annotations

import numpy as np

from ..geometry.se3 import Pose3


class SparseMap:
    def __init__(self) -> None:
        self._points: dict[int, np.ndarray] = {}

    def add_keyframe(self, keyframe_id: int, camera_points: np.ndarray) -> None:
        self._points[keyframe_id] = np.asarray(camera_points, dtype=np.float64).reshape(
            -1, 3
        )

    def cloud(self, anchors: dict[int, Pose3]) -> np.ndarray:
        out = []
        for keyframe_id, pts in self._points.items():
            anchor = anchors.get(keyframe_id)
            if anchor is None or pts.shape[0] == 0:
                continue
            out.append(anchor.transform_from(pts))
        if not out:
            return np.zeros((0, 3))
        return np.concatenate(out, axis=0)

    def keyframe_count(self) -> int:
        return len(self._points)
