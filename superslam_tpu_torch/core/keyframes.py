"""Keyframe records and insertion-ordered database.

Equivalent of ``include/KeyframeDatabase.h:17-43``. The
authoritative optimized pose lives in the GlobalPoseGraph; ``pose_at_insert``
is a cached seed for geometric verification. Record descriptors are either
device-resident PaddedFeatures (recent keyframes — loop verification
consumes HBM buffers with no host round trip) or host float32 rows [N, D]
(older records demoted under the HBM budget; the reference copies
off-device eagerly per keyframe instead, ``src/VoEstimator.cc:106``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..geometry.se3 import Pose3


@dataclass
class KeyframeRecord:
    keyframe_id: int = 0
    timestamp: float = 0.0
    pose_at_insert: Pose3 = field(default_factory=Pose3)  # cached seed
    keypoints_left: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    # Host float32 rows OR a device-resident PaddedFeatures (the matcher
    # consumes either; device records avoid loop-verify host round trips).
    descriptors_left: object = field(default_factory=lambda: np.zeros((0, 256)))
    stereo: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    has_depth: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=bool))
    global_descriptor: np.ndarray | None = None  # [Dg], L2-normalized
    covisible: list[int] = field(default_factory=list)


class KeyframeDatabase:
    def __init__(self, device_record_budget: int | None = None) -> None:
        self._records: list[KeyframeRecord] = []
        self._id_to_index: dict[int, int] = {}
        # HBM budget for device-resident record descriptors (~0.62 MB each
        # at K=600): the database lives for the whole run, so without a cap
        # a multi-hour session would grow device memory linearly in
        # keyframes. Beyond the budget the OLDEST device record is demoted
        # to host float32 rows (one deferred D2H — exactly what the
        # reference pays eagerly per keyframe, src/VoEstimator.cc:106);
        # demoted candidates still verify via the matcher's host path.
        if device_record_budget is None:
            from ..utils.env import env_int

            device_record_budget = env_int("SUPERSLAM_DEVICE_KF_RECORDS", 512)
        self._device_budget = max(0, int(device_record_budget))
        self._device_resident: list[KeyframeRecord] = []

    @staticmethod
    def _is_device(rec: KeyframeRecord) -> bool:
        d = rec.descriptors_left
        return hasattr(d, "desc") and not isinstance(
            getattr(d, "desc"), np.ndarray
        )

    def add(self, rec: KeyframeRecord) -> None:
        self._id_to_index[rec.keyframe_id] = len(self._records)
        self._records.append(rec)
        if self._is_device(rec):
            self._device_resident.append(rec)
            while len(self._device_resident) > self._device_budget:
                old = self._device_resident.pop(0)
                d = old.descriptors_left
                old.descriptors_left = np.asarray(d.desc, np.float32)[: d.n]
            if 0 < self._device_budget <= len(self._device_resident):
                # Pre-arrange the next demotion's D2H now: a non-prearranged
                # np.asarray on this link pays the full ~30 ms RTT on the
                # loop worker thread; after copy_to_host_async the later
                # fetch is ~0.1 ms. The head only changes on eviction, so
                # each record is prearranged once.
                head = self._device_resident[0].descriptors_left
                try:
                    head.desc.copy_to_host_async()
                except (AttributeError, RuntimeError):
                    pass

    def get(self, keyframe_id: int) -> KeyframeRecord:
        return self._records[self._id_to_index[keyframe_id]]

    def has(self, keyframe_id: int) -> bool:
        return keyframe_id in self._id_to_index

    def __len__(self) -> int:
        return len(self._records)

    def records(self) -> list[KeyframeRecord]:
        """Records in insertion (keyframe creation) order."""
        return self._records
