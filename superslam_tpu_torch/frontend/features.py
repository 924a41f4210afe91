"""Device-resident padded feature containers.

On TPU the reference's DescriptorPool slots + D2D copies
(``include/DescriptorPool.h``, ``src/LightGlue.cc:425-441``)
reduce to this: a ``PaddedFeatures`` holds the jitted extractor's padded
output arrays exactly as they live in HBM, plus the valid count. Passing it
to the matcher passes HBM buffers between XLA programs — zero copies, no
allocator, no free-list.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass
class PaddedFeatures:
    """Static-shape feature block: rows [0, n) real, rows [n, K) padding."""

    kpts: Any  # (K, 2) f32 jax.Array, pixel coords
    desc: Any  # (K, D) f32/bf16 jax.Array, L2-normalized rows
    n: int  # number of valid rows
    width: int  # image size the keypoints live in (for normalization)
    height: int
    valid: Any = None  # optional (K,) bool jax.Array (device-side mask)

    @property
    def capacity(self) -> int:
        return int(self.kpts.shape[0])


class LazySlotFeatures:
    """PaddedFeatures-shaped view into row ``slot`` of a batched program
    output (kpts (S, K, 2), desc (S, K, D), valid (S, K)).

    The device slice ops are deferred until first attribute access: in the
    batched pipeline only keyframes (and the rare host re-match) ever read
    a frame's padded features, so eager slicing would submit 3*S device ops
    per dispatch purely to discard most of them."""

    def __init__(self, kpts_b, desc_b, valid_b, slot: int, n: int, width: int, height: int):
        self._kpts_b, self._desc_b, self._valid_b = kpts_b, desc_b, valid_b
        self.slot = slot
        self.n = n
        self.width = width
        self.height = height
        self._cache: dict[str, Any] = {}

    def _slice(self, name: str, batched):
        if name not in self._cache:
            self._cache[name] = None if batched is None else batched[self.slot]
        return self._cache[name]

    @property
    def kpts(self):
        return self._slice("kpts", self._kpts_b)

    @property
    def desc(self):
        return self._slice("desc", self._desc_b)

    @property
    def valid(self):
        return self._slice("valid", self._valid_b)

    @property
    def capacity(self) -> int:
        return int(self._kpts_b.shape[1])


def keyframe_world_arrays(frame, calib, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """(K, 3) world points + (K,) depth-validity for a newly adopted
    keyframe, aligned with the device keypoint prefix ordering — the upload
    payload both device-tracking pipelines share (stereo + RGB-D). Must run
    after the estimator adopted the frame so frame.pose is the
    window-smoothed Twc the host tracker would backproject through."""
    xw = np.zeros((capacity, 3), np.float32)
    depth_ok = np.zeros((capacity,), bool)
    idx = np.flatnonzero(frame.has_depth[:capacity])
    if idx.size:
        xw[idx] = frame.backproject_all(calib, idx).astype(np.float32)
        depth_ok[idx] = True
    return xw, depth_ok


def host_descriptors(feats: PaddedFeatures | np.ndarray | None) -> np.ndarray:
    """Materialize float32 host rows [N, D] (the reference's
    descriptors_to_host, one D2H per keyframe)."""
    if feats is None:
        return np.zeros((0, 256), np.float32)
    if isinstance(feats, np.ndarray):
        return feats.astype(np.float32)
    return feats.desc[: feats.n].float().cpu().numpy()  # a torch tensor, maybe on the card
