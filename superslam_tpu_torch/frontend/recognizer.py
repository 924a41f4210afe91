"""EigenPlaces place recognizer backend (PlaceRecognizer implementation).

Port of ``superslam_tpu/frontend/recognizer.py``, the equivalent of the
reference EigenPlaces wrapper and its cosine index
(src/EigenPlaces.cc:145-174): image -> preprocess -> the ResNet18 + GeM
forward -> L2-normalized 512-d descriptor, and a cosine index for
retrieval. Two descriptor sources: a host image
(``compute_global_descriptor``) and the pipelined trackers' device-resident
uint8 upload (``compute_global_descriptor_from_device``), which needs no
image upload.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.place_recognition import CosineDescriptorIndex, LoopCandidate
from ..models.eigenplaces import (
    eigenplaces_descriptor,
    eigenplaces_descriptor_from_device_gray,
    preprocess_image,
)
from ..utils.device import resolve_device
from ..utils.env import env_float, env_int
from ..utils.profiler import profile_scope


class EigenPlacesRecognizer:
    def __init__(self, params, image_size: int = 512, min_score: float | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = {k: v.to(device=self.device, dtype=torch.float32) for k, v in params.items()}
        self.image_size = int(image_size)
        self.min_score = env_float(
            "SUPERSLAM_LOOP_MIN_SCORE", 0.75 if min_score is None else min_score
        )
        # SUPERSLAM_DEVICE_RETRIEVAL=1 keeps the retrieval database on the
        # device (ops/retrieval.py, a ring bounded by
        # SUPERSLAM_RETRIEVAL_CAPACITY): one matrix-vector product and a
        # top-k a query instead of the host GEMM that grows with the map
        # (src/PlaceRecognizer.cc:26-52). The default stays on the host: the
        # database is small and the worker is off the critical path.
        if os.environ.get("SUPERSLAM_DEVICE_RETRIEVAL", "") not in ("", "0", "false"):
            from ..ops.retrieval import DeviceCosineIndex

            cap = env_int("SUPERSLAM_RETRIEVAL_CAPACITY", 4096)
            self.index = DeviceCosineIndex(capacity=cap, dim=512, device=self.device)
        else:
            self.index = CosineDescriptorIndex()

    def compute_global_descriptor(self, image: np.ndarray) -> np.ndarray:
        with profile_scope("ep_descriptor"):
            x = preprocess_image(image, self.image_size, self.device)
            return eigenplaces_descriptor(self.params, x)[0].cpu().numpy()

    def compute_global_descriptor_from_device(
        self, gray_u8_dev: torch.Tensor, true_height: int, true_width: int
    ) -> np.ndarray:
        """Descriptor from a device-resident uint8 tracking frame (H, W),
        padding included: no image upload."""
        with profile_scope("ep_descriptor"):
            d = eigenplaces_descriptor_from_device_gray(
                self.params, gray_u8_dev, true_height=true_height, true_width=true_width,
                size=self.image_size,
            )
            return d.cpu().numpy()

    def add(self, keyframe_id: int, global_descriptor: np.ndarray) -> None:
        self.index.add(keyframe_id, global_descriptor)

    def query(
        self, global_descriptor: np.ndarray, exclude_recent: int, top_k: int
    ) -> list[LoopCandidate]:
        res = self.index.query(global_descriptor, exclude_recent, top_k, self.min_score)
        # The device index returns bare (id, score) tuples.
        return [
            c if isinstance(c, LoopCandidate) else LoopCandidate(int(c[0]), float(c[1]))
            for c in res
        ]
