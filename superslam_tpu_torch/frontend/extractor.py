"""SuperPoint extractor backend: images in, PaddedFeatures out.

Port of ``superslam_tpu/frontend/extractor.py``: the dense heads, NMS,
top-K selection and descriptor gather run on the device; only keypoints
and scores cross to the host, descriptors stay on the device inside the
returned PaddedFeatures. Images are padded to a fixed (H, W).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.interfaces import Features
from ..models.superpoint import prepare_superpoint_params, superpoint_extract
from ..utils.device import resolve_device
from ..utils.env import env_flag
from ..utils.profiler import profile_scope
from .features import PaddedFeatures


def pad_to_multiple(x: int, m: int = 32) -> int:
    """Frame padding quantum: 32, the JAX package's (its conv+pool kernels
    stripe 16 rows at full and half resolution). The port's kernels need
    only multiples of 8, but the same padded frame keeps both packages on
    identical inputs. Extra rows/cols are zeros and their keypoints are
    masked by true_width/true_height in select_keypoints."""
    return ((x + m - 1) // m) * m


class SuperPointExtractor:
    def __init__(
        self,
        params,
        width: int,
        height: int,
        max_keypoints: int = 1024,
        keypoint_threshold: float = 0.005,
        remove_borders: int = 4,
        nms_radius: int = 4,
        device="cuda",
        use_kernel: bool = True,
    ):
        """The descriptor gather is the hand-written gather_normalize kernel
        (models/superpoint.py::select_keypoints) by default, where the JAX
        package's default is XLA's gather with the bf16 -> f32 conversion
        fused into it, which eager PyTorch cannot fuse; ``use_kernel=False``
        (the JAX package's ``use_pallas=False``) takes the plain
        torch.gather composition."""
        self.device = resolve_device(device)
        self.params = prepare_superpoint_params(params, self.device)
        self.width = int(width)
        self.height = int(height)
        self.pad_w = pad_to_multiple(self.width)
        self.pad_h = pad_to_multiple(self.height)
        self.max_keypoints = int(max_keypoints)
        self.keypoint_threshold = float(keypoint_threshold)
        self.remove_borders = int(remove_borders)
        self.nms_radius = int(nms_radius)
        self.use_kernel = bool(use_kernel)

    def _prepare(self, images: list[np.ndarray]) -> torch.Tensor:
        batch = np.zeros((len(images), self.pad_h, self.pad_w), np.float32)
        for i, img in enumerate(images):
            a = np.asarray(img)
            if a.ndim == 3:  # BGR -> gray
                a = a @ np.array([0.114, 0.587, 0.299], np.float32)
            if np.issubdtype(a.dtype, np.floating):
                # Contract: float images are already normalized to [0, 1].
                a = a.astype(np.float32)
            else:
                a = a.astype(np.float32) / 255.0
            h, w = a.shape
            batch[i, : min(h, self.pad_h), : min(w, self.pad_w)] = a[
                : self.pad_h, : self.pad_w
            ]
        return torch.from_numpy(batch).to(self.device)

    def _run(self, images: list[np.ndarray]) -> list[Features]:
        x = self._prepare(images)
        with profile_scope("sp_gpu_infer"):
            kpts, scores, valid, desc = superpoint_extract(
                self.params,
                x,
                max_keypoints=self.max_keypoints,
                keypoint_threshold=self.keypoint_threshold,
                remove_borders=self.remove_borders,
                nms_radius=self.nms_radius,
                true_width=self.width,
                true_height=self.height,
                subpixel=env_flag("SUPERSLAM_SP_SUBPIXEL", True),
                use_kernel=self.use_kernel,
            )
            kpts_h = kpts.cpu().numpy()
            scores_h = scores.cpu().numpy()
            valid_h = valid.cpu().numpy()

        out = []
        for i in range(len(images)):
            n = int(valid_h[i].sum())  # valid rows form a prefix
            padded = PaddedFeatures(
                kpts=kpts[i], desc=desc[i], n=n, width=self.width, height=self.height
            )
            out.append(
                Features(
                    keypoints=kpts_h[i, :n].copy(),
                    scores=scores_h[i, :n].copy(),
                    descriptors=padded,
                )
            )
        return out

    def extract(self, image: np.ndarray) -> Features:
        return self._run([image])[0]

    def extract_stereo(self, left: np.ndarray, right: np.ndarray):
        with profile_scope("sp_extract_stereo"):
            l, r = self._run([left, right])
        return l, r
