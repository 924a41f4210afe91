"""LightGlue matcher backend implementing the core FeatureMatcher interface.

Port of ``superslam_tpu/frontend/matcher.py``. ``VoEstimator`` calls it for
its host re-match and rescue paths.
- Device path: both feature sets are PaddedFeatures whose descriptors
  already live on the card; the matcher consumes them directly.
- Host path: numpy descriptor rows are padded to the static K and
  uploaded.
- Keyframe records keep device descriptors on the device
  (``retain_for_matching``): the loop verifier matches them there.
- Keypoints are normalized wrapper-side as (kpt - size/2)/(max(w,h)/2);
  the output is matches0 [K] (-1 = unmatched) + mscores0, turned into
  (query, train) index pairs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.interfaces import MatchResult
from ..models.lightglue import lightglue_match, prepare_params
from ..utils.device import resolve_device
from ..utils.profiler import profile_scope
from .features import PaddedFeatures, host_descriptors


class LightGlueMatcher:
    def __init__(
        self,
        params,
        image_width: int,
        image_height: int,
        max_keypoints: int = 1024,
        threshold: float = 0.1,
        descriptor_dim: int = 256,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params = prepare_params(params, self.device)
        self.image_width = float(image_width)
        self.image_height = float(image_height)
        self.capacity = int(max_keypoints)
        self.threshold = float(threshold)
        self.descriptor_dim = int(descriptor_dim)
        self._scale = max(self.image_width, self.image_height) / 2.0
        self._center = torch.tensor(
            [self.image_width / 2.0, self.image_height / 2.0],
            dtype=torch.float32,
            device=self.device,
        )

    # -- input coercion -------------------------------------------------------
    def _coerce(self, kp: np.ndarray, d: Any):
        """-> (kpts (1,K,2) normalized, desc (1,K,D), n_valid)."""
        K = self.capacity
        if isinstance(d, PaddedFeatures):
            if d.kpts.shape[0] != K:
                raise ValueError(
                    f"PaddedFeatures capacity {d.kpts.shape[0]} != matcher K {K}"
                )
            n = min(d.n, K)
            kpts = (d.kpts - self._center) / self._scale
            return kpts[None], d.desc[None], n
        kp = np.asarray(kp, np.float32).reshape(-1, 2)
        dh = host_descriptors(d)
        n = min(kp.shape[0], dh.shape[0], K)
        kpad = np.zeros((K, 2), np.float32)
        dpad = np.zeros((K, self.descriptor_dim), np.float32)
        center = np.array([self.image_width / 2.0, self.image_height / 2.0], np.float32)
        kpad[:n] = (kp[:n] - center) / np.float32(self._scale)
        dpad[:n] = dh[:n]
        return (
            torch.from_numpy(kpad).to(self.device)[None],
            torch.from_numpy(dpad).to(self.device)[None],
            n,
        )

    def _mask(self, n: int) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.device) < n)[None]

    # -- FeatureMatcher interface ---------------------------------------------
    def match(self, kp0, d0, kp1, d1) -> MatchResult:
        with profile_scope("lg_match"):
            k0, dd0, n0 = self._coerce(kp0, d0)
            k1, dd1, n1 = self._coerce(kp1, d1)
            matches0, mscores0 = lightglue_match(
                self.params, k0, dd0, k1, dd1, self._mask(n0), self._mask(n1),
                threshold=self.threshold,
            )
            m = matches0[0].cpu().numpy()
            s = mscores0[0].cpu().numpy()
        qi = np.flatnonzero(m >= 0).astype(np.int32)
        return MatchResult(
            matches=np.stack([qi, m[qi].astype(np.int32)], axis=1),
            scores=s[qi].astype(np.float32),
        )

    def descriptors_to_host(self, d: Any) -> np.ndarray:
        return host_descriptors(d)

    def retain_for_matching(self, feats: Any) -> Any:
        """Keyframe-record form of a frame's descriptors.

        Device-backed features stay on the device: the loop verifier's
        ``match`` consumes PaddedFeatures directly, so the record costs no
        copy to the host per keyframe and no upload per verification. A
        batched step's slot (LazySlotFeatures) is materialized into its own
        PaddedFeatures so the record never holds a whole (S, K, D) block.
        Host inputs fall back to float32 rows (the reference's
        descriptors_to_host, src/LightGlue.cc:443-460)."""
        desc = getattr(feats, "desc", None)
        if isinstance(desc, torch.Tensor):
            return PaddedFeatures(
                kpts=feats.kpts,
                desc=desc,
                n=feats.n,
                width=feats.width,
                height=feats.height,
                valid=feats.valid,
            )
        return host_descriptors(feats)
