"""Backend-agnostic inference interfaces (the core never sees the device).

Equivalent of ``include/InferenceInterfaces.h``: the
estimation core holds extractor/matcher/recognizer protocols and is tested
device-free with deterministic stubs, exactly as the reference tests its
GPU-free ``superslam_core``.

Data conventions:
- keypoints: float32 (N, 2) pixel coordinates (x, y).
- descriptors: [N, D] rows; a ``jax.Array`` on the hot path (HBM-resident)
  or numpy in tests. ``descriptors_to_host`` materializes float32 numpy.
- matches: int32 (M, 2) (query_idx, train_idx) pairs plus float32 (M,) scores.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

import numpy as np


@dataclass
class Features:
    keypoints: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    scores: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    descriptors: Any = None  # [N, D] device- or host-resident


@dataclass
class MatchResult:
    """(query_idx, train_idx) index pairs + similarity scores."""

    matches: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))
    scores: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))

    def __len__(self) -> int:
        return int(self.matches.shape[0])


@runtime_checkable
class FeatureExtractor(Protocol):
    def extract(self, image: np.ndarray) -> Features: ...

    def extract_stereo(
        self, left: np.ndarray, right: np.ndarray
    ) -> tuple[Features, Features]:
        """Extract a rectified stereo pair. Backends override with one
        batched {2,1,H,W} program (reference: src/SuperPoint.cc:754-892)."""
        ...


@runtime_checkable
class FeatureMatcher(Protocol):
    def match(
        self,
        kp0: np.ndarray,
        d0: Any,
        kp1: np.ndarray,
        d1: Any,
    ) -> MatchResult:
        """Match two feature sets. Descriptors may be device- or
        host-resident; backends handle both (the reference keeps two
        overloads for TRT reasons that do not exist in JAX)."""
        ...

    def descriptors_to_host(self, d: Any) -> np.ndarray: ...
