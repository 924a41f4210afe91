"""Place-recognition retrieval core: cosine index + temporal voter.

Equivalent of ``src/PlaceRecognizer.cc:26-66``:

- ``CosineDescriptorIndex``: flat GEMM scan ``cand @ q`` over L2-normalized
  rows, an excludeRecent window, a minScore filter, and top-K descending.
  The scan is a single numpy GEMM on host (or can be handed a jax matmul for
  very large maps — the retrieval database is also mirrored on-device by
  ops.retrieval for the TPU path).
- ``TemporalConsistencyVoter``: accept only after K consecutive matches
  whose keyframe ids lie within idTolerance of each other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np


@dataclass
class LoopCandidate:
    keyframe_id: int
    score: float


class PlaceRecognizer(Protocol):
    """Pluggable place recognition (mirrors IPlaceRecognizer,
    ``include/PlaceRecognizer.h:20-36``)."""

    def compute_global_descriptor(self, image: np.ndarray) -> np.ndarray: ...

    def add(self, keyframe_id: int, global_descriptor: np.ndarray) -> None: ...

    def query(
        self, global_descriptor: np.ndarray, exclude_recent: int, top_k: int
    ) -> list[LoopCandidate]: ...


def _normalized(desc: np.ndarray) -> np.ndarray:
    row = np.asarray(desc, dtype=np.float32).reshape(-1)
    n = float(np.linalg.norm(row))
    if n > 1e-12:
        row = row / n
    return row


class CosineDescriptorIndex:
    """Source-agnostic cosine-similarity index; insertion order = recency."""

    def __init__(self, capacity_step: int = 256):
        self._ids: list[int] = []
        self._db: np.ndarray | None = None  # (cap, D) preallocated ring
        self._size = 0
        self._step = capacity_step

    def add(self, keyframe_id: int, global_descriptor: np.ndarray) -> None:
        row = _normalized(global_descriptor)
        if self._db is None:
            self._db = np.zeros((self._step, row.shape[0]), dtype=np.float32)
        elif self._size == self._db.shape[0]:
            grown = np.zeros(
                (self._db.shape[0] + self._step, self._db.shape[1]), dtype=np.float32
            )
            grown[: self._size] = self._db
            self._db = grown
        self._db[self._size] = row
        self._ids.append(keyframe_id)
        self._size += 1

    def __len__(self) -> int:
        return self._size

    def query(
        self,
        global_descriptor: np.ndarray,
        exclude_recent: int,
        top_k: int,
        min_score: float,
    ) -> list[LoopCandidate]:
        M = self._size
        if M == 0 or M <= exclude_recent:
            return []  # nothing old enough to be a loop
        q = _normalized(global_descriptor)
        limit = M - exclude_recent
        scores = self._db[:limit] @ q  # (limit,) cosine similarities
        keep = np.flatnonzero(scores >= min_score)
        if keep.size == 0:
            return []
        order = keep[np.argsort(-scores[keep], kind="stable")]
        if top_k > 0:
            order = order[:top_k]
        return [LoopCandidate(self._ids[i], float(scores[i])) for i in order]


class TemporalConsistencyVoter:
    """Debounce loops: accept only after `required` consecutive queries agree
    on the same locale (ids within `id_tolerance`)."""

    def __init__(self, required_votes: int, id_tolerance: int):
        self._required = required_votes
        self._tol = id_tolerance
        self._streak = 0
        self._last_id = 0
        self._have_last = False

    def vote(self, best: LoopCandidate | None) -> bool:
        if best is None:
            self._streak = 0
            self._have_last = False
            return False
        consistent = self._have_last and abs(best.keyframe_id - self._last_id) <= self._tol
        self._streak = self._streak + 1 if consistent else 1
        self._last_id = best.keyframe_id
        self._have_last = True
        return self._streak >= self._required
