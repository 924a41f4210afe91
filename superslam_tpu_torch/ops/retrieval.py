"""On-device place-recognition retrieval: a fixed-capacity ring-buffer
cosine index.

Port of ``superslam_tpu/ops/retrieval.py::DeviceCosineIndex``. The
reference's loop retrieval is a host GEMM that grows with the number of
keyframes (src/PlaceRecognizer.cc:26-52). This index keeps the descriptor
database on the device in a fixed-capacity ring (past ``capacity``
insertions the oldest entry is overwritten) and runs a query as one
matrix-vector product and a top-k. Exact score ties break by insertion
order, oldest first, as the host ``CosineDescriptorIndex``'s stable sort
does. The host index stays the loop worker's default
(``SUPERSLAM_DEVICE_RETRIEVAL``). ``ShardedCosineIndex`` splits the rows
over a mesh's devices (``parallel/mesh.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _query(db, ids, ins, size: int, query, exclude_recent: int, min_score: float, top_k: int):
    q = query / torch.clamp(torch.linalg.vector_norm(query), min=1e-12)
    scores = db @ q  # (capacity,)
    # ins: the insertion index each row holds (-1 = never written); after
    # the ring wraps a row holds its slot's newest insertion, so masking on
    # ins alone leaves no stale row.
    valid = (ins >= 0) & (ins < size - exclude_recent) & (scores >= min_score)
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = torch.topk(masked, top_k)
    return top_scores, ids[top_idx], ins[top_idx]


def _ring_add(db, ids, ins, row, keyframe_id: int, i: int, r: int) -> None:
    """Write one row in place: O(dim), not a new O(capacity * dim) buffer."""
    db[r] = row
    ids[r] = keyframe_id
    ins[r] = i


class DeviceCosineIndex:
    """Fixed-capacity cosine ring index on the device."""

    def __init__(self, capacity: int = 4096, dim: int = 512, device="cuda"):
        self.device = resolve_device(device)
        self.capacity = capacity
        self._db = torch.zeros((capacity, dim), dtype=torch.float32, device=self.device)
        self._ids = torch.zeros((capacity,), dtype=torch.int32, device=self.device)
        self._ins = torch.full((capacity,), -1, dtype=torch.int32, device=self.device)
        self._size = 0

    def __len__(self) -> int:
        return min(self._size, self.capacity)

    @property
    def total_added(self) -> int:
        """Lifetime insertions (> capacity once the ring has wrapped)."""
        return self._size

    def add(self, keyframe_id: int, descriptor: np.ndarray) -> None:
        d = np.asarray(descriptor, np.float32).reshape(-1)
        n = float(np.linalg.norm(d))
        if n > 1e-12:
            d = d / n
        row = torch.from_numpy(d).to(self.device)
        _ring_add(self._db, self._ids, self._ins, row, int(keyframe_id), self._size,
                  self._size % self.capacity)
        self._size += 1

    def query(
        self,
        descriptor: np.ndarray,
        exclude_recent: int,
        top_k: int,
        min_score: float,
    ) -> list[tuple[int, float]]:
        """Returns [(keyframe_id, score)] sorted descending, filtered."""
        if self._size == 0 or self._size <= exclude_recent:
            return []
        k = min(top_k if top_k > 0 else self.capacity, self.capacity)
        q = torch.from_numpy(np.asarray(descriptor, np.float32).reshape(-1)).to(self.device)
        scores, ids, ins = (
            t.cpu().numpy()
            for t in _query(self._db, self._ids, self._ins, self._size, q, exclude_recent,
                            float(min_score), k)
        )
        keep = np.isfinite(scores)
        scores, ids, ins = scores[keep], ids[keep], ins[keep]
        # Exact score ties break by insertion order (oldest first), as the
        # host index's stable argsort: after the ring wraps, top-k's slot
        # order no longer is insertion order.
        order = np.lexsort((ins, -scores))
        return [(int(ids[i]), float(scores[i])) for i in order]


class ShardedCosineIndex:
    """DeviceCosineIndex over a device mesh: the database rows are split
    over every device of the mesh (retrieval has no model dimension), the
    query product and a top-k run per shard, and only the per-shard
    winners cross to the host for the final selection.

    Port of ``superslam_tpu/ops/retrieval.py::ShardedCosineIndex``: capacity
    grows with the mesh while each device's traffic a query stays constant,
    and the result equals the single-device index's, the ring's ageing
    included (past capacity the oldest entry is overwritten)."""

    def __init__(self, mesh, capacity: int = 8192, dim: int = 512):
        self.mesh = mesh
        devices = [resolve_device(d) for d in mesh.flat()]
        n = len(devices)
        if capacity % n:
            capacity += n - capacity % n
        self.capacity = capacity
        self._shard_rows = capacity // n
        self._shards = [
            (
                torch.zeros((self._shard_rows, dim), dtype=torch.float32, device=d),
                torch.zeros((self._shard_rows,), dtype=torch.int32, device=d),
                torch.full((self._shard_rows,), -1, dtype=torch.int32, device=d),
            )
            for d in devices
        ]
        self._size = 0

    def __len__(self) -> int:
        return min(self._size, self.capacity)

    @property
    def total_added(self) -> int:
        return self._size

    def add(self, keyframe_id: int, descriptor: np.ndarray) -> None:
        d = np.asarray(descriptor, np.float32).reshape(-1)
        n = float(np.linalg.norm(d))
        if n > 1e-12:
            d = d / n
        # Round-robin over shards, so every shard holds an equal prefix of
        # the insertion order; past capacity the ring revisits rows in the
        # same order, overwriting the oldest.
        i = self._size % self.capacity
        db, ids, ins = self._shards[i % len(self._shards)]
        _ring_add(db, ids, ins, torch.from_numpy(d).to(db.device), int(keyframe_id),
                  self._size, i // len(self._shards))
        self._size += 1

    def query(
        self,
        descriptor: np.ndarray,
        exclude_recent: int,
        top_k: int,
        min_score: float,
    ) -> list[tuple[int, float]]:
        """Returns [(keyframe_id, score)] sorted descending, filtered."""
        if self._size == 0 or self._size <= exclude_recent:
            return []
        k = min(top_k if top_k > 0 else self.capacity, self.capacity)
        k_local = min(k, self._shard_rows)
        q = np.asarray(descriptor, np.float32).reshape(-1)
        winners = [
            _query(db, ids, ins, self._size, torch.from_numpy(q).to(db.device), exclude_recent,
                   float(min_score), k_local)
            for db, ids, ins in self._shards
        ]
        first = self._shards[0][0].device
        scores, ids, ins = (
            torch.cat([w[j].to(first) for w in winners]).cpu().numpy() for j in range(3)
        )
        keep = np.isfinite(scores)
        scores, ids, ins = scores[keep], ids[keep], ins[keep]
        # The final selection over the gathered per-shard winners happens
        # here, so ties break by insertion order as the host index's stable
        # sort does.
        order = np.lexsort((ins, -scores))[:k]
        return [(int(ids[i]), float(scores[i])) for i in order]
