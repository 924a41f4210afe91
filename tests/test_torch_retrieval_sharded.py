"""The port's ShardedCosineIndex (ops/retrieval.py) on an 8-entry CPU mesh
against the JAX package's on its 8 virtual CPU devices and against the
port's single-device DeviceCosineIndex, on tests/test_retrieval.py's cases:
ranking with excludeRecent, topK and minScore, ties broken by insertion
order across shards, the ring's ageing past capacity, empty and excluded.
Ids exact; scores within 1e-6 (one f32 dot product a row, summed in
another order by each library)."""

import numpy as np
import pytest

from superslam_tpu.ops.retrieval import ShardedCosineIndex as JShardedCosineIndex
from superslam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from superslam_tpu_torch.ops.retrieval import DeviceCosineIndex, ShardedCosineIndex
from superslam_tpu_torch.parallel.mesh import make_mesh

SCORE_ATOL = 1e-6


def _three(capacity, dim):
    return (
        JShardedCosineIndex(jax_make_mesh(8), capacity=capacity, dim=dim),
        ShardedCosineIndex(make_mesh(8, devices=["cpu"] * 8), capacity=capacity, dim=dim),
        DeviceCosineIndex(capacity=capacity, dim=dim, device="cpu"),
    )


def _assert_same(results):
    ref = results[0]
    for got in results[1:]:
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=SCORE_ATOL)


@pytest.mark.parametrize("n_added", [37, 90], ids=["filling", "wrapped"])
def test_sharded_index_matches_jax_and_device_index(n_added):
    rng = np.random.default_rng(1)
    indexes = _three(64, 32)
    descs = rng.standard_normal((n_added, 32)).astype(np.float32)
    for i, d in enumerate(descs):
        for idx in indexes:
            idx.add(100 + i, d)
    assert len(indexes[1]) == min(n_added, 64) and indexes[1].total_added == n_added
    for exclude, topk, min_score in [(0, 5, -1.0), (3, 3, 0.0), (10, 8, 0.1), (0, 0, -1.0)]:
        q = descs[n_added - 20] + rng.normal(0, 0.05, 32).astype(np.float32)
        _assert_same([idx.query(q, exclude, topk, min_score) for idx in indexes])


def test_sharded_index_breaks_ties_by_insertion():
    rng = np.random.default_rng(3)
    indexes = _three(32, 16)
    d_dup = rng.standard_normal(16).astype(np.float32)
    for i in range(12):
        d = d_dup if i in (1, 6, 9) else rng.standard_normal(16).astype(np.float32)
        for idx in indexes:
            idx.add(200 + i, d)
    results = [idx.query(d_dup, 0, 4, 0.5) for idx in indexes]
    _assert_same(results)
    assert [i for i, _ in results[1]][:3] == [201, 206, 209]  # insertion order on ties


def test_sharded_index_empty_and_excluded():
    jidx, idx, _ = _three(16, 4)
    for index in (jidx, idx):
        assert index.query(np.ones(4), 0, 3, 0.0) == []
        index.add(0, np.ones(4))
        assert index.query(np.ones(4), 1, 3, 0.0) == []  # nothing old enough
        out = index.query(np.ones(4), 0, 3, 0.0)
        assert out and out[0][0] == 0
    assert idx.capacity == jidx.capacity == 16
    assert ShardedCosineIndex(make_mesh(8, devices=["cpu"] * 8), capacity=20, dim=4).capacity == 24
