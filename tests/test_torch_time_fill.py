"""scripts/time_fill_torch.py on the CPU at a tiny size: every setting is
timed, and the fill's module state is as it was after the sweep; the
torch fill it times writes what ``fill_padded`` writes. The times
themselves say nothing about the card's host and are not checked."""

import math

import numpy as np

from scripts import time_fill_torch as script
from superslam_tpu_torch.frontend import fused
from superslam_tpu_torch.frontend.extractor import pad_to_multiple


def test_times_every_setting_and_leaves_the_fill_as_it_was(capsys):
    before = (fused.FILL_WORKERS, fused.FILL_MIN_IMAGES, fused._filler, fused._fill_pool)
    out = script.main(["--random", "20", "45", "--streams", "3", "--reps", "2",
                       "--workers", "1", "2"])
    assert (fused.FILL_WORKERS, fused.FILL_MIN_IMAGES, fused._filler, fused._fill_pool) == before
    rows = out["results"]
    # 2 copies x 2 zeroings x 2 pool sizes at 6 images, torch's copies, then
    # 2, 3, 4 and 6 images inline and through the pool.
    assert len(rows) == 8 + 1 + 4 * 2
    assert {(r["copy"], r["zero"], r["cap"]) for r in rows if r["images"] == 6 and "cap" in r} == {
        (c, z, k) for c in ("native", "numpy") for z in ("pads", "full") for k in (1, 2)}
    assert [r["copy"] for r in rows if "aten_threads" in r] == ["torch"]
    assert all(math.isfinite(r["median_ms"]) and r["median_ms"] > 0 for r in rows)
    assert out["pad"] == [pad_to_multiple(20), pad_to_multiple(45)]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")


def test_the_torch_fill_writes_what_fill_padded_writes():
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, size, dtype=np.uint8)
              for size in ((17, 41), (24, 48), (30, 53))] * 6
    want = fused.fill_padded(np.full((18, 24, 48), 0xAB, np.uint8), images)
    got = np.full((18, 24, 48), 0xAB, np.uint8)
    script._torch_fill(got, images)
    np.testing.assert_array_equal(got, want)
