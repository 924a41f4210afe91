"""The multi-sequence step's upload fill (``frontend/fused.py::fill_padded``,
called by ``parallel/multi_tracker.py::MultiSequenceTracker._prepare``)
against the JAX package's ``MultiSequenceTracker._prepare``, byte for byte:
through the native fill and through numpy's copies (its fallback without
the library), over image counts, sizes against the pad, dtypes, an ``out``
that holds an earlier batch, and image layouts; the ``upload.fill`` spans
that count the shares; the shared pool under concurrent callers; the
fill's library, built from its source's hash."""

import shutil
import sys
import threading
import types
import warnings

import numpy as np
import pytest

from superslam_tpu.parallel.multi_tracker import MultiSequenceTracker as JaxTracker
from superslam_tpu_torch import native
from superslam_tpu_torch.frontend import fused
from superslam_tpu_torch.frontend.fused import UploadRing, fill_padded
from superslam_tpu_torch.parallel.multi_tracker import MultiSequenceTracker
from superslam_tpu_torch.utils import profiler

PAD = (24, 48)  # (padH, padW): a multiple of 16 wide, so the native fill streams its stores
SIZES = {"smaller": (17, 41), "equal": PAD, "larger": (30, 53)}


def _images(n, size, dtype, seed=0):
    rng = np.random.default_rng(seed)
    # Floats beyond [0, 255] on both sides, so the clip shows.
    return [rng.uniform(-40, 300, size).astype(dtype) for _ in range(n)]


def _jax_batch(images, pad=PAD):
    """The JAX package's ``_prepare`` of the images as (left, right) pairs;
    an odd count gets a last right image that is then dropped."""
    n = len(images)
    imgs = list(images) + ([np.zeros((1, 1), np.uint8)] if n % 2 else [])
    ns = types.SimpleNamespace(S=len(imgs) // 2, pad_h=pad[0], pad_w=pad[1])
    return JaxTracker._prepare(ns, imgs[0::2], imgs[1::2])[:n]


@pytest.fixture(params=["native", "numpy"])
def copy(request, monkeypatch):
    """The native fill (asserted to load), or numpy's copies in its place."""
    if request.param == "native":
        assert native.fill_library() is not None, "the fill's library did not build"
    else:
        monkeypatch.setattr(native, "padded_fill", lambda out, images: None)
    return request.param


@pytest.mark.parametrize("n", [1, 2, 3, 32])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("prefill", [None, 0xAB])
def test_fill_padded_matches_the_jax_prepare(copy, n, size, dtype, prefill):
    images = _images(n, SIZES[size], dtype, seed=n)
    if prefill is None:
        out = np.empty((n, *PAD), np.uint8)
    else:
        out = np.full((n, *PAD), prefill, np.uint8)
    assert fill_padded(out, images) is out
    np.testing.assert_array_equal(out, _jax_batch(images))


@pytest.mark.parametrize("streams,seqs", [(1, [0]), (4, [1, 3]), (16, list(range(16)))])
def test_prepare_matches_the_jax_prepare(copy, streams, seqs):
    """The port's ``_prepare`` of a group's streams, with and without a slot,
    against the JAX package's ``_prepare`` of the same streams."""
    lefts = _images(streams, (20, 45), np.uint8, seed=1)
    rights = _images(streams, (20, 45), np.uint8, seed=2)
    trk = types.SimpleNamespace(pad_h=PAD[0], pad_w=PAD[1])
    ns = types.SimpleNamespace(S=len(seqs), pad_h=PAD[0], pad_w=PAD[1])
    want = JaxTracker._prepare(ns, [lefts[s] for s in seqs], [rights[s] for s in seqs])
    got = MultiSequenceTracker._prepare(trk, lefts, rights, seqs)
    np.testing.assert_array_equal(got, want)
    slot = np.full((2 * len(seqs), *PAD), 0xAB, np.uint8)
    assert MultiSequenceTracker._prepare(trk, lefts, rights, seqs, out=slot) is slot
    np.testing.assert_array_equal(slot, want)


@pytest.mark.parametrize("n", [2, 32])
def test_a_reused_slot_keeps_its_pads_zero(copy, n):
    """A slot filled with a larger batch, then with a smaller one: the
    second fill zeroes what the first wrote beyond the smaller images."""
    out = np.empty((n, *PAD), np.uint8)
    fill_padded(out, _images(n, SIZES["larger"], np.uint8, seed=3))
    assert (out != 0).mean() > 0.9
    small = _images(n, (5, 7), np.uint8, seed=4)
    fill_padded(out, small)
    np.testing.assert_array_equal(out, _jax_batch(small))
    assert not out[:, 5:].any() and not out[:, :, 7:].any()


@pytest.mark.parametrize("layout", ["column_step", "flipped_rows", "flipped_columns", "empty"])
def test_image_layouts(copy, layout):
    """Views the fill must read through their strides (a copy where the
    columns are not contiguous) and images with no pixels."""
    base = _images(16, (40, 100), np.uint8, seed=5)
    images = {
        "column_step": [a[:, ::2] for a in base],
        "flipped_rows": [a[::-1, :45] for a in base],
        "flipped_columns": [a[:20, ::-1] for a in base],
        "empty": [a[:0, :10] if k % 2 else a[:10, :0] for k, a in enumerate(base)],
    }[layout]
    out = np.full((16, *PAD), 0xAB, np.uint8)
    fill_padded(out, images)
    np.testing.assert_array_equal(out, _jax_batch(images))


@pytest.mark.parametrize("slot", ["narrow_pad", "unaligned"])
def test_slots_the_stores_cannot_stream_to(copy, slot):
    """The native fill streams its stores only to 16-byte aligned rows: a pad
    width off the multiple of 16, and a slot one byte off, take plain
    copies with the same result."""
    pad = (24, 40) if slot == "narrow_pad" else PAD
    out = np.full(16 * pad[0] * pad[1] + 1, 0xAB, np.uint8)[1:].reshape(16, *pad)
    if slot == "narrow_pad":
        out = np.full((16, *pad), 0xAB, np.uint8)
    images = _images(16, (20, 45), np.float32, seed=11)
    fill_padded(out, images)
    np.testing.assert_array_equal(out, _jax_batch(images, pad))


def test_a_slot_that_is_not_contiguous_takes_numpy_copies(monkeypatch):
    calls = []
    real = native.padded_fill
    monkeypatch.setattr(native, "padded_fill",
                        lambda out, images: calls.append(1) or real(out, images))
    store = np.full((16, PAD[0], 2 * PAD[1]), 0xAB, np.uint8)
    out = store[:, :, ::2]
    images = _images(16, (20, 45), np.uint8, seed=6)
    fill_padded(out, images)
    np.testing.assert_array_equal(out, _jax_batch(images))
    assert not calls


def test_refusals():
    with pytest.raises(ValueError, match="does not hold"):
        fill_padded(np.empty((3, *PAD), np.uint8), _images(2, (4, 4), np.uint8))
    with pytest.raises(ValueError, match="does not hold"):
        fill_padded(np.empty((2, *PAD), np.float32), _images(2, (4, 4), np.uint8))
    with pytest.raises(ValueError, match="not \\(H, W\\)"):
        fill_padded(np.empty((1, *PAD), np.uint8), [np.zeros((4, 4, 3), np.uint8)])
    out = np.empty((2, *PAD), np.uint8)
    with pytest.raises(ValueError, match="2-D uint8"):
        native.padded_fill(out, [np.zeros((4, 4), np.float32)] * 2)
    with pytest.raises(IndexError, match="images 1:3 of 2"):
        native.padded_fill(out, [np.zeros((4, 4), np.uint8)] * 2).fill(1, 3)


# -- the shares and their spans ------------------------------------------------------


@pytest.fixture
def recording():
    profiler.stop_recording()
    yield
    profiler.stop_recording()


def _expected_shares(n):
    workers = min(len(fused.os.sched_getaffinity(0)), fused.FILL_WORKERS, n)
    return workers if n >= fused.FILL_MIN_IMAGES and workers >= 2 else 0


def test_a_32_image_fill_records_one_span_a_share(recording, copy, monkeypatch):
    ranges = []
    real = fused._filler

    def filler(out, images):
        fill = real(out, images)
        return lambda lo, hi: ranges.append((lo, hi)) or fill(lo, hi)

    monkeypatch.setattr(fused, "_filler", filler)
    images = _images(32, (20, 45), np.uint8, seed=7)
    out = np.empty((32, *PAD), np.uint8)
    profiler.start_recording()
    fill_padded(out, images)
    spans = profiler.stop_recording()
    np.testing.assert_array_equal(out, _jax_batch(images))
    want = _expected_shares(32)
    assert want >= 2, "the host must offer two cores for the pool"
    assert [s[0] for s in spans] == ["upload.fill"] * want
    # Each on a pool thread, at depth 0 there: the caller's spans stay the innermost.
    assert all(s[5] != threading.get_ident() and s[3] == -1 for s in spans)
    # The shares cover the 32 images, each once.
    assert len(ranges) == want
    assert sorted(k for lo, hi in ranges for k in range(lo, hi)) == list(range(32))


def test_a_2_image_fill_records_none(recording, copy):
    images = _images(2, (20, 45), np.uint8, seed=8)
    out = np.empty((2, *PAD), np.uint8)
    profiler.start_recording()
    fill_padded(out, images)
    assert profiler.stop_recording() == []
    np.testing.assert_array_equal(out, _jax_batch(images))


def test_the_shares_lie_inside_the_callers_prepare_span(recording):
    """Through ``UploadRing.upload`` (the CPU route: ``prepare()`` makes the
    batch): the ``upload.fill`` spans open and close inside
    ``upload.prepare``, on other threads, at depth 0 where the caller's
    ``upload.prepare`` is at depth 1."""
    lefts = _images(16, (20, 45), np.uint8, seed=9)
    rights = _images(16, (20, 45), np.uint8, seed=10)
    trk = types.SimpleNamespace(pad_h=PAD[0], pad_w=PAD[1])
    ring = UploadRing((32, *PAD), fused.torch.device("cpu"))
    profiler.start_recording()
    up = ring.upload(lambda out=None: MultiSequenceTracker._prepare(
        trk, lefts, rights, list(range(16)), out=out))
    spans = profiler.stop_recording()
    ns = types.SimpleNamespace(S=16, pad_h=PAD[0], pad_w=PAD[1])
    np.testing.assert_array_equal(up.numpy(), JaxTracker._prepare(ns, lefts, rights))
    (prep,) = [s for s in spans if s[0] == "upload.prepare"]
    assert spans[prep[3]][0] == "upload" and spans[prep[3]][3] == -1
    fills = [s for s in spans if s[0] == "upload.fill"]
    assert len(fills) == _expected_shares(32)
    for s in fills:
        assert prep[1] <= s[1] <= s[2] <= prep[2]
        assert s[3] == -1 and s[5] != prep[5]


def test_the_shared_pool_under_concurrent_callers():
    """More callers than cores, each filling its own slot again and again
    through the one pool, with the interpreter switching threads often:
    every slot ends byte-equal to its own batch."""
    callers, rounds = 2 * len(fused.os.sched_getaffinity(0)), 20
    batches = [_images(32, (20, 45), np.uint8, seed=100 + c) for c in range(callers)]
    wants = [_jax_batch(b) for b in batches]
    bad, errors = [], []

    def caller(c):
        try:
            out = np.empty((32, *PAD), np.uint8)
            for r in range(rounds):
                out.fill(r)
                fill_padded(out, batches[c])
                if not np.array_equal(out, wants[c]):
                    bad.append((c, r))
        except Exception as e:  # reported below: a thread's exception is lost otherwise
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(c,)) for c in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad


# -- the fill's library ----------------------------------------------------------------


@pytest.fixture
def fill_build(tmp_path, monkeypatch):
    """The fill's library built afresh from a copy of its source, into a
    build directory of the test's own."""
    src = tmp_path / "fill.cpp"
    shutil.copy(native._FILL_SRC, src)
    monkeypatch.setattr(native, "_FILL_SRC", str(src))
    monkeypatch.setattr(native, "_FILL_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_FILL_LIB", None)
    monkeypatch.setattr(native, "_FILL_TRIED", False)
    return src


def _rebuild():
    native._FILL_TRIED = False
    return native.fill_library()


def test_an_edited_source_builds_a_library_of_its_own(fill_build):
    """A library built from an older source is never loaded for a newer one:
    the name carries the source's hash."""
    assert _rebuild() is not None
    first = sorted(p.name for p in (fill_build.parent / "build").iterdir())
    fill_build.write_text(fill_build.read_text() + "\n// edited\n")
    assert _rebuild() is not None
    second = sorted(p.name for p in (fill_build.parent / "build").iterdir())
    assert len(first) == 1 and len(second) == 2 and first[0] in second
    assert all(n.startswith("libsuperslam_fill_") and n.endswith(".so") for n in second)
    images = _images(16, (20, 45), np.uint8, seed=12)
    out = np.full((16, *PAD), 0xAB, np.uint8)
    fill_padded(out, images)
    np.testing.assert_array_equal(out, _jax_batch(images))


def test_a_source_that_does_not_build_warns_and_takes_numpy_copies(fill_build):
    fill_build.write_text("this is not C++\n")
    images = _images(16, (20, 45), np.uint8, seed=13)
    out = np.full((16, *PAD), 0xAB, np.uint8)
    with pytest.warns(RuntimeWarning, match="did not build"):
        fill_padded(out, images)
    np.testing.assert_array_equal(out, _jax_batch(images))
    with warnings.catch_warnings():  # tried once a process: no second build, no second warning
        warnings.simplefilter("error")
        assert native.padded_fill(out, images) is None
