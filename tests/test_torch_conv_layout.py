"""The shared-memory addressing of the mma.sync conv pair
(``superslam_tpu_torch/ops/cuda/conv_pair_mma.cu``), checked on the CPU
through its Python model ``conv.py::mma_layout``: the model against the
constants of the CUDA source, every ldmatrix phase free of bank conflicts,
every address inside its allocation, and the flat runs' overrun rows
feeding only discarded outputs. No card and no compiler needed."""

import os
import re

import pytest

from superslam_tpu_torch.ops.cuda import conv as conv_mod
from superslam_tpu_torch.ops.cuda.conv import mma_layout

CUDA_DIR = os.path.dirname(os.path.abspath(conv_mod.__file__))
LANES = range(32)
KSTEPS = range(4)  # 64 input channels = 4 k-steps of 16


def _cuda_constants() -> dict[str, int]:
    """Every ``constexpr int NAME = expr;`` of the engine header and the
    kernel source, evaluated in order."""
    names: dict[str, int] = {}
    for fname in ("conv_mma.cuh", "conv_pair_mma.cu"):
        with open(os.path.join(CUDA_DIR, fname)) as f:
            text = f.read()
        for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
            names[name] = int(eval(expr.replace("/", "//"), {}, dict(names)))
    return names


def _ldmatrix_rows(tile: str):
    """Yield (label, [32 byte addresses]) for every ldmatrix.x4 the kernel
    issues on one region: per run, tap and k-step for the tiles, per k-step
    and 16-row half of every ring slot for the weights."""
    m = mma_layout(tile)
    if tile == "w":
        for slot in range(m["rows"]):
            for ks in KSTEPS:
                for h in range(2):
                    rows = [m["lane"](l, ks) for l in LANES]
                    yield (slot, ks, h), [
                        m["address"](slot * m["pitch"] + 16 * h + r, j) for r, j in rows
                    ]
        return
    for run in m["run_starts"]:
        for tap, off in enumerate(m["tap_offsets"]):
            for ks in KSTEPS:
                rows = [m["lane"](l, ks) for l in LANES]
                yield (run, tap, ks), [m["address"](run + off + r, j) for r, j in rows]


@pytest.mark.parametrize("tile", ["x", "a", "w"])
def test_ldmatrix_phases_are_conflict_free(tile):
    """ldmatrix.x4 serves its 32 row addresses in four phases of 8 lanes;
    a phase is conflict-free when its eight 16-byte rows fall in eight
    distinct 16-byte bank groups of the 128-byte bank cycle."""
    n = 0
    for label, addrs in _ldmatrix_rows(tile):
        for phase in range(4):
            groups = {(a % 128) // 16 for a in addrs[8 * phase : 8 * phase + 8]}
            assert len(groups) == 8, (tile, label, phase, addrs[8 * phase : 8 * phase + 8])
        n += 1
    assert n == {"x": 41 * 9 * 4, "a": 34 * 9 * 4, "w": 3 * 4 * 2}[tile]


@pytest.mark.parametrize("tile", ["x", "a", "w"])
def test_every_read_stays_inside_its_allocation(tile):
    m = mma_layout(tile)
    lo = min(min(a) for _, a in _ldmatrix_rows(tile))
    hi = max(max(a) for _, a in _ldmatrix_rows(tile)) + 16
    assert 0 <= lo and hi <= m["nbytes"], (tile, lo, hi, m["nbytes"])
    regions = [mma_layout(t) for t in ("x", "a", "w")]
    assert [r["offset"] for r in regions] == [0, regions[0]["nbytes"],
                                              regions[0]["nbytes"] + regions[1]["nbytes"]]
    assert sum(r["nbytes"] for r in regions) == m["smem_bytes"] <= 232_448


@pytest.mark.parametrize("tile", ["x", "a", "w"])
def test_swizzle_permutes_the_chunks_of_every_row(tile):
    """The fills (cp.async of the input tile and of a ring slot, the
    overrun rows' zeroing, conv_a's epilogue) write chunk j of row p at
    address(p, j): a bijection onto the region, one 128-byte row per p."""
    m = mma_layout(tile)
    rows = m["pitch"] * m["rows"]
    addrs = {m["address"](p, j) for p in range(rows) for j in range(8)}
    assert addrs == set(range(0, m["nbytes"], 16))
    for p in range(rows):
        assert {m["address"](p, j) // 128 for j in range(8)} == {p}


def test_ring_slice_is_one_cp_async_per_thread():
    """256 threads fill a 32-row slot: thread t copies chunk t & 7 of row
    t >> 3, and the 256 chunks are the whole slot."""
    m = mma_layout("w")
    addrs = {m["address"](t >> 3, t & 7) for t in range(256)}
    assert addrs == set(range(0, m["pitch"] * 128, 16))


@pytest.mark.parametrize("tile", ["x", "a"])
def test_runs_cover_the_kept_pixels_and_overrun_feeds_only_discards(tile):
    """Each pixel the stage keeps is one row of exactly one run, and its
    nine taps read only rows that hold data (input rows 0-19, conv_a rows
    0-17): the overrun row, and conv_a's columns past the tile, feed only
    the discarded columns that wrap past the tile edge."""
    m = mma_layout(tile)
    pitch, (keep_r, keep_c) = m["pitch"], m["valid"]
    data_rows = m["rows"] - 1
    kept = []
    for run in m["run_starts"]:
        for i in range(16):
            f = run + i
            r, c = divmod(f, pitch)
            if r < keep_r and c < keep_c:
                kept.append((r, c))
                for off in m["tap_offsets"]:
                    assert (f + off) // pitch < data_rows, (tile, f, off)
    assert sorted(kept) == [(r, c) for r in range(keep_r) for c in range(keep_c)]


def test_pool_pairs_are_lanes_four_apart():
    """The pooled epilogue's __shfl_xor(v, 4) pairs GEMM rows g and g ^ 1
    (g even): conv_b pixels f and f + 1 in one tile row, columns 2k and
    2k + 1, for every run; the staging tile fits the dead input tile."""
    m = mma_layout("a")
    for run in m["run_starts"]:
        for g in range(0, 16, 2):
            r0, c0 = divmod(run + g, m["pitch"])
            r1, c1 = divmod(run + g + 1, m["pitch"])
            assert r0 == r1 and c0 % 2 == 0 and c1 == c0 + 1
    consts = _cuda_constants()
    assert consts["HP_BYTES"] <= mma_layout("x")["nbytes"]
    assert consts["HP_PITCH"] >= 64 and consts["HP_PITCH"] % 4 == 0  # float4 reads


def test_model_matches_the_cuda_constants():
    c = _cuda_constants()
    x, a, w = (mma_layout(t) for t in ("x", "a", "w"))
    assert (c["XP"], c["XR"], c["AP"], c["AR"]) == (x["pitch"], x["rows"], a["pitch"], a["rows"])
    assert (c["NRUN_A"], c["NRUN_B"]) == (len(x["run_starts"]), len(a["run_starts"]))
    assert (c["X_BYTES"], c["A_BYTES"]) == (x["nbytes"], a["nbytes"])
    assert (c["RING"], c["SLICE_CO"], c["SLICE_BYTES"]) == (w["rows"], w["pitch"], w["nbytes"] // 3)
    assert c["SMEM_BYTES"] == x["smem_bytes"] == 191_744
    assert c["PIX_BYTES"] == 128 and c["CH"] == 64
    assert c["MAXR"] * c["NWARPS"] >= c["NRUN_A"] and c["NSTEP"] == 2 * 2 * 9
    assert (x["valid"], a["valid"]) == ((c["TH"] + 2, c["TW"] + 2), (c["TH"], c["TW"]))
