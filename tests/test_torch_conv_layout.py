"""The shared-memory addressing of the mma.sync conv pair
(``superslam_tpu_torch/ops/cuda/conv_pair_mma.cu``, CIN 64 and the gray
CIN 1) and of the single conv (``conv3x3_mma.cu``, CIN 64), checked on the
CPU through their Python model ``conv.py::mma_layout``:
the model against the constants of the CUDA source, every ldmatrix phase
and every store phase of the gray pair's conv_a prologue free of bank
conflicts, every address inside its allocation, and the flat runs' overrun
rows feeding only discarded outputs. No card and no compiler needed."""

import os
import re

import pytest

from superslam_tpu_torch.ops.cuda import conv as conv_mod
from superslam_tpu_torch.ops.cuda.conv import mma_layout

CUDA_DIR = os.path.dirname(os.path.abspath(conv_mod.__file__))
LANES = range(32)
KSTEPS = range(4)  # 64 input channels = 4 k-steps of 16


def _cuda_constants(kernel: str = "conv_pair_mma.cu") -> dict[str, int]:
    """Every ``constexpr int NAME = expr;`` of the engine header and the
    kernel source, evaluated in order."""
    names: dict[str, int] = {}
    for fname in ("conv_mma.cuh", kernel):
        with open(os.path.join(CUDA_DIR, fname)) as f:
            text = f.read()
        for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
            names[name] = int(eval(expr.replace("/", "//"), {}, dict(names)))
    return names


# (CIN, region) cases; the CIN = 64 ids are the regions' names.
CASES = [pytest.param(64, t, id=t) for t in ("x", "a", "w")] + [
    pytest.param(1, t, id=f"gray-{t}") for t in ("a", "w")
] + [pytest.param(64, t, id=f"conv3x3-{t[0]}") for t in ("x3", "w3")]
# The regions of one kernel's shared memory, in order.
REGIONS = {"x3": ("x3", "w3"), "w3": ("x3", "w3")}
NTHREADS = 384


def _ldmatrix_rows(tile: str, cin: int = 64):
    """Yield (label, [32 byte addresses]) for every ldmatrix.x4 the kernel
    issues on one region: per run, tap and k-step for the tiles, per k-step
    and 16-row group of every ring slot for the weights."""
    m = mma_layout(tile, cin)
    if tile in ("w", "w3"):
        for slot in range(m["rows"]):
            for ks in KSTEPS:
                for h in range(m["pitch"] // 16):
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


def _phases_conflict_free(addrs) -> bool:
    """A 32-lane access of 16 bytes a lane is served in four phases of 8
    lanes; a phase is conflict-free when its eight 16-byte rows fall in
    eight distinct 16-byte bank groups of the 128-byte bank cycle."""
    return all(
        len({(a % 128) // 16 for a in addrs[8 * phase : 8 * phase + 8]}) == 8
        for phase in range(4)
    )


@pytest.mark.parametrize("cin,tile", CASES)
def test_ldmatrix_phases_are_conflict_free(cin, tile):
    """ldmatrix.x4 serves its 32 row addresses in four phases of 8 lanes."""
    n = 0
    for label, addrs in _ldmatrix_rows(tile, cin):
        assert _phases_conflict_free(addrs), (cin, tile, label, addrs)
        n += 1
    slot_groups = mma_layout("w3" if tile.endswith("3") else "w", cin)["pitch"] // 16
    assert n == {"x": 41 * 9 * 4, "a": 34 * 9 * 4, "x3": 34 * 9 * 4}.get(tile, 3 * 4 * slot_groups)


@pytest.mark.parametrize("cin,tile", CASES)
def test_every_read_stays_inside_its_allocation(cin, tile):
    m = mma_layout(tile, cin)
    lo = min(min(a) for _, a in _ldmatrix_rows(tile, cin))
    hi = max(max(a) for _, a in _ldmatrix_rows(tile, cin)) + 16
    assert 0 <= lo and hi <= m["nbytes"] <= m["region"], (tile, lo, hi, m["nbytes"])
    regions = [mma_layout(t, cin) for t in REGIONS.get(tile, ("x", "a", "w"))]
    offsets = [sum(r["region"] for r in regions[:i]) for i in range(len(regions))]
    assert [r["offset"] for r in regions] == offsets
    assert sum(r["region"] for r in regions) == m["smem_bytes"] <= 232_448


@pytest.mark.parametrize("cin,tile", CASES)
def test_swizzle_permutes_the_chunks_of_every_row(cin, tile):
    """The fills (cp.async of the input tile and of a ring slot, the
    overrun rows' zeroing, conv_a's epilogue or prologue) write chunk j of
    row p at address(p, j): a bijection onto the region, one 128-byte row
    per p."""
    m = mma_layout(tile, cin)
    rows = m["pitch"] * m["rows"]
    addrs = {m["address"](p, j) for p in range(rows) for j in range(8)}
    assert addrs == set(range(0, m["nbytes"], 16))
    for p in range(rows):
        assert {m["address"](p, j) // 128 for j in range(8)} == {p}


def test_ring_slice_is_one_cp_async_per_thread():
    """256 threads fill a 32-row slot: thread t copies chunk t & 7 of row
    t >> 3, and the 256 chunks are the whole slot. A 64-row slot (the gray
    pair in one pass) takes copies i = t, t + 384: chunk i & 7 of row i >> 3."""
    m = mma_layout("w")
    addrs = {m["address"](t >> 3, t & 7) for t in range(256)}
    assert addrs == set(range(0, m["pitch"] * 128, 16))
    m = mma_layout("w", 1)
    copies = [i for t in range(NTHREADS) for i in range(t, m["pitch"] * 8, NTHREADS)]
    assert sorted(copies) == list(range(m["pitch"] * 8))
    assert {m["address"](i >> 3, i & 7) for i in copies} == set(range(0, m["pitch"] * 128, 16))


@pytest.mark.parametrize("tile", ["x", "a", "x3"])
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
    # The gray pair (CIN = 1): image tile, one ring slot of 64 / NPASS1 rows.
    gx, ga, gw = (mma_layout(t, 1) for t in ("x", "a", "w"))
    assert (c["IMG_R"], c["IMG_BYTES"]) == (gx["rows"], gx["nbytes"]) and gx["pitch"] == c["XP"]
    assert c["NPASS1"] == conv_mod.GRAY_PASSES and gw["pitch"] == 8 * c["NT1"]
    assert gx["smem_bytes"] == c["X_BYTES"] + c["A_BYTES"] + c["RING"] * gw["pitch"] * 128
    assert c["MAXR1"] * c["NWARPS"] >= c["NRUN_B"] and (ga["pitch"], ga["rows"]) == (a["pitch"], a["rows"])
    assert c["NTHREADS"] == NTHREADS and gx["valid"] == x["valid"]


def test_gray_image_tile_fits_and_feeds_the_prologue():
    """The f32 image tile (20 x 36) lies in the input region beside nothing
    else (the pool staging aliases it only after conv_a is written), and
    conv_a pixel (r, c) of the 18 x 34 tile reads image pixels (r + ky,
    c + kx), all inside the tile; the 4-byte copies cover it exactly."""
    m = mma_layout("x", 1)
    assert m["nbytes"] == 20 * 36 * 4 <= m["region"]
    assert _cuda_constants()["HP_BYTES"] <= m["region"]
    keep_r, keep_c = m["valid"]
    reads = {m["address"](r * m["pitch"] + c + off)
             for r in range(keep_r) for c in range(keep_c) for off in m["tap_offsets"]}
    assert min(reads) == 0 and max(reads) + 4 == m["nbytes"]
    copies = {m["address"](i) for i in range(m["rows"] * m["pitch"])}
    assert copies == set(range(0, m["nbytes"], 4))


def test_gray_prologue_stores_are_conflict_free_and_cover_the_tile():
    """Thread t stores chunk t & 7 of conv_a tile pixels (t >> 3) + 48k as
    16-byte stores: in every warp's store the 8 lanes of each phase write
    the 8 chunks of one 128-byte row (no bank conflict), and together the
    stores write every chunk of the 18 x 34 data rows exactly once, never
    the overrun row (zeroed apart)."""
    m = mma_layout("a", 1)
    n_pix, rounds = m["prologue_pixels"], -(-m["prologue_pixels"] // (NTHREADS // 8))
    written = []
    for warp in range(NTHREADS // 32):
        for k in range(rounds):
            items = [m["prologue"](warp * 32 + lane, k) for lane in range(32)]
            live = [(p, j) for p, j in items if p < n_pix]
            if not live:
                continue
            assert len(live) == 32  # whole warps: 612 pixels = 153 warps of 4
            addrs = [m["address"](p, j) for p, j in live]
            assert _phases_conflict_free(addrs), (warp, k, addrs)
            written += addrs
    assert sorted(written) == list(range(0, n_pix * 128, 16))
    assert n_pix == (m["rows"] - 1) * m["pitch"]


def test_conv3x3_model_matches_the_cuda_constants():
    """conv3x3_mma.cu's tile is the pair's conv_a tile (pitch 34, 18 + 1
    overrun rows, 34 runs) at offset 0, followed by its ring of 64 /
    NPASS3-row slots."""
    c = _cuda_constants("conv3x3_mma.cu")
    x, w = mma_layout("x3"), mma_layout("w3")
    assert (c["AP3"], c["AR3"], c["NRUN3"]) == (x["pitch"], x["rows"], len(x["run_starts"]))
    assert (x["pitch"], x["rows"]) == (mma_layout("a")["pitch"], mma_layout("a")["rows"])
    assert c["X3_BYTES"] == x["nbytes"] == x["region"] == w["offset"]
    assert c["NPASS3"] == conv_mod.CONV3X3_PASSES and c["SLOT_CO3"] == w["pitch"]
    assert c["RING3"] == w["rows"] and c["SMEM3_BYTES"] == x["smem_bytes"] == w["smem_bytes"]
    assert x["smem_bytes"] == 82_688 + 3 * w["pitch"] * 128 <= 232_448
    assert c["MAXR3"] * c["NWARPS3"] >= c["NRUN3"] and c["NT3"] * 8 == w["pitch"]
    assert x["valid"] == (c["TH3"], c["TW3"])
    assert c["GRAY_SMEM_BYTES"] == conv_mod.CONV3X3_GRAY_SMEM_BYTES


def test_conv3x3_tile_and_ring_fills_cover_their_regions_once():
    """The input tile arrives by one 16-byte cp.async per chunk: copy i is
    chunk i & 7 of pixel i >> 3, for every pixel of the 19 x 34 tile; the
    copies of row 18 (the overrun row) and of pixels outside the image
    zero-fill. A ring slot of 64 / NPASS3 rows takes copies i = t, t +
    NTHREADS3, ...: chunk i & 7 of weight row i >> 3."""
    c = _cuda_constants("conv3x3_mma.cu")
    x, w = mma_layout("x3"), mma_layout("w3")
    n = x["rows"] * x["pitch"] * 8
    copies = [i for t in range(c["NTHREADS3"]) for i in range(t, n, c["NTHREADS3"])]
    assert sorted(copies) == list(range(n))
    assert sorted(x["address"](i >> 3, i & 7) for i in copies) == list(range(0, x["nbytes"], 16))
    zero_filled = {i >> 3 for i in copies if (i >> 3) // x["pitch"] >= c["TH3"] + 2}
    assert zero_filled == set(range((x["rows"] - 1) * x["pitch"], x["rows"] * x["pitch"]))
    slot = w["pitch"] * 8
    copies = [i for t in range(c["NTHREADS3"]) for i in range(t, slot, c["NTHREADS3"])]
    assert sorted(copies) == list(range(slot))
    assert {w["address"](i >> 3, i & 7) for i in copies} == set(range(0, w["pitch"] * 128, 16))
