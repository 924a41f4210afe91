"""The shared-memory addressing of the fused LightGlue blocks' bf16 linears
(``superslam_tpu_torch/ops/cuda/lightglue_layer.cu``: ``proj_mma_kernel``
and ``tail_mma_kernel``, mma.sync from swizzled row tiles and a cp.async
weight ring), checked on the CPU through its Python model
``lightglue_layer.py::gemm_layout``: the model against the constants of the
CUDA source; every ldmatrix phase (A, and B by ldmatrix.trans), every
cp.async phase and every epilogue store into the row tile free of bank
conflicts and inside its region; the fragments that ldmatrix hands each lane
are the mma.sync m16n8k16 operands of the right rows and columns; the
weight stream covers each matrix once and in k order; and the rotary
epilogue's register pair is the rotary pair. No card and no compiler
needed."""

import os
import re

import pytest

from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl
from superslam_tpu_torch.ops.cuda.lightglue_layer import gemm_layout

CUDA_DIR = os.path.dirname(os.path.abspath(lgl.__file__))
LANES = range(32)
DIM, FF = 256, 512


def _cuda_constants() -> dict[str, int]:
    with open(os.path.join(CUDA_DIR, "lightglue_layer.cu")) as f:
        text = f.read()
    names: dict[str, int] = {}
    for decl in re.findall(r"^constexpr int ([^;]+);", text, flags=re.M):
        for part in re.split(r",\s*(?=\w+ = )", decl):
            name, expr = (x.strip() for x in part.split("=", 1))
            names[name] = int(eval(expr.replace("/", "//"), {}, dict(names)))
    return names


# The tree's tiling and the variants the tuning script builds: (rows,
# warps, ring slots).
TILINGS = [pytest.param(32, 8, 3, id="tree"), pytest.param(16, 8, 3, id="rows16"),
           pytest.param(64, 8, 3, id="rows64"), pytest.param(32, 16, 3, id="warps16"),
           pytest.param(32, 8, 4, id="ring4"), pytest.param(32, 8, 5, id="ring5")]
KERNELS = ["proj", "tail"]


def test_model_matches_the_cuda_constants():
    c = _cuda_constants()
    assert (c["BM"], c["NWARPS"], c["SLOT"], c["RING"]) == (
        lgl.GEMM_ROWS, lgl.GEMM_WARPS, lgl.GEMM_SLOT, lgl.GEMM_RING)
    assert (c["DIM"], c["FF"], c["NTHREADS"]) == (DIM, FF, 32 * lgl.GEMM_WARPS)
    proj, tail = gemm_layout("proj"), gemm_layout("tail")
    assert c["PROJ_SMEM"] == proj["smem_bytes"] <= 232_448
    assert c["TAIL_SMEM"] == tail["smem_bytes"] <= 232_448
    assert c["X_BYTES"] == tail["tiles"]["ctx"][1] and c["H_BYTES"] == tail["tiles"]["h"][1]
    assert c["RED_BYTES"] == tail["red"][1]
    assert [c["OUT_SLICES"], c["W0_SLICES"], c["W3_SLICES"]] == [m[3] for m in tail["stream"]]
    assert c["PROJ_SLICES"] == proj["stream"][0][3]


def _a_loads(m):
    """Yield (label, tile, [32 (row, chunk)]) for every A ldmatrix.x4 of
    every product: per slice, k-step and row tile."""
    for name, n, s0, ns in m["products"]:
        ksr = m["slice_rows"](n)
        for s in range(ns):
            for ks in range(ksr // 16):
                kc = s * ksr // 8 + 2 * ks
                for mt in range(m["rows"] // 16):
                    yield (name, n, s, ks, mt), name, [m["a_lane"](l, mt, kc) for l in LANES]


def _b_loads(m):
    """Yield (label, n, [32 (slice row, chunk)]) for every B
    ldmatrix.x4.trans: per width, k-step, warp and n-tile pair."""
    for n in sorted({p[1] for p in m["products"]}):
        ntw = n // m["warps"] // 8
        for ks in range(m["slice_rows"](n) // 16):
            for w in range(m["warps"]):
                for h in range(ntw // 2):
                    yield (n, ks, w, h), n, [m["b_lane"](l, ks, m["warp_chunk"](w, n), h)
                                             for l in LANES]


def _phases_conflict_free(addrs) -> bool:
    """32 lanes of 16 bytes are served in four phases of 8 lanes; a phase
    is conflict-free when its 8 chunks fall in 8 distinct 16-byte bank
    groups of the 128-byte bank cycle."""
    return all(len({(a % 128) // 16 for a in addrs[8 * p: 8 * p + 8]}) == 8 for p in range(4))


@pytest.mark.parametrize("rows,warps,ring", TILINGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_ldmatrix_phases_are_conflict_free_and_in_bounds(kernel, rows, warps, ring):
    m = gemm_layout(kernel, rows, warps, ring=ring)
    n_a = 0
    for label, tile, rc in _a_loads(m):
        _, nbytes, cpr = m["tiles"][tile]
        addrs = [m["address"](r, c, cpr) for r, c in rc]
        assert _phases_conflict_free(addrs), (label, addrs)
        assert 0 <= min(addrs) and max(addrs) + 16 <= nbytes, label
        n_a += 1
    assert n_a == sum(p[3] * m["slice_rows"](p[1]) // 16 * (rows // 16) for p in m["products"])
    for label, n, rc in _b_loads(m):
        addrs = [m["address"](r, c, n // 8) for r, c in rc]
        assert _phases_conflict_free(addrs), (label, addrs)
        assert 0 <= min(addrs) and max(addrs) + 16 <= m["slot"], label


@pytest.mark.parametrize("rows,warps,ring", TILINGS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_regions_tile_the_shared_memory(kernel, rows, warps, ring):
    m = gemm_layout(kernel, rows, warps, ring=ring)
    regions = sorted([v[:2] for v in m["tiles"].values()] + [m["ring"]]
                     + ([m["red"]] if m["red"] else []))
    off = 0
    for start, nbytes in regions:
        assert start == off and start % 128 == 0
        off += nbytes
    assert off == m["smem_bytes"] <= 232_448
    for _, nbytes, cpr in m["tiles"].values():
        assert nbytes == rows * cpr * 16 and cpr % 8 == 0


@pytest.mark.parametrize("n", [DIM, FF])
def test_slice_copies_fill_the_slot_once_without_conflicts(n):
    """A slice is slot bytes = slice_rows(n) rows of n bf16; copy i (thread
    + round x nthreads) writes chunk address(copy(i)): a bijection onto the
    slot, and each 8-lane phase of a warp's copies hits 8 bank groups."""
    m = gemm_layout("tail")
    nt, cpr = m["nthreads"], n // 8
    assert (m["slot"] // 16) % nt == 0  # uniform rounds
    seen = []
    for base in range(0, m["slot"] // 16, nt):
        for w0 in range(0, nt, 32):
            addrs = [m["address"](*m["copy"](base + w0 + l, n), cpr) for l in LANES]
            assert _phases_conflict_free(addrs)
            seen += addrs
    assert sorted(seen) == list(range(0, m["slot"], 16))
    assert m["slice_rows"](n) * cpr * 16 == m["slot"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_row_tile_loads_cover_the_first_256_columns(kernel):
    """load_rows: copy i fills chunk i & 31 of row i >> 5 (256 bf16 = 32
    chunks a row), in every tile it loads (x, ctx, and x into h's first
    half), conflict-free."""
    m = gemm_layout(kernel)
    nt = m["nthreads"]
    for name, (_, nbytes, cpr) in m["tiles"].items():
        seen = []
        for base in range(0, m["rows"] * 32, nt):
            for w0 in range(0, nt, 32):
                addrs = [m["address"](*m["load"](base + w0 + l), cpr) for l in LANES]
                assert _phases_conflict_free(addrs)
                seen += addrs
        want = {m["address"](r, c, cpr) for r in range(m["rows"]) for c in range(32)}
        assert sorted(seen) == sorted(want) and max(want) + 16 <= nbytes, name


# ---- fragments: what ldmatrix hands a lane against what mma.sync needs ----

def _ldmatrix(lane_rows, trans=False):
    """Per lane, the 4 registers x 2 halves that ldmatrix.x4 returns, as
    (address row, element in the 8-wide chunk) pairs plus the chunk:
    matrix i is addressed by lanes 8i .. 8i + 7; without .trans lane l
    receives row l // 4, elements 2 (l % 4), + 1; with .trans rows 2 (l %
    4), + 1 at element l // 4."""
    out = []
    for l in LANES:
        regs = []
        for i in range(4):
            if trans:
                halves = [(lane_rows[8 * i + 2 * (l % 4) + e], l // 4) for e in (0, 1)]
            else:
                halves = [(lane_rows[8 * i + l // 4], 2 * (l % 4) + e) for e in (0, 1)]
            regs.append([(r, 8 * c + el) for (r, c), el in halves])
        out.append(regs)
    return out


def _a_layout(l, reg, half):
    """m16n8k16 A (row, k): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3
    (g + 8, 2t + 8), + half."""
    g, t = l // 4, l % 4
    return g + 8 * (reg & 1), 2 * t + half + 8 * (reg >> 1)


def _b_layout(l, reg, half):
    """m16n8k16 B (k, n): b0 (2t, g), b1 (2t + 8, g), + half in k."""
    g, t = l // 4, l % 4
    return 2 * t + half + 8 * reg, g


def test_a_fragments_are_the_rows_and_k_of_the_product():
    m = gemm_layout("tail")
    for mt in range(m["rows"] // 16):
        for kc in (0, 2, 30):
            got = _ldmatrix([m["a_lane"](l, mt, kc) for l in LANES])
            for l in LANES:
                for reg in range(4):
                    for half in (0, 1):
                        row, col = got[l][reg][half]
                        r, k = _a_layout(l, reg, half)
                        assert (row, col) == (16 * mt + r, 8 * kc + k)


@pytest.mark.parametrize("n", [DIM, FF])
def test_trans_b_fragments_are_k_and_the_warps_columns(n):
    """ldmatrix.trans on the row-major (k, n) slice: registers 0, 1 are b0,
    b1 of n-tile 2h and registers 2, 3 of n-tile 2h + 1."""
    m = gemm_layout("tail")
    for w in range(m["warps"]):
        wc = m["warp_chunk"](w, n)
        for ks in range(m["slice_rows"](n) // 16):
            for h in range(n // m["warps"] // 16):
                got = _ldmatrix([m["b_lane"](l, ks, wc, h) for l in LANES], trans=True)
                for l in LANES:
                    for reg in range(4):
                        for half in (0, 1):
                            krow, col = got[l][reg][half]
                            k, nn = _b_layout(l, reg & 1, half)
                            nt = 2 * h + (reg >> 1)
                            assert (krow, col) == (16 * ks + k, 8 * wc + 8 * nt + nn)
                            assert col == m["columns"](w, n, nt, 0)[0] + nn


def test_stream_covers_each_matrix_once_in_k_order():
    """Slice s of a product holds k rows s * slice_rows .. and the A chunk
    the product reads for them is k / 8: both walk the matrix once."""
    for kernel in KERNELS:
        m = gemm_layout(kernel)
        assert [p[2] for p in m["products"]] == [sum(x[3] for x in m["stream"][:i])
                                                for i in range(len(m["stream"]))]
        for (name, k, n, slices), (_, pn, _, ns) in zip(m["stream"], m["products"]):
            assert n == pn and ns == slices and slices * m["slice_rows"](n) == k, name
    tail = gemm_layout("tail")
    assert sum(x[3] for x in tail["stream"]) == 28


def test_epilogue_stores_into_the_h_tile_are_conflict_free():
    """msg (columns 256 + c) and gelu (columns c) go into h's tile as one
    4-byte bf16x2 a lane at (row 16 mt + g + 8 hr, columns c, c + 1): each
    warp store hits 32 distinct banks, and every (row, column pair) is
    written once."""
    m = gemm_layout("tail")
    cpr = m["tiles"]["h"][2]
    for n, col0 in ((DIM, DIM), (FF, 0)):
        seen = set()
        for w in range(m["warps"]):
            for nt in range(n // m["warps"] // 8):
                for mt in range(m["rows"] // 16):
                    for hr in (0, 1):
                        addrs = []
                        for l in LANES:
                            c = col0 + m["columns"](w, n, nt, l % 4)[0]
                            r = 16 * mt + l // 4 + 8 * hr
                            addrs.append(m["address"](r, c // 8, cpr) + (c % 8) * 2)
                        assert len({a // 4 % 32 for a in addrs}) == 32
                        seen.update(addrs)
        assert len(seen) == m["rows"] * n // 2


def test_rotary_pair_is_one_lanes_register_pair():
    """The projection's accumulator columns (c, c + 1) of a lane are rotary
    pair (2i, 2i + 1) of one head: c is even and both lie in head c // 64,
    so the rotation needs no other lane."""
    m = gemm_layout("proj")
    pairs = set()
    for w in range(m["warps"]):
        for nt in range(DIM // m["warps"] // 8):
            for t in range(4):
                c0, c1 = m["columns"](w, DIM, nt, t)
                assert c0 % 2 == 0 and c1 == c0 + 1 and c0 // 64 == c1 // 64
                pairs.add((c0 // 64, (c0 % 64) // 2))
    assert pairs == {(h, i) for h in range(4) for i in range(32)}
