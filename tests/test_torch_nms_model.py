"""The NMS kernel's logits mode (``superslam_tpu_torch/ops/cuda/nms.cu``,
``ssl_scores_nms``) on the CPU, without a card or a compiler:

(a) a numpy model of the kernel's block decomposition, with the tile
    constants read from the CUDA source: cell tiles with a one-cell ring,
    zero probability outside the map, each cell's probabilities by
    depth-to-space into the staged pixel tile, the row then the column max,
    the interior stores. With each cell's probabilities taken from the
    plain softmax it equals ``scores_nms_plain`` exactly; with the kernel's
    own arithmetic (the shuffle butterfly in f32) ``pre`` is within 1e-6 of
    it and ``out`` is ``nms_plain(pre)`` bit for bit;
(b) bank models of every shared-memory access of the kernel: the logits
    staging, the per-cell softmax reads, the depth-to-space stores and both
    max passes are free of bank conflicts and stay inside their tiles, at
    the source's tile and the two others ``kernel_variants_torch.py`` times;
(c) ``scores_nms_plain`` against the JAX package's composition (softmax
    over the last axis, depth-to-space, the Pallas NMS in interpret mode);
(d) ``_scores_and_descriptors`` on the CPU against the composition it
    replaces, bit for bit, and the wrapper's input checks."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from superslam_tpu.ops.pallas.nms import nms_suppress as pallas_nms
from superslam_tpu_torch.models import superpoint as spm
from superslam_tpu_torch.ops.cuda import nms as nms_mod
from superslam_tpu_torch.ops.cuda.nms import (
    CELL,
    CHANNELS,
    nms_plain,
    scores_nms,
    scores_nms_plain,
    tile_layout,
)

NMS_CU = os.path.join(os.path.dirname(os.path.abspath(nms_mod.__file__)), "nms.cu")
LANES = np.arange(32)
TILES = [(4, 8), (4, 16), (8, 16)]  # the source's tile and kernel_variants' others


def _cuda_constants() -> dict[str, int]:
    """Every ``constexpr int NAME = expr;`` of nms.cu, evaluated in order."""
    with open(NMS_CU) as f:
        text = f.read()
    names: dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, flags=re.M):
        names[name] = int(eval(expr.replace("/", "//"), {}, dict(names)))
    return names


def _logits(rng, b, h, w) -> np.ndarray:
    """(B, 65, h, w) f32 logits with peaks, as the wrapper's callers pass."""
    return (rng.standard_normal((b, CHANNELS, h, w)) * 4).astype(np.float32)


def _plain_cell_probs(logits: np.ndarray) -> np.ndarray:
    """(B, h, w, 64) probabilities of each cell from the plain softmax."""
    p = torch.softmax(torch.from_numpy(logits), dim=1)[:, :-1].numpy()
    return np.ascontiguousarray(p.transpose(0, 2, 3, 1))


def _kernel_cell_probs(logits: np.ndarray) -> np.ndarray:
    """(B, h, w, 64) probabilities by the kernel's arithmetic in f32: lane l
    holds channels l and l + 32, every lane the dustbin; max and sum by the
    xor butterfly 16, 8, 4, 2, 1, then the dustbin; expf; one divide."""
    x = np.ascontiguousarray(logits.transpose(0, 2, 3, 1))  # NHWC
    a, b, d = x[..., :32], x[..., 32:64], x[..., 64:65]
    m = np.maximum(a, b)
    for o in (16, 8, 4, 2, 1):
        m = np.maximum(m, m[..., LANES ^ o])
    m = np.maximum(m, d)
    ea, eb = np.exp(a - m), np.exp(b - m)
    s = ea + eb
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., LANES ^ o]
    assert (s == s[..., :1]).all()  # the butterfly leaves every lane the same sum
    s = s + np.exp(d - m)
    assert s.dtype == np.float32
    return np.concatenate([ea / s, eb / s], axis=-1)


def _block_model(probs: np.ndarray, radius: int, c: dict[str, int]):
    """The kernel's block decomposition over (B, h, w, 64) cell
    probabilities -> (pre, out), each (B, 8h, 8w). Unwritten tile entries
    are NaN, so a read of one shows in the result."""
    bsz, h, w, _ = probs.shape
    H, W = h * CELL, w * CELL
    TCY, TCX, TH, TW = c["TCY"], c["TCX"], c["TH"], c["TW"]
    SCY, SCX, SH, XP = c["SCY"], c["SCX"], c["SH"], c["XP"]
    pre = np.full((bsz, H, W), np.nan, np.float32)
    out = np.full((bsz, H, W), np.nan, np.float32)
    written = np.zeros((bsz, H, W), np.int32)
    r0, rows, k = CELL - radius, TH + 2 * radius, 2 * radius + 1
    for b in range(bsz):
        for by in range((h + TCY - 1) // TCY):
            for bx in range((w + TCX - 1) // TCX):
                gy = by * TCY - 1 + np.arange(SCY)
                gx = bx * TCX - 1 + np.arange(SCX)
                inside = ((gy >= 0) & (gy < h))[:, None] & ((gx >= 0) & (gx < w))[None, :]
                cells = probs[b, np.clip(gy, 0, h - 1)][:, np.clip(gx, 0, w - 1)]
                cells = np.where(inside[..., None], cells, np.float32(0))  # (SCY, SCX, 64)
                x_s = np.full((SH, XP), np.nan, np.float32)
                # channel cy * 8 + cx of cell (r, c) -> staged pixel (8r + cy, 8c + cx)
                x_s[:, : SCX * CELL] = (
                    cells.reshape(SCY, SCX, CELL, CELL).transpose(0, 2, 1, 3)
                    .reshape(SH, SCX * CELL)
                )
                h_s = np.full((SH, TW), np.nan, np.float32)
                h_s[r0 : r0 + rows] = np.stack(
                    [x_s[r0 : r0 + rows, r0 + d : r0 + d + TW] for d in range(k)]
                ).max(axis=0)
                m = np.stack([h_s[r0 + d : r0 + d + TH] for d in range(k)]).max(axis=0)
                v = x_s[CELL : CELL + TH, CELL : CELL + TW]
                y0, x0 = by * TH, bx * TW
                ny, nx = min(TH, H - y0), min(TW, W - x0)
                pre[b, y0 : y0 + ny, x0 : x0 + nx] = v[:ny, :nx]
                out[b, y0 : y0 + ny, x0 : x0 + nx] = np.where(v == m, v, 0)[:ny, :nx]
                written[b, y0 : y0 + ny, x0 : x0 + nx] += 1
    assert (written == 1).all()  # every pixel stored by exactly one block
    return pre, out


# -- (a) the block decomposition -------------------------------------------


def test_layout_matches_the_cuda_constants():
    c = _cuda_constants()
    assert (c["TCY"], c["TCX"]) == nms_mod.TILE_CELLS and c["NWARPS"] == nms_mod.NWARPS
    assert c["CELL"] == CELL and c["NCH"] == CHANNELS
    layout = tile_layout()
    assert {k: c[k] for k in layout} == layout
    assert c["SMEM_BYTES"] <= 48 * 1024  # the default tile needs no opt-in
    for tcy, tcx in TILES:
        t = tile_layout(tcy, tcx)
        assert t["XP"] % 16 == 8 and t["XP"] >= t["SW"]
        assert t["SH"] * t["TW"] <= t["L_FLOATS"]  # the row-max tile fits the logits' space
        assert t["SMEM_BYTES"] <= 232_448


@pytest.mark.parametrize("radius", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("cells", [(5, 13), (8, 20), (48, 156)])
def test_block_model_equals_plain_exactly(cells, b, radius):
    """Partial tiles in both directions at (5, 13) and (48, 156) (156 =
    19.5 tiles of 8 cells), whole ones at (8, 20) across; each cell's
    probabilities are the plain softmax's, so everything else must match
    bit for bit."""
    rng = np.random.default_rng(cells[0] * 100 + b * 10 + radius)
    logits = _logits(rng, b, *cells)
    pre, out = _block_model(_plain_cell_probs(logits), radius, _cuda_constants())
    ref_out, ref_pre = scores_nms_plain(torch.from_numpy(logits), radius, return_pre=True)
    np.testing.assert_array_equal(pre, ref_pre.numpy())
    np.testing.assert_array_equal(out, ref_out.numpy())
    assert (out > 0).sum() > 0


@pytest.mark.parametrize("cells", [(5, 13), (48, 156)])
def test_block_model_radius_zero_keeps_everything(cells):
    rng = np.random.default_rng(1)
    logits = _logits(rng, 2, *cells)
    pre, out = _block_model(_plain_cell_probs(logits), 0, _cuda_constants())
    ref_out, ref_pre = scores_nms_plain(torch.from_numpy(logits), 0, return_pre=True)
    assert ref_out is ref_pre
    np.testing.assert_array_equal(out, pre)
    np.testing.assert_array_equal(pre, ref_pre.numpy())


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("radius", [0, 4, 8])
def test_kernel_arithmetic_within_1e6_and_seams_exact(tile, radius):
    """The kernel's own softmax arithmetic: pre within 1e-6 of the plain
    softmax (probabilities <= 1, f32 exp and sums in another order), and out
    exactly nms_plain of that pre, so the seams decide as one map would;
    plateaus of equal logits straddle tile seams at every tile size."""
    rng = np.random.default_rng(radius + 10 * tile[1])
    logits = _logits(rng, 2, 13, 37)
    logits[:, :, 3:6, 7:10] = 2.5  # 3 x 3 cells of one value: a plateau across x seams
    logits[:, :, 3:6, 15:18] = 2.5
    c = {**_cuda_constants(), **tile_layout(*tile), "TCY": tile[0], "TCX": tile[1]}
    pre, out = _block_model(_kernel_cell_probs(logits), radius, c)
    ref_out, ref_pre = scores_nms_plain(torch.from_numpy(logits), radius, return_pre=True)
    assert np.abs(pre - ref_pre.numpy()).max() <= 1e-6
    expect = pre if radius == 0 else nms_plain(torch.from_numpy(pre), radius).numpy()
    np.testing.assert_array_equal(out, expect)
    # The peak sets of the kernel's arithmetic and the plain one: printed by
    # chip_smoke on the card, not gated; here at least most agree.
    agree = ((out > 0) == (ref_out.numpy() > 0)).mean()
    assert agree > 0.99


# -- (b) bank models --------------------------------------------------------


def _conflicts(words) -> int:
    """Extra wavefronts of one 32-lane access of 4-byte words: per bank, the
    number of distinct words less one (a shared word is a broadcast)."""
    banks: dict[int, set[int]] = {}
    for a in words:
        banks.setdefault(a % 32, set()).add(a)
    return max(len(s) for s in banks.values()) - 1


def _conflicts16(words) -> int:
    """A 32-lane access of 16 bytes a lane (float4, word-aligned start) in
    four phases of 8 lanes; the extra wavefronts of the worst phase."""
    worst = 0
    for ph in range(4):
        lanes = words[8 * ph : 8 * ph + 8]
        worst = max(worst, _conflicts([a + j for a in lanes for j in range(4)]))
    return worst


def _warps(n: int, nthreads: int):
    """The flat loop ``for (i = tid; i < n; i += NTHREADS)``: per warp and
    trip, the 32 lanes' i (None where the loop has ended for the lane)."""
    for base in range(0, n, nthreads):
        for w0 in range(base, min(base + nthreads, n), 32):
            yield [i if i < n else None for i in range(w0, w0 + 32)]


def _accesses(tile, radius):
    """Every shared-memory access of one block of the logits mode, as
    (what, word addresses of the 32 lanes, 4 or 16 bytes a lane, region)."""
    t = tile_layout(*tile)
    nthreads = 32 * nms_mod.NWARPS
    XP, TW, TH = t["XP"], t["TW"], t["TH"]
    L0 = t["X_FLOATS"]  # the logits tile, then the row maxima
    span = t["SPAN"]
    # A staged row's cells in the map are floats [lo, hi) of its span: all,
    # or without the ring cell left of the map, or only those left of the
    # map's right edge.
    for lo, hi in ((0, span), (CHANNELS, span), (0, span - 3 * CHANNELS)):
        for r in range(t["SCY"]):
            for lanes in _warps(hi - lo, nthreads):
                yield "logits store", [
                    L0 + r * span + lo + i for i in lanes if i is not None], 4, "l"
    for q in range(t["SCY"] * t["SCX"]):
        r, c = divmod(q, t["SCX"])
        yield "softmax read a", [L0 + q * CHANNELS + ln for ln in LANES], 4, "l"
        yield "softmax read b", [L0 + q * CHANNELS + ln + 32 for ln in LANES], 4, "l"
        yield "softmax read dustbin", [L0 + q * CHANNELS + 64] * 32, 4, "l"
        corner = r * CELL * XP + c * CELL
        for half in (0, 4):
            yield "depth-to-space store", [
                corner + ((ln >> 3) + half) * XP + (ln & 7) for ln in LANES], 4, "x"
    r0 = CELL - radius
    for lanes in _warps((TH + 2 * radius) * TW, nthreads):
        rc = [(r0 + i // TW, i % TW) for i in lanes if i is not None]
        for d in range(2 * radius + 1):
            yield "row pass read", [r * XP + cc + r0 + d for r, cc in rc], 4, "xr"
        yield "row pass store", [L0 + r * TW + cc for r, cc in rc], 4, "h"
    for lanes in _warps(TH * TW // 4, nthreads):
        rc = [(i // (TW // 4), (i % (TW // 4)) * 4) for i in lanes if i is not None]
        for d in range(2 * radius + 1):
            yield "column pass read", [L0 + (r0 + r + d) * TW + cc for r, cc in rc], 16, "hr"
        yield "center read", [(r + CELL) * XP + cc + CELL for r, cc in rc], 16, "x"


@pytest.mark.parametrize("radius", [0, 1, 4, 8])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_shared_memory_accesses_conflict_free_and_in_bounds(tile, radius):
    t = tile_layout(*tile)
    L0, XP, SW, TW = t["X_FLOATS"], t["XP"], t["SW"], t["TW"]
    r0, rows = CELL - radius, t["TH"] + 2 * radius
    seen = set()
    for what, words, width, region in _accesses(tile, radius):
        seen.add(what)
        extra = _conflicts16(words) if width == 16 else _conflicts(words)
        assert extra == 0, (tile, radius, what, words)
        for a in words:
            if region.startswith("x"):
                assert 0 <= a < L0 and a % XP < SW, (what, a)  # never the pitch's pad
            elif region == "hr":  # rows the row pass wrote
                assert r0 <= (a - L0) // TW < r0 + rows, (what, a)
            else:
                assert L0 <= a < L0 + t["L_FLOATS"], (what, a)
            if width == 16:
                assert a % 4 == 0, (what, a)  # 16-byte aligned float4
    assert len(seen) == 9


# -- (c) the JAX package ----------------------------------------------------


def test_scores_nms_plain_matches_jax_composition():
    """superpoint_dense's score half in the JAX package on the same logits:
    softmax over the NHWC channel axis, the dustbin dropped, depth-to-space,
    the Pallas NMS in interpret mode. pre within 1e-6 (f32 softmax in
    another order); the same peaks, with values within 1e-6."""
    rng = np.random.default_rng(9)
    logits = _logits(rng, 2, 6, 13)  # H = 48 (the Pallas kernel's 16-row blocks)
    x = jnp.asarray(logits.transpose(0, 2, 3, 1))
    s = jax.nn.softmax(x, axis=-1)[..., :-1]
    b, h, w, _ = s.shape
    s = s.reshape(b, h, w, CELL, CELL).transpose(0, 1, 3, 2, 4).reshape(b, h * CELL, w * CELL)
    ref_out = np.asarray(pallas_nms(s, 4, interpret=True))
    out, pre = scores_nms_plain(torch.from_numpy(logits), 4, return_pre=True)
    np.testing.assert_allclose(pre.numpy(), np.asarray(s), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out.numpy() > 0, ref_out > 0)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-6, rtol=0)
    assert (ref_out > 0).sum() > 50


# -- (d) the main path on the CPU and the wrapper ----------------------------


def _old_composition(logits, desc, radius, dtype, return_pre):
    """_scores_and_descriptors as it stood before the logits mode."""
    scores = torch.softmax(logits, dim=1)[:, :-1]
    b, _, h, w = scores.shape
    scores = scores.reshape(b, CELL, CELL, h, w).permute(0, 3, 1, 4, 2)
    scores = scores.reshape(b, h * CELL, w * CELL).contiguous()
    pre = scores
    if radius > 0:
        scores = nms_plain(scores, radius)
    sq = torch.sum(torch.square(desc.float()), dim=1, keepdim=True)
    desc = desc * torch.rsqrt(sq + 1e-12).to(dtype)
    desc = desc.permute(0, 2, 3, 1).contiguous()
    return (scores, desc, pre) if return_pre else (scores, desc)


@pytest.mark.parametrize("return_pre", [False, True])
@pytest.mark.parametrize("radius", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scores_and_descriptors_cpu_bit_identical(dtype, radius, return_pre):
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(_logits(rng, 2, 6, 10)).contiguous(
        memory_format=torch.channels_last)  # as the head's convs give them
    desc = torch.from_numpy(rng.standard_normal((2, 256, 6, 10)).astype(np.float32)).to(dtype)
    got = spm._scores_and_descriptors(logits, desc, radius, dtype, return_pre)
    ref = _old_composition(logits, desc, radius, dtype, return_pre)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    # A map-to-map nms keeps the composition.
    again = spm._scores_and_descriptors(logits, desc, radius, dtype, return_pre, nms=nms_plain)
    for g, r in zip(again, ref):
        assert torch.equal(g, r)


def test_scores_nms_checks_its_input():
    x = torch.zeros(1, CHANNELS, 4, 4)
    for bad, match in (
        (x.to(torch.bfloat16), "f32"), (x[:, :64], "f32"), (x[0], "f32"),
    ):
        with pytest.raises(ValueError, match=match):
            scores_nms(bad)
    for radius in (-1, 9):
        with pytest.raises(ValueError, match="radius"):
            scores_nms(x, radius)
    out, pre = scores_nms(x, 4)
    assert out.shape == (1, 32, 32) and pre is None


def test_scores_nms_does_not_fall_back_off_cpu():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (here: the meta device raises)."""
    with pytest.raises(ValueError, match="device"):
        scores_nms(torch.empty(1, CHANNELS, 4, 4, device="meta"))
