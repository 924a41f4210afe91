"""The attention backward's tensor-core design (``superslam_tpu_torch/ops/
cuda/attention_bwd.cu``), checked on the CPU without a card or a compiler:

- its shared-memory address model (``attention.py::bwd_layout``) against
  the constants of the CUDA source, every fragment load phase free of bank
  conflicts and inside its plane, the staging stores and the reduction
  scratch likewise;
- a PyTorch model of the kernels' arithmetic: residuals (O, m, 1/l) from
  the plain forward, delta = dO . O, key tiles without a real key skipped,
  every tile product in emulated 3xTF32 (TF32 rounding on the int32 view),
  against ``masked_attention_backward_plain``; and the same model with one
  TF32 product, which misses the limit: why the kernels split.
"""

import os
import re

import numpy as np
import pytest
import torch

from superslam_tpu_torch.ops.cuda import attention as attn
from superslam_tpu_torch.ops.cuda.attention import (
    attention_row_stats_plain,
    bwd_layout,
    masked_attention_backward_plain,
    masked_attention_plain,
)

CUDA_DIR = os.path.dirname(os.path.abspath(attn.__file__))
BWD_WALK_ROWS = attn.BWD_WALK
LANES = range(32)
D = 64
NEG = -1e9


def _cuda_constants() -> dict[str, int]:
    with open(os.path.join(CUDA_DIR, "attention_bwd.cu")) as f:
        text = f.read()
    names: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        names[name] = int(eval(expr.replace("/", "//"), {}, dict(names)))
    return names


# The tree's tiling and the variant with 32-row blocks.
LAYOUTS = [pytest.param(64, 64, 2, id="tree"), pytest.param(32, 64, 2, id="rows32")]


def test_layout_matches_the_cuda_constants():
    c = _cuda_constants()
    m = bwd_layout()
    assert (c["BR"], c["BC"], c["WC"]) == (attn.BWD_ROWS, attn.BWD_WALK, attn.BWD_WARP_COLS)
    assert c["OWN"] + c["WALK"] == m["raw"][0] and c["RAW"] == m["raw"][1]
    assert (c["D"], c["LD"], c["RLD"]) == (D, m["pitch"], m["red_pitch"])
    assert c["SMEM_BYTES"] == m["smem_bytes"] <= 232_448
    assert c["NTHREADS"] == m["nthreads"] and c["NTC"] == m["ntc"]
    assert c["OWN"] == m["planes"]["walk0b"][0] and sum(m["raw"]) == m["vectors"][0]
    assert len(m["warps"]) == c["NWARPS"] and c["CW"] == 8 * m["ntc"]


def _warp_loads(m):
    """Yield (label, plane rows, [32 word offsets]) for every fragment load
    a warp issues from a staged plane: A and B of the S-type products (mm_rows),
    B of the products with a register A (mm_acc)."""
    ntc = m["ntc"]
    for w, (m0, n0) in enumerate(m["warps"]):
        for k0 in range(0, D, 8):
            for reg in range(4):
                yield ("a_rows", w, k0, reg), "own", [m["a_rows"](l, m0, k0, reg) for l in LANES]
            for nt in range(ntc):
                for reg in range(2):
                    yield ("b_rows", w, k0, nt, reg), "walk", [
                        m["b_rows"](l, n0 + 8 * nt, k0, reg) for l in LANES]
        for kk in range(ntc):
            for nt in range(8):
                for reg in range(2):
                    yield ("b_perm", w, kk, nt, reg), "walk", [
                        m["b_perm"](l, n0, kk, nt, reg) for l in LANES]


@pytest.mark.parametrize("rows,walk,warp_cols", LAYOUTS)
def test_fragment_loads_are_conflict_free_and_in_bounds(rows, walk, warp_cols):
    """Each fragment load is one 4-byte word a lane: conflict-free when the
    32 lanes fall in 32 distinct banks. In the dk/dv kernel the S-type
    products also read their A from the own planes and the B of the
    permuted products from the walked ones, the same patterns; every plane
    is read at most at its last row."""
    m = bwd_layout(rows, walk, warp_cols)
    n = 0
    for label, kind, words in _warp_loads(m):
        assert len({w % 32 for w in words}) == 32, (label, words)
        size = (rows if kind == "own" else walk) * m["pitch"]
        assert 0 <= min(words) and max(words) < size, (label, max(words), size)
        # no read of a pad column: they hold nothing
        assert all(w % m["pitch"] < D for w in words), label
        n += 1
    ntc, nw = m["ntc"], len(m["warps"])
    assert n == nw * (8 * (4 + 2 * ntc) + ntc * 8 * 2)


@pytest.mark.parametrize("rows,walk,warp_cols", LAYOUTS)
def test_planes_tile_the_shared_memory(rows, walk, warp_cols):
    m = bwd_layout(rows, walk, warp_cols)
    off = 0
    for name in ("own0b", "own0s", "own1b", "own1s", "walk0b", "walk0s", "walk1b", "walk1s"):
        start, n = m["planes"][name]
        assert start == off and n == (rows if name.startswith("own") else walk)
        assert start % 4 == 0  # 16-byte staging stores
        off += n * m["pitch"]
    assert m["raw"] == (off, 3 * walk * D) and m["raw"][0] % 4 == 0
    off += m["raw"][1]
    assert m["vectors"][0] == off and 4 * (off + m["vectors"][1]) == m["smem_bytes"] <= 232_448
    # The reduction scratch (dV's rows, then dK's) lies inside the walked planes.
    start, n = m["red_region"]
    assert start == m["planes"]["walk0b"][0]
    assert start + n * m["red_pitch"] <= m["vectors"][0]


@pytest.mark.parametrize("rows,walk,warp_cols", LAYOUTS)
def test_staging_stores_are_conflict_free_and_cover_the_planes(rows, walk, warp_cols):
    """A 16-byte store a lane is served in four phases of 8 lanes, each
    conflict-free when its 8 chunks fall in 8 distinct 16-byte bank groups.
    Staging index i writes chunk i & 15 of row i >> 4; the uniform rounds of
    nthreads indices cover every data word of a plane once, never a pad."""
    m = bwd_layout(rows, walk, warp_cols)
    nt = m["nthreads"]
    for n_rows in (rows, walk):
        assert (n_rows * 16) % nt == 0  # uniform loops: the delta shuffles need whole warps
        written = []
        for base in range(0, n_rows * 16, nt):
            for w0 in range(0, nt, 32):
                words = [m["stage"](base + w0 + l) for l in LANES]
                addrs = [r * m["pitch"] + c for r, c in words]
                for ph in range(4):
                    assert len({(a // 4) % 8 for a in addrs[8 * ph: 8 * ph + 8]}) == 8
                # the 16 lanes of a row's chunks are one half-warp (delta's shuffle)
                assert all(words[l][0] == words[l ^ 8][0] for l in LANES)
                written += addrs
        assert sorted(written) == [r * m["pitch"] + c for r in range(n_rows) for c in range(0, D, 4)]


@pytest.mark.parametrize("rows,walk,warp_cols", LAYOUTS)
def test_reduction_scratch_is_conflict_free(rows, walk, warp_cols):
    """float2 stores and loads: two half-warp phases, each conflict-free when
    its 16 lanes' 8-byte words cover 32 distinct banks."""
    m = bwd_layout(rows, walk, warp_cols)
    seen = set()
    for m0, _ in m["warps"]:
        for nt in range(8):
            for hr in range(2):
                addrs = [m["red"](l, m0, nt, hr) for l in LANES]
                for ph in range(2):
                    banks = {(a + e) % 32 for a in addrs[16 * ph: 16 * ph + 16] for e in (0, 1)}
                    assert len(banks) == 32
                seen.update(addrs)
    assert max(seen) + 2 <= rows * m["red_pitch"]


@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
def test_raw_staging_is_conflict_free_and_covers_the_buffer(elt):
    """cp.async writes, and the split reads back, 4 elements a lane: 16
    bytes in f32 (four phases of 8 lanes) or 8 in bf16 (two phases of 16);
    each phase reads 128 contiguous bytes of one row. The copies of the
    three tensors of a tile fill the buffer exactly."""
    m = bwd_layout()
    walk, nt = BWD_WALK_ROWS, m["nthreads"]
    seen = []
    for t in range(3):
        for base in range(0, walk * 16, nt):
            for w0 in range(0, nt, 32):
                addrs = [((t * walk + r) * D + c) * elt
                         for r, c in (m["stage"](base + w0 + l) for l in LANES)]
                per = 128 // (4 * elt)  # lanes a phase
                for ph in range(32 // per):
                    chunk = sorted(addrs[per * ph: per * ph + per])
                    assert chunk == list(range(chunk[0], chunk[0] + 128, 4 * elt))
                seen += addrs
    assert sorted(seen) == list(range(0, 3 * walk * D * elt, 4 * elt))
    assert 3 * walk * D * elt <= 4 * m["raw"][1]


# ---- the arithmetic ----

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view: round the magnitude half away
    from zero to 10 mantissa bits (add half of the dropped 13 bits, clear
    them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """3xTF32: big.big + big.small + small.big, f32 accumulation."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _mm1(a, b):
    return _tf32(a) @ _tf32(b)


def _model_backward(q, k, v, mask, g, out, stats, mm, tile=64):
    """The two kernels' arithmetic for (B, H, N, 64) f32 inputs: the dk/dv
    blocks per key tile, the dq blocks per query row with key tiles
    skipped, every product through mm."""
    scale = 0.125
    m, inv = stats[0], stats[1]              # (B, H, N)
    delta = (g * out).sum(-1)                # dO . O, (B, H, N)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    b_, _, n, _ = q.shape
    for b in range(b_):
        real = mask[b]
        for k0 in range(0, n, tile):
            kr = slice(k0, min(k0 + tile, n))
            tile_real = bool(real[kr].any())
            if tile_real or not bool(real.any()):  # else: the block writes zeros
                st = mm(k[b, :, kr], q[b].transpose(-1, -2)) * scale  # (H, keys, N)
                st = torch.where(real[kr][None, :, None], st, torch.full_like(st, NEG))
                pt = torch.exp(st - m[b][:, None, :]) * inv[b][:, None, :]
                dv[b, :, kr] = mm(pt, g[b])
                dpt = mm(v[b, :, kr], g[b].transpose(-1, -2))
                dst = torch.where(real[kr][None, :, None], pt * (dpt - delta[b][:, None, :]),
                                  torch.zeros_like(pt))
                dk[b, :, kr] = mm(dst, q[b]) * scale
            if tile_real:  # the dq kernel skips a tile without a real key
                s = mm(q[b], k[b, :, kr].transpose(-1, -2)) * scale  # (H, N, keys)
                p = torch.where(real[kr][None, None, :],
                                torch.exp(s - m[b][..., None]) * inv[b][..., None],
                                torch.zeros_like(s))
                dp = mm(g[b], v[b, :, kr].transpose(-1, -2))
                dq[b] += mm(p * (dp - delta[b][..., None]), k[b, :, kr])
    return dq * 0.125, dk, dv


def _case(n):
    """B 3, H 2, N n: ragged masks (a prefix of 60% of the keys, a random
    70%) and one fully-masked batch row."""
    rng = np.random.default_rng(n)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((3, 2, n, D)).astype(np.float32))
                  for _ in range(4))
    mask = torch.from_numpy(np.stack([
        np.arange(n) < int(0.6 * n), rng.uniform(size=n) < 0.7, np.zeros(n, bool)]))
    return q, k, v, g, mask


@pytest.mark.parametrize("n", [70, 256])
def test_3xtf32_model_matches_the_plain_backward(n):
    """Within 1e-4 of max|plain| (the card's limit for the kernels in f32):
    3xTF32 keeps ~22 of f32's 24 bits per product and the residuals are
    f32, so the error is a few f32 ulps of the largest gradient; dq = dk =
    0 exactly in the fully-masked batch row, where dv is the mean of dO."""
    q, k, v, g, mask = _case(n)
    out = masked_attention_plain(q, k, v, mask)
    stats = attention_row_stats_plain(q, k, mask)
    got = _model_backward(q, k, v, mask, g, out, stats, _mm3)
    ref = masked_attention_backward_plain(q, k, v, mask, g)
    for label, a, b in zip(("dq", "dk", "dv"), got, ref):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel <= 1e-4, (label, rel)
    assert got[0][2].abs().max() == 0 and got[1][2].abs().max() == 0
    torch.testing.assert_close(got[2][2], g[2].mean(dim=1, keepdim=True).expand(-1, n, -1),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [70, 256])
def test_one_tf32_product_misses_the_limit(n):
    """The same model with one TF32 product (10 mantissa bits, ~3 decimal
    digits) misses 1e-4 of max|plain| in at least one gradient: the reason
    for the big/small split."""
    q, k, v, g, mask = _case(n)
    out = masked_attention_plain(q, k, v, mask)
    stats = attention_row_stats_plain(q, k, mask)
    got = _model_backward(q, k, v, mask, g, out, stats, _mm1)
    ref = masked_attention_backward_plain(q, k, v, mask, g)
    worst = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))
    assert worst > 1e-4, worst


def test_tf32_rounding_on_the_int32_view():
    """10 explicit mantissa bits, ties away from zero, both signs."""
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 2 ** -11), 3.0,
                      1.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0, 1.0])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    big = _tf32(y)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((y - big).abs() <= y.abs() * 2 ** -11).all()


def test_row_stats_are_the_plain_softmax():
    """m and 1/l give the plain forward's probabilities; a fully-masked row
    has m = -1e9 and 1/l = 1/N (not a log-sum-exp: -1e9 + log N rounds to
    -1e9 in f32)."""
    q, k, v, g, mask = _case(70)
    m, inv = attention_row_stats_plain(q, k, mask)
    logits = torch.einsum("bhid,bhjd->bhij", q, k) * 0.125
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, NEG))
    torch.testing.assert_close(torch.exp(logits - m[..., None]) * inv[..., None],
                               torch.softmax(logits, dim=-1), atol=1e-7, rtol=0)
    assert (m[2] == NEG).all() and torch.allclose(inv[2], torch.full_like(inv[2], 1 / 70))
    assert float(torch.tensor(NEG, dtype=torch.float32) + np.log(70)) == NEG
