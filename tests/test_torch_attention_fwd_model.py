"""The attention forward's tensor-core design (``superslam_tpu_torch/ops/
cuda/attention.cuh``: ``attn_fwd_bf16_kernel`` on mma.sync m16n8k16 and
``attn_fwd_f32_kernel`` on 3xTF32 m16n8k8), checked on the CPU without a
card or a compiler:

- the shared-memory address model (``attention.py::fwd_layout``) against
  the constants of the CUDA source; every ldmatrix phase, cp.async phase,
  fragment load and staging store free of bank conflicts and in bounds;
- the fragments: what ldmatrix hands each lane is the mma operand of the
  right rows and columns, the S accumulators of two adjacent n8 tiles are
  the bf16 P A-fragment as they stand, and the f32 kernel's permuted k
  makes its S accumulators the TF32 A-fragment of P V;
- PyTorch models of both kernels' arithmetic (64-key tiles, tiles without
  a real key skipped, the online softmax; bf16: unnormalised
  probabilities rounded to bf16 before P V; f32: every product in emulated
  3xTF32) against ``masked_attention_plain`` (f32 within 1e-5 of
  max|plain|, bf16 within 2e-2) and against the JAX package on the CPU:
  its Pallas kernel in interpret mode for batch rows with a real key, and
  the XLA route ``models/lightglue.py::_attention`` for the fully-masked
  row (the Pallas kernel averages over its 128-padded keys there).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superslam_tpu.models import lightglue as jlg
from superslam_tpu.ops.pallas.attention import masked_attention as pallas_attention
from superslam_tpu_torch.ops.cuda import attention as attn
from superslam_tpu_torch.ops.cuda.attention import (
    attention_row_stats_plain,
    fwd_layout,
    masked_attention_plain,
)

CUDA_DIR = os.path.dirname(os.path.abspath(attn.__file__))
LANES = range(32)
D, KEYS = 64, 64
NEG = -1e9


def _cuda_constants() -> dict[str, int]:
    with open(os.path.join(CUDA_DIR, "attention.cuh")) as f:
        text = f.read()
    names: dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, flags=re.M):
        names[name] = int(eval(expr.replace("/", "//"), {}, dict(names)))
    return names


def test_layout_matches_the_cuda_constants():
    c = _cuda_constants()
    assert (c["BQ"], c["FQ"], c["KT"], c["KSTAGES"], c["D"]) == (
        attn.FWD_BF16_ROWS, attn.FWD_F32_ROWS, attn.FWD_KEYS, attn.FWD_BF16_STAGES, D)
    b, f = fwd_layout("bf16"), fwd_layout("f32")
    assert c["B_SMEM"] == b["smem_bytes"] <= 232_448
    assert c["BTHREADS"] == b["nthreads"] and c["ROW_BYTES"] == b["row_bytes"]
    assert c["KV_BYTES"] == b["tiles"]["v0"][0] - b["tiles"]["k0"][0]
    assert c["F_SMEM"] == f["smem_bytes"] <= 232_448
    assert c["FTHREADS"] == f["nthreads"] and c["FLD"] == f["pitch"]
    assert c["F_PLANE"] == f["planes"]["ks"][0] and 4 * c["F_PLANE"] == f["raw"][0]
    assert c["F_RAW"] == f["raw"][1]
    assert c["FQ"] <= 2 * c["KT"]  # the query tile is staged through two planes


def _phases_conflict_free(addrs) -> bool:
    """32 lanes of 16 bytes: four phases of 8 lanes, each conflict-free when
    its 8 chunks fall in 8 distinct 16-byte bank groups."""
    return all(len({(a % 128) // 16 for a in addrs[8 * p: 8 * p + 8]}) == 8 for p in range(4))


# ---- bf16: tiles, ldmatrix and cp.async ----

def _bf16_loads(m):
    """Yield (label, tile, [32 (row, chunk)]) for every ldmatrix.x4 of the
    bf16 kernel: Q per warp and k-step, K per k-step and n-tile pair, V
    (trans) per key step and output n-tile pair, from every ring slot."""
    for w in range(m["rows"] // 16):
        for ks in range(D // 16):
            yield ("q", w, ks), "q", [m["q_lane"](l, w, ks) for l in LANES]
    for u in range(m["stages"]):
        for ks in range(D // 16):
            for hh in range(KEYS // 16):
                yield ("k", u, ks, hh), f"k{u}", [m["k_lane"](l, ks, hh) for l in LANES]
        for kk in range(KEYS // 16):
            for j in range(D // 16):
                yield ("v", u, kk, j), f"v{u}", [m["v_lane"](l, kk, j) for l in LANES]


@pytest.mark.parametrize("rows,stages", [(64, 2), (32, 2), (64, 3), (64, 4)])
def test_bf16_ldmatrix_phases_are_conflict_free_and_in_bounds(rows, stages):
    m = fwd_layout("bf16", rows, stages=stages)
    n = 0
    for label, tile, rc in _bf16_loads(m):
        off, nrows = m["tiles"][tile]
        addrs = [m["address"](r, c) for r, c in rc]
        assert _phases_conflict_free(addrs), (label, addrs)
        assert all(0 <= r < nrows and 0 <= c < 8 for r, c in rc), label
        n += 1
    assert n == rows // 16 * 4 + stages * (4 * 4 + 4 * 4)
    assert m["smem_bytes"] <= 232_448
    tiles = sorted(m["tiles"].values())
    assert tiles[0][0] == 0 and all(a[0] + a[1] * 128 == b[0] for a, b in zip(tiles, tiles[1:]))
    assert tiles[-1][0] + tiles[-1][1] * 128 == m["smem_bytes"]


@pytest.mark.parametrize("rows", [64, 32])
def test_bf16_tile_copies_cover_each_tile_without_conflicts(rows):
    """cp.async copy i writes chunk i & 7 of row i >> 3 of a tile: the
    copies of the query tile and of a key tile each fill the tile once."""
    m = fwd_layout("bf16", rows)
    nt = m["nthreads"]
    for nrows in (rows, KEYS):
        seen = []
        for base in range(0, nrows * 8, nt):
            for w0 in range(0, nt, 32):
                addrs = [m["address"](*m["copy"](base + w0 + l)) for l in LANES]
                assert _phases_conflict_free(addrs)
                seen += addrs
        assert sorted(seen) == list(range(0, nrows * 128, 16))


def _ldmatrix(lane_rows, trans=False):
    """Per lane, the (row, column) of each half of the 4 registers that
    ldmatrix.x4 returns: matrix i is addressed by lanes 8i .. 8i + 7
    (row, 16-byte chunk); without .trans lane l receives row l // 4,
    elements 2 (l % 4), + 1; with .trans rows 2 (l % 4), + 1 at element
    l // 4."""
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


def _a16(l, reg, half):
    """m16n8k16 A (row, k): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3
    (g + 8, 2t + 8), + half."""
    return l // 4 + 8 * (reg & 1), 2 * (l % 4) + half + 8 * (reg >> 1)


def _b16(l, reg, half):
    """m16n8k16 B (k, n): b0 (2t, g), b1 (2t + 8, g), + half in k."""
    return 2 * (l % 4) + half + 8 * reg, l // 4


def _c16(l, e):
    """m16n8 accumulator (row, column): c0 (g, 2t), c1 (g, 2t + 1), c2
    (g + 8, 2t), c3 (g + 8, 2t + 1)."""
    return l // 4 + 8 * (e >> 1), 2 * (l % 4) + (e & 1)


def test_bf16_fragments_are_the_operands_of_both_products():
    m = fwd_layout("bf16")
    for w in range(m["rows"] // 16):
        for ks in range(D // 16):  # Q: A of S, rows of the warp, k = d
            got = _ldmatrix([m["q_lane"](l, w, ks) for l in LANES])
            for l in LANES:
                for reg in range(4):
                    for half in (0, 1):
                        r, k = _a16(l, reg, half)
                        assert got[l][reg][half] == (16 * w + r, 16 * ks + k)
    for ks in range(D // 16):  # K: B of S, k = d, n = key; regs 2, 3 the next n-tile
        for hh in range(KEYS // 16):
            got = _ldmatrix([m["k_lane"](l, ks, hh) for l in LANES])
            for l in LANES:
                for reg in range(4):
                    for half in (0, 1):
                        k, n = _b16(l, reg & 1, half)
                        assert got[l][reg][half] == (8 * (2 * hh + (reg >> 1)) + n, 16 * ks + k)
    for kk in range(KEYS // 16):  # V by .trans: B of P V, k = key, n = d
        for j in range(D // 16):
            got = _ldmatrix([m["v_lane"](l, kk, j) for l in LANES], trans=True)
            for l in LANES:
                for reg in range(4):
                    for half in (0, 1):
                        k, n = _b16(l, reg & 1, half)
                        assert got[l][reg][half] == (16 * kk + k, 8 * (2 * j + (reg >> 1)) + n)


def test_s_accumulators_are_the_p_a_fragment():
    """pa[r] packs s[2 kk + (r >> 1)][2 (r & 1)], [2 (r & 1) + 1] (low half
    first): the same (query row, key) as A register r of keys 16 kk .. 16 kk
    + 15, for every lane."""
    for kk in range(KEYS // 16):
        for l in LANES:
            for reg in range(4):
                nt = 2 * kk + (reg >> 1)
                for half in (0, 1):
                    row, col = _c16(l, 2 * (reg & 1) + half)
                    r, k = _a16(l, reg, half)
                    assert (row, 8 * nt + col) == (r, 16 * kk + k)


# ---- f32: planes, fragment loads, staging ----

def _f32_loads(m):
    """Yield (label, [32 word offsets]) of every fragment load of the f32
    kernel from a plane: Q's A (once per warp), S's B, P V's permuted B."""
    for w in range(m["rows"] // 16):
        for kk in range(D // 8):
            for reg in range(4):
                yield ("q", w, kk, reg), [m["q_frag"](l, w, kk, reg) for l in LANES]
    for kk in range(D // 8):
        for nt in range(KEYS // 8):
            for reg in range(2):
                yield ("b_rows", kk, nt, reg), [m["b_rows"](l, nt, kk, reg) for l in LANES]
    for kk in range(KEYS // 8):
        for nt in range(D // 8):
            for reg in range(2):
                yield ("b_perm", kk, nt, reg), [m["b_perm"](l, kk, nt, reg) for l in LANES]


@pytest.mark.parametrize("rows", [64, 32, 128])
def test_f32_fragment_loads_are_conflict_free_and_in_bounds(rows):
    """One word a lane: conflict-free when the 32 lanes hit 32 banks. Q's
    fragments read rows up to 16 x warps of the two planes it was staged
    through; the products read a plane's 64 rows, never a pad column."""
    m = fwd_layout("f32", rows)
    plane = KEYS * m["pitch"]
    for label, words in _f32_loads(m):
        assert len({w % 32 for w in words}) == 32, (label, words)
        limit = 2 * plane if label[0] == "q" else plane
        assert 0 <= min(words) and max(words) < limit, label
        assert all(w % m["pitch"] < D for w in words), label


@pytest.mark.parametrize("rows", [64, 32, 128])
def test_f32_staging_is_conflict_free_and_fills_the_planes(rows):
    """stage: index i writes the 4-word chunk i & 15 of row i >> 4 (16-byte
    stores: four phases of 8 lanes, each on 8 distinct bank groups); a key
    tile fills a plane's 64 rows, the query tile 16 x warps rows of the
    planes from kb (big) and vb (small) on; the planes and the raw buffer
    tile the shared memory."""
    m = fwd_layout("f32", rows)
    nt = m["nthreads"]
    for nrows in (KEYS, rows):
        seen = []
        for base in range(0, nrows * 16, nt):
            for w0 in range(0, nt, 32):
                words = [m["stage"](base + w0 + l) for l in LANES]
                addrs = [r * m["pitch"] + c for r, c in words]
                for ph in range(4):
                    assert len({(a // 4) % 8 for a in addrs[8 * ph: 8 * ph + 8]}) == 8
                seen += addrs
        assert sorted(seen) == [r * m["pitch"] + c for r in range(nrows) for c in range(0, D, 4)]
        assert max(seen) + 4 <= 2 * KEYS * m["pitch"]
    off = 0
    for name in ("kb", "ks", "vb", "vs"):
        assert m["planes"][name] == (off, KEYS)
        off += KEYS * m["pitch"]
    assert m["raw"] == (off, 2 * KEYS * D) and 4 * sum(m["raw"]) == m["smem_bytes"]


def test_f32_permuted_k_makes_s_the_a_fragment_of_pv():
    """mm_acc's A register e is p[kk][(0, 2, 1, 3)[e]]: TF32 A slot (row g
    + 8 (e & 1), k t + 4 (e >> 1)) holds the accumulator at (the same row,
    key 8 kk + 2t + (e >> 1)); B register reg reads V row 8 kk + 2t + reg,
    the key of slot t + 4 reg."""
    m = fwd_layout("f32")
    perm = (0, 2, 1, 3)
    for kk in range(KEYS // 8):
        for l in LANES:
            g, t = l // 4, l % 4
            for e in range(4):
                row, col = _c16(l, perm[e])
                slot = t + 4 * (e >> 1)
                assert row == g + 8 * (e & 1)
                key = 8 * kk + col
                assert key == 8 * kk + 2 * (slot % 4) + slot // 4
            for reg in (0, 1):
                word = m["b_perm"](l, kk, 0, reg)
                assert word // m["pitch"] == 8 * kk + 2 * t + reg and word % m["pitch"] == g


# ---- the arithmetic ----

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view (10 mantissa bits, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """3xTF32: big.big + big.small + small.big, f32 accumulation."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _model_forward(q, k, v, mask, kind, skip=True):
    """The kernels' arithmetic for (B, H, N, 64) inputs held as f32: per
    batch row, 64-key tiles in order (tiles without a real key skipped when
    ``skip`` and the row has one), S = Q K^T, logits of masked keys
    replaced by -1e9, the online softmax (running maximum m, sum l of the
    unrounded probabilities, o rescaled by exp(m_old - m_new)), o += P V;
    bf16: both products of bf16 values with f32 sums and P rounded to bf16;
    f32: both products in 3xTF32. Returns (o / l, (m, 1 / l))."""
    mm = _mm3 if kind == "f32" else torch.matmul
    rnd = (lambda p: p) if kind == "f32" else (lambda p: p.to(torch.bfloat16).float())
    b_, h_, n, _ = q.shape
    out = torch.zeros_like(q)
    stats = torch.zeros((2, b_, h_, n))
    for b in range(b_):
        real = mask[b]
        m = torch.full((h_, n), -np.inf)
        l_ = torch.zeros((h_, n))
        o = torch.zeros((h_, n, D))
        for k0 in range(0, n, KEYS):
            kr = slice(k0, min(k0 + KEYS, n))
            if skip and bool(real.any()) and not bool(real[kr].any()):
                continue
            s = mm(q[b], k[b, :, kr].transpose(-1, -2))
            logits = torch.where(real[kr][None, None, :], s * 0.125, torch.full_like(s, NEG))
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l_ = l_ * alpha + p.sum(-1)
            o = o * alpha[..., None] + mm(rnd(p), v[b, :, kr])
            m = m_new
        inv = 1.0 / l_
        out[b] = o * inv[..., None]
        stats[0, b], stats[1, b] = m, inv
    return out, stats


def _case(n, seed=0):
    """B 3, H 2, N n: a prefix of 60% real keys (so the last tiles hold none
    and are skipped), a random 70%, and one fully-masked batch row."""
    rng = np.random.default_rng(seed + n)
    q, k, v = (rng.standard_normal((3, 2, n, D)).astype(np.float32) for _ in range(3))
    mask = np.stack([np.arange(n) < int(0.6 * n), rng.uniform(size=n) < 0.7, np.zeros(n, bool)])
    return q, k, v, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n", [70, 130])
def test_f32_model_matches_the_plain_version_and_its_statistics(n):
    """Within 1e-5 of max|plain| (3xTF32 keeps ~22 of f32's 24 bits per
    product); the row statistics within 1e-5 as chip_smoke holds the card's;
    a fully-masked row is the mean of v over all N keys."""
    q, k, v, mask = _torch(*_case(n))
    got, stats = _model_forward(q, k, v, mask, "f32")
    ref = masked_attention_plain(q, k, v, mask)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 1e-5, rel
    sref = attention_row_stats_plain(q, k, mask)
    assert ((stats[0] - sref[0]).abs() / sref[0].abs().clamp_min(1.0)).max() <= 1e-5
    assert ((stats[1] - sref[1]).abs() / sref[1].abs()).max() <= 1e-5
    torch.testing.assert_close(got[2], v[2].mean(dim=1, keepdim=True).expand(-1, n, -1),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [70, 130])
def test_bf16_model_matches_the_plain_version(n):
    """bf16 inputs, probabilities rounded to bf16 before P V unnormalised
    (the plain version rounds them normalised): within 2e-2, the card's
    limit for the bf16 kernel."""
    q, k, v, mask = _torch(*_case(n))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got, _ = _model_forward(qb.float(), kb.float(), vb.float(), mask, "bf16")
    got = got.to(torch.bfloat16)
    ref = masked_attention_plain(qb, kb, vb, mask)
    assert (got.float() - ref.float()).abs().max().item() <= 2e-2
    mean_v = vb[2].float().mean(dim=1, keepdim=True).expand(-1, n, -1)
    assert (got[2].float() - mean_v).abs().max().item() <= 2e-2


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_skipping_key_tiles_without_a_real_key_changes_no_bit(kind):
    """exp(-1e9 - m) is exactly 0 in f32 once m is a real logit, and a tile
    seen before the first real one is wiped by alpha = 0: the skip is exact
    in every row with a real key; the fully-masked row walks every tile."""
    q, k, v, mask = _torch(*_case(130, seed=5))
    a, sa = _model_forward(q, k, v, mask, kind, skip=True)
    b, sb = _model_forward(q, k, v, mask, kind, skip=False)
    assert torch.equal(a, b) and torch.equal(sa, sb)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_models_match_the_jax_package(kind):
    """The batch rows with a real key against the Pallas kernel in
    interpret mode (f32 atol 1e-5; bf16 inputs and output atol 2e-2), the
    fully-masked row against the XLA route, which replaces masked logits
    as the kernels do."""
    q, k, v, mask = _case(70, seed=11)
    if kind == "bf16":
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (q, k, v))
    got, _ = _model_forward(*_torch(q, k, v, mask), kind)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if kind == "bf16":
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
        got = got.to(torch.bfloat16)
    tol = 1e-5 if kind == "f32" else 2e-2
    ref = np.asarray(pallas_attention(jq, jk, jv, jnp.asarray(mask), interpret=True)
                     .astype(jnp.float32))
    np.testing.assert_allclose(got[:2].float().numpy(), ref[:2], atol=tol, rtol=0)
    xla = np.asarray(jlg._attention(jq, jk, jv, jnp.asarray(mask)).astype(jnp.float32))
    np.testing.assert_allclose(got[2].float().numpy(), xla[2], atol=tol, rtol=0)
