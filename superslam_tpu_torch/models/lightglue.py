"""LightGlue feature matcher on PyTorch tensors.

Port of ``superslam_tpu/models/lightglue.py``: 9 transformer layers over
256-d descriptors with learnable-Fourier rotary self-attention,
bidirectional cross-attention and a dual-softmax + matchability
assignment; early exit and pruning disabled.

Two routes through the layers, as in the JAX package:
- fused (the default, on every device): one hand-written kernel call per
  whole self block and per whole cross block
  (``ops/cuda/lightglue_layer.py``; their plain versions on CPU), 18 calls
  per forward; inference-only: it raises on tensors that require grad;
- unfused (``fused=False`` or ``SUPERSLAM_PALLAS_LG=0``): PyTorch linears
  around the hand-written attention kernel, described below;
  differentiable end to end with respect to every parameter it reads
  (attention through its hand-written backward), which is what
  ``parallel/training.py`` trains through in f32. Its blocks run over a
  list of parameter shards: one whole shard here (``WholeParams``),
  a mesh's model axis in ``parallel/tensor_parallel.py``.

- Both keypoint sets are padded to one K with validity masks threaded
  through attention, the assignment softmaxes and match extraction.
- Both sides of every pair problem are interleaved on the batch axis
  (rows 2p, 2p+1), so each layer is one (2P, K, 256) call.
- Unfused route: attention goes through the hand-written kernel
  (``ops/cuda/attention.py``; its plain version on CPU); the cross layer is
  one call over all 2P rows against the pair-swapped keys and values.
  Linear layers run in the compute dtype (bf16 by default); LayerNorm and
  the rotary encoding's projection run in f32; GELU is the exact erf form.
- ``input_proj`` and the f32 log-assignment are PyTorch calls on both
  routes, as the JAX package leaves them outside its kernels.

Parameters are a flat dict keyed by the cvg/LightGlue state-dict names in
torch layout ((out, in) linear weights), including the interleaved
(head, channel, qkv) packing of Wqkv.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.attention import masked_attention
from ..ops.cuda.lightglue_layer import (
    FUSED_KEY,
    augment_fused_layer_params,
    fused_cross_block,
    fused_self_block,
    prep_cross_weights,
    prep_self_weights,
)
from ..utils.profiler import profile_scope

Params = dict[str, torch.Tensor]

DIM = 256
NUM_HEADS = 4
HEAD_DIM = DIM // NUM_HEADS
NUM_LAYERS = 9
NEG = -1e9

# Linear layers that run in the compute dtype (the rest stay f32).
_COMPUTE_LINEARS = ("input_proj", "Wqkv", "out_proj", "ffn.0", "ffn.3", "to_qk", "to_v", "to_out")


def cast_compute_params(params: Params) -> Params:
    """A copy of ``params`` whose bf16 linears are cast once, so the
    forward's per-call casts at the default compute dtype are no-ops.
    Casting once or per call gives the same values; the f32 parameters
    (LayerNorm, rotary projection, log-assignment) are left as they are."""
    out = dict(params)
    for name, t in params.items():
        stem = name.rsplit(".", 1)[0]
        if any(stem.endswith(s) for s in _COMPUTE_LINEARS):
            out[name] = t.to(torch.bfloat16)
    return out


def prepare_params(params: Params, device) -> Params:
    """What a matcher or pipeline does to a checkpoint once at construction:
    move it to ``device``, cast the compute-dtype linears
    (``cast_compute_params``) and prepare the fused blocks' kernel operands
    (``augment_fused_layer_params``)."""
    moved = {k: v.to(device) for k, v in params.items() if not k.endswith(FUSED_KEY)}
    return augment_fused_layer_params(cast_compute_params(moved))


def _fused_layers_wanted() -> bool:
    """Whether whole transformer blocks run as fused kernels: yes unless
    ``SUPERSLAM_PALLAS_LG`` is 0, empty or ``false``. The JAX package's
    force-unfused-attention knob ``SUPERSLAM_PALLAS_ATTN=0`` also selects
    the unfused layers unless ``SUPERSLAM_PALLAS_LG`` overrides it. Read at
    every forward."""
    v = os.environ.get("SUPERSLAM_PALLAS_LG")
    if v is not None:
        return v not in ("0", "", "false")
    return os.environ.get("SUPERSLAM_PALLAS_ATTN") not in ("0", "", "false")


def _linear(x, params, name, dtype):
    y = x.to(dtype) @ params[f"{name}.weight"].to(dtype).t()
    b = params.get(f"{name}.bias")
    if b is not None:
        y = y + b.to(dtype)
    return y


def _wide(t):
    """t in f32, or as it is in f64 (gradient checks run the unfused route
    in f64, as ``ops/cuda/attention.py`` keeps f64 inputs in f64)."""
    return t if t.dtype == torch.float64 else t.float()


class WholeParams:
    """The one shard of an unsplit forward: every parameter whole, where it
    is. The blocks below run over a list of shards, each computing its
    share of the attention heads and the FFN's hidden units;
    ``parallel/tensor_parallel.py``'s shards split them over a mesh's model
    axis with the same methods."""

    def __init__(self, params: Params):
        self.params = params

    def here(self, t: torch.Tensor) -> torch.Tensor:
        """t on this shard's device."""
        return t

    def take(self, name: str, dims=None) -> torch.Tensor:
        """This shard's part of parameter ``name`` (split along ``dims``,
        by default along its placement's model dimensions)."""
        return self.params[name]

    def column(self, x, name, dtype):
        """x @ W.T + b for this shard's output rows of linear ``name``."""
        w, b = self.take(f"{name}.weight"), self.take(f"{name}.bias")
        return x.to(dtype) @ w.to(dtype).t() + b.to(dtype)

    def row(self, h, name, dtype):
        """h @ W.T over this shard's input columns of linear ``name``: its
        partial sum, without the bias."""
        return h.to(dtype) @ self.take(f"{name}.weight").to(dtype).t()


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on ``device``: t itself where it is there already. Every CPU
    device name (``cpu``, ``cpu:0``) is one memory, where ``.to`` would
    still copy and add a node to the graph."""
    return t if t.device.type == device.type == "cpu" else t.to(device)


def _all_reduce(parts, device):
    """The sum of the shards' parts in the order 0..M-1 on ``device``."""
    total = _to(parts[0], device)
    for p in parts[1:]:
        total = total + _to(p, device)
    return total


def _mean_over_units(parts, device):
    """The mean over the last dim of the shards' equal parts joined: their
    means all-reduced over the shard count (exact for the power-of-two
    widths here; one shard: its mean)."""
    mean = _all_reduce([p.mean(dim=-1, keepdim=True) for p in parts], device)
    return mean if len(parts) == 1 else mean / len(parts)


def _message(parts, params, name, dtype, device):
    """The output of linear ``name`` whose input columns the shards split:
    their partials all-reduced on ``device``, then the bias added once."""
    return _all_reduce(parts, device) + params[f"{name}.bias"].to(dtype)


def _shards(params, shards):
    return (WholeParams(params),) if shards is None else shards


def _ffn(x, message, params, prefix, dtype, shards=None):
    """x + MLP(cat[x, message]): Linear(2d,2d) -> LayerNorm -> GELU ->
    Linear, the 2·DIM hidden units split over ``shards``. The LayerNorm
    normalises over all of them: its mean and then its mean square
    deviation from that mean are all-reduced (f32; f64 on f64 rows)."""
    shards = _shards(params, shards)
    h = torch.cat([x, message], dim=-1)
    a = [_wide(s.column(s.here(h), f"{prefix}.0", dtype)) for s in shards]
    mu = _mean_over_units(a, x.device)
    mus = [s.here(mu) for s in shards]
    var = _mean_over_units([torch.square(t - u) for t, u in zip(a, mus)], x.device)
    parts = []
    for s, t, u in zip(shards, a, mus):
        g = _wide(s.take(f"{prefix}.1.weight", [0]))
        b = _wide(s.take(f"{prefix}.1.bias", [0]))
        n = ((t - u) * torch.rsqrt(s.here(var) + 1e-5) * g + b).to(dtype)
        parts.append(s.row(F.gelu(n, approximate="none"), f"{prefix}.3", dtype))
    return x + _message(parts, params, f"{prefix}.3", dtype, x.device)


def _rotary_encoding(kpts, params, dtype):
    """Learnable Fourier features -> (cos, sin) each (B, N, HEAD_DIM), each
    frequency repeated for the rotary pair (2i, 2i+1)."""
    wr = _wide(params["posenc.Wr.weight"])  # (HEAD_DIM//2, 2)
    proj = _wide(kpts) @ wr.t()  # (B, N, 32)
    cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)
    return cos.to(dtype), sin.to(dtype)


def _rotate_half(x):
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).reshape(*x.shape[:-2], -1)


def _apply_rotary(t, cos, sin):
    # t: (B, H, N, D), cos/sin: (B, N, D) broadcast over heads.
    return t * cos[:, None] + _rotate_half(t) * sin[:, None]


def _split_heads(x):
    """(B, N, h * HEAD_DIM) -> (B, h, N, HEAD_DIM)."""
    b, n, _ = x.shape
    return x.reshape(b, n, -1, HEAD_DIM).permute(0, 2, 1, 3)


def _merge_heads(x):
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def _self_block(x, enc, mask, params, prefix, dtype, shards=None):
    """The self block, its heads split over ``shards`` (one attention call
    a shard on its heads)."""
    shards = _shards(params, shards)
    b, n, _ = x.shape
    parts = []
    for s in shards:
        qkv = s.column(s.here(x), f"{prefix}.Wqkv", dtype)
        # cvg/LightGlue packs the Wqkv output as (head, channel, qkv)
        # interleaved: heads outermost, so a shard's rows are whole heads.
        qkv = qkv.reshape(b, n, -1, HEAD_DIM, 3).permute(0, 2, 1, 3, 4)
        cos, sin = (s.here(t) for t in enc)
        q = _apply_rotary(qkv[..., 0], cos, sin)
        k = _apply_rotary(qkv[..., 1], cos, sin)
        context = masked_attention(q, k, qkv[..., 2], s.here(mask))
        parts.append(s.row(_merge_heads(context), f"{prefix}.out_proj", dtype))
    message = _message(parts, params, f"{prefix}.out_proj", dtype, x.device)
    return _ffn(x, message, params, f"{prefix}.ffn", dtype, shards)


def _swap_pairs(a):
    """Rows (2p, 2p+1) -> (2p+1, 2p)."""
    return a.reshape(a.shape[0] // 2, 2, *a.shape[1:]).flip(1).reshape(a.shape)


def _cross_block_paired(x, mask, params, prefix, dtype, shards=None):
    """Cross-attention over interleaved pair rows (2P, K, D): row 2p attends
    row 2p+1 and vice versa, as one attention call (a shard, on its heads)
    against the pair-swapped keys, values and mask."""
    shards = _shards(params, shards)
    parts = []
    for s in shards:
        xs, ms = s.here(x), s.here(mask)
        qk = _split_heads(s.column(xs, f"{prefix}.to_qk", dtype))  # (2P, h, K, Dh)
        v = _split_heads(s.column(xs, f"{prefix}.to_v", dtype))
        out = masked_attention(qk, _swap_pairs(qk), _swap_pairs(v), _swap_pairs(ms))
        parts.append(s.row(_merge_heads(out), f"{prefix}.to_out", dtype))
    message = _message(parts, params, f"{prefix}.to_out", dtype, x.device)
    return _ffn(x, message, params, f"{prefix}.ffn", dtype, shards)


def _unfused_layers(x, kpts, mask, params, dtype, shards=None):
    """All 9 self + cross layers of the unfused route, their heads and FFN
    units split over ``shards`` (default: one whole shard)."""
    enc = _rotary_encoding(kpts, params, dtype)
    for i in range(NUM_LAYERS):
        p = f"transformers.{i}"
        x = _self_block(x, enc, mask, params, f"{p}.self_attn", dtype, shards)
        x = _cross_block_paired(x, mask, params, f"{p}.cross_attn", dtype, shards)
    return x


def _forward_fused_layers(params, x, kpts, mask, compute_dtype):
    """All 9 self + cross layers through the fused blocks. x (2P, K, 256),
    kpts (2P, K, 2) normalized, mask (2P, K) bool."""
    wr = params["posenc.Wr.weight"].float()  # (32, 2)
    proj = kpts.float() @ wr.t()  # (2P, K, 32): one frequency per rotary pair
    cos, sin = torch.cos(proj), torch.sin(proj)
    x = x.to(compute_dtype)
    for i in range(NUM_LAYERS):
        p = f"transformers.{i}"
        ws = prep_self_weights(params, f"{p}.self_attn", compute_dtype)
        x = fused_self_block(x, cos, sin, mask, ws)
        wc = prep_cross_weights(params, f"{p}.cross_attn", compute_dtype)
        x = fused_cross_block(x, mask, wc)
    return x


def _log_assignment(x0, x1, mask0, mask1, params, prefix):
    """Dual-softmax + matchability log-assignment (f32; f64 on f64 rows)."""
    f32 = _wide(x0).dtype
    d0 = _linear(x0, params, f"{prefix}.final_proj", f32)
    d1 = _linear(x1, params, f"{prefix}.final_proj", f32)
    s = float(DIM) ** 0.25
    sim = torch.einsum("bmd,bnd->bmn", d0 / s, d1 / s)
    both = mask0[:, :, None] & mask1[:, None, :]
    sim = torch.where(both, sim, torch.full_like(sim, NEG))
    z0 = _linear(x0, params, f"{prefix}.matchability", f32)[..., 0]
    z1 = _linear(x1, params, f"{prefix}.matchability", f32)[..., 0]
    certainties = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
    scores0 = torch.log_softmax(sim, dim=2)
    scores1 = torch.log_softmax(sim, dim=1)
    return scores0 + scores1 + certainties  # (B, M, N) log P(match)


def _pad_to(a, k):
    if a.shape[1] == k:
        return a
    widths = [0, 0] * (a.dim() - 2) + [0, k - a.shape[1]]
    if a.dtype == torch.bool:
        return F.pad(a.to(torch.uint8), widths).to(torch.bool)
    return F.pad(a, widths)


def lightglue_forward(
    params: Params,
    kpts0: torch.Tensor,
    desc0: torch.Tensor,
    kpts1: torch.Tensor,
    desc1: torch.Tensor,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
    compute_dtype=torch.bfloat16,
    fused: bool | None = None,
) -> torch.Tensor:
    """Run the full matcher; returns the (B, M, N) f32 log-assignment.

    kpts (B, K, 2) already normalized to ~[-1, 1]; desc (B, K, 256)
    L2-normalized rows; masks (B, K) bool mark real (non-padding) keypoints.
    ``fused=None`` takes the fused layer route unless the environment
    selects the unfused one (``_fused_layers_wanted``); ``fused=False``
    forces the unfused layers.
    """
    x, kpts, mask = _pair_rows(kpts0, desc0, kpts1, desc1, mask0, mask1)
    x = _linear(x, params, "input_proj", compute_dtype)
    if _fused_layers_wanted() if fused is None else fused:
        x = _forward_fused_layers(params, x, kpts, mask, compute_dtype)
    else:
        x = _unfused_layers(x, kpts, mask, params, compute_dtype)
    return _final_assignment(x, mask0, mask1, params)


def _pair_rows(kpts0, desc0, kpts1, desc1, mask0, mask1):
    """Both sets padded to one K and interleaved on the batch axis: rows
    (2p, 2p+1) = (side0, side1) of pair p. Returns (x (2B, K, 256), kpts
    (2B, K, 2), mask (2B, K))."""
    b = desc0.shape[0]
    K = max(desc0.shape[1], desc1.shape[1])
    kpts0p, desc0p, mask0p = _pad_to(kpts0, K), _pad_to(desc0, K), _pad_to(mask0, K)
    kpts1p, desc1p, mask1p = _pad_to(kpts1, K), _pad_to(desc1, K), _pad_to(mask1, K)
    dt = torch.promote_types(desc0p.dtype, desc1p.dtype)
    x = torch.stack([desc0p.to(dt), desc1p.to(dt)], dim=1).reshape(2 * b, K, -1)
    kpts = torch.stack([kpts0p, kpts1p], dim=1).reshape(2 * b, K, 2)
    mask = torch.stack([mask0p, mask1p], dim=1).reshape(2 * b, K)
    return x, kpts, mask


def _final_assignment(x, mask0, mask1, params):
    """The last layer's log-assignment of the interleaved rows x (early
    exit disabled: only the final layer's assignment head is used; span
    ``match.assign``)."""
    with profile_scope("match.assign"):
        x0 = x[0::2, : mask0.shape[1]]
        x1 = x[1::2, : mask1.shape[1]]
        return _log_assignment(x0, x1, mask0, mask1, params,
                               f"log_assignment.{NUM_LAYERS - 1}")


def extract_matches(
    log_assignment: torch.Tensor,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
    threshold: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mutual-argmax match extraction with score threshold.

    Returns matches0 (B, M) int32 (index into set1, -1 if unmatched) and
    mscores0 (B, M) f32. Row i is mutual iff it is the FIRST row reaching
    the column max of its chosen column (an int min-reduce over the rows
    that reach it): tie-safe, first-occurrence semantics, as in the JAX
    package."""
    p = log_assignment  # (B, M, N)
    max0, m0 = torch.max(p, dim=2)  # first maximum on ties
    m0 = m0.to(torch.int64)
    m_len = p.shape[1]
    max1 = torch.amax(p, dim=1)  # (B, N)
    rows = torch.arange(m_len, device=p.device)
    winner1 = torch.amin(
        torch.where(p >= max1[:, None, :], rows[None, :, None], m_len), dim=1
    )  # (B, N) first row reaching each column's max
    mutual = torch.gather(winner1, 1, m0) == rows[None, :]
    scores = torch.exp(max0)
    valid = mutual & (scores > threshold) & mask0
    valid = valid & torch.gather(mask1, 1, m0)
    matches0 = torch.where(valid, m0, -1).to(torch.int32)
    mscores0 = torch.where(valid, scores, torch.zeros_like(scores))
    return matches0, mscores0


def lightglue_match(
    params: Params,
    kpts0,
    desc0,
    kpts1,
    desc1,
    mask0,
    mask1,
    threshold: float = 0.1,
):
    """Transformer + assignment + match extraction."""
    with torch.no_grad():
        la = lightglue_forward(params, kpts0, desc0, kpts1, desc1, mask0, mask1)
        return extract_matches(la, mask0, mask1, threshold)


def normalize_keypoints(kpts: torch.Tensor, width: float, height: float) -> torch.Tensor:
    """(kpt - size/2) / (max(w,h)/2), the wrapper-side normalization."""
    scale = max(width, height) / 2.0
    center = torch.tensor([width / 2.0, height / 2.0], dtype=torch.float32, device=kpts.device)
    return (kpts - center) / scale


# -- parameter init -----------------------------------------------------------


def init_lightglue_params(
    seed: int = 0, passthrough: bool = False, device="cpu", dtype=torch.float32
) -> Params:
    """Random init (torch layout), drawn through the same numpy RNG sequence
    as the JAX package's init (there (in, out)), so a seed gives identical
    weights. ``passthrough`` zeroes the message and FFN output projections
    (every layer becomes the residual identity) and boosts final_proj, as
    the JAX package's passthrough init does."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}

    def lin(name, fin, fout, bias=True, std=None):
        std = std if std is not None else float(np.sqrt(1.0 / fin))
        w = (rng.standard_normal((fin, fout)) * std).astype(np.float32)
        params[f"{name}.weight"] = np.ascontiguousarray(w.T)
        if bias:
            params[f"{name}.bias"] = np.zeros((fout,), np.float32)

    lin("input_proj", DIM, DIM)
    lin("posenc.Wr", 2, HEAD_DIM // 2, bias=False, std=1.0)
    for i in range(NUM_LAYERS):
        s = f"transformers.{i}.self_attn"
        lin(f"{s}.Wqkv", DIM, 3 * DIM)
        lin(f"{s}.out_proj", DIM, DIM)
        lin(f"{s}.ffn.0", 2 * DIM, 2 * DIM)
        params[f"{s}.ffn.1.weight"] = np.ones((2 * DIM,), np.float32)
        params[f"{s}.ffn.1.bias"] = np.zeros((2 * DIM,), np.float32)
        lin(f"{s}.ffn.3", 2 * DIM, DIM)
        c = f"transformers.{i}.cross_attn"
        lin(f"{c}.to_qk", DIM, DIM)
        lin(f"{c}.to_v", DIM, DIM)
        lin(f"{c}.to_out", DIM, DIM)
        lin(f"{c}.ffn.0", 2 * DIM, 2 * DIM)
        params[f"{c}.ffn.1.weight"] = np.ones((2 * DIM,), np.float32)
        params[f"{c}.ffn.1.bias"] = np.zeros((2 * DIM,), np.float32)
        lin(f"{c}.ffn.3", 2 * DIM, DIM)
    for i in range(NUM_LAYERS):
        a = f"log_assignment.{i}"
        lin(f"{a}.final_proj", DIM, DIM)
        lin(f"{a}.matchability", DIM, 1)
    if passthrough:
        zero = {"out_proj", "to_out", "ffn.3"}
        for k in list(params):
            if any(k.endswith(f"{z}.weight") for z in zero):
                params[k] = np.zeros_like(params[k])
            elif k.endswith("final_proj.weight"):
                params[k] = params[k] * np.float32(160.0)
    return {
        k: torch.from_numpy(v).to(device=device, dtype=dtype) for k, v in params.items()
    }
