"""SuperPoint keypoint detector + descriptor on PyTorch tensors.

Port of ``superslam_tpu/models/superpoint.py``: the conv1a..conv4b VGG
encoder, the 65-channel detector head with softmax + depth-to-space +
radius-4 max-window NMS, and the 256-d descriptor head with channel-wise
L2 normalization; then on-device top-K selection, the nearest-cell
descriptor gather and the optional 3x3 parabolic sub-pixel refinement.

Routing, as on the TPU's default route:
- conv1a+conv1b+pool and conv2a+conv2b+pool go through the hand-written
  conv-pair kernel (``ops/cuda/conv.py``; its plain version on CPU), with
  the kernel operands that ``prepare_superpoint_params`` makes once when the
  parameters carry them;
- conv3a..the heads are ``F.conv2d`` in the compute dtype, as the JAX
  package leaves them to XLA;
- the score half (softmax over the 65 detector channels, the dustbin
  dropped, depth-to-space, radius-r NMS) is one launch of the hand-written
  kernel in logits mode (``ops/cuda/nms.py::scores_nms``): it reads the
  head's channels_last logits once, keeps the probabilities in its tile and
  writes the NMS'd and the pre-NMS map once each, where the JAX package
  lets XLA fuse the softmax and the depth-to-space ahead of its Pallas NMS;
- the descriptor gather of ``select_keypoints`` is the hand-written
  kernel (``ops/cuda/gather.py``, its plain version on CPU) by default,
  where the JAX package's default is XLA's gather with the bf16 -> f32
  conversion fused into it: eager PyTorch has no counterpart of that
  fusion (its composition gathers, widens and normalizes in seven
  launches). ``use_kernel=False``, the
  counterpart of the JAX package's ``use_pallas=False``, takes the plain
  composition for a caller that asks for it.

Parameters are a flat dict of torch-layout tensors (OIHW convs) keyed by
the torch state-dict names (plus the derived ``<pair>.__kernel`` entries of
``prepare_superpoint_params``). The public functions keep the JAX package's
layouts: scores (B, H, W), descriptor grid NHWC (B, H/8, W/8, 256).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.conv import conv_pair_pool, pair_operands
from ..ops.cuda.gather import gather_normalize, gather_normalize_plain
from ..ops.cuda.nms import scores_nms, scores_nms_plain

Params = dict[str, torch.Tensor]

DESCRIPTOR_DIM = 256
CELL = 8  # stride of the descriptor grid
KERNEL_KEY = "__kernel"  # suffix of a conv pair's prepared kernel operands
_PAIRS = ("conv1", "conv2")


def _pair_weights(params: Params, pair: str) -> list[torch.Tensor]:
    """OIHW weight and bias of conv ``<pair>a``, then of ``<pair>b``."""
    return [params[f"{pair}{ab}.{kind}"] for ab in "ab" for kind in ("weight", "bias")]


def prepare_superpoint_params(params: Params, device) -> Params:
    """What an extractor or pipeline does to a checkpoint once at
    construction: move it to ``device`` and add each conv pair's kernel
    operands (``ops/cuda/conv.py::pair_operands``: conv1a f32 (64, 9);
    conv1b, conv2a and conv2b bf16 (tap, co, ci); the four biases contiguous
    f32) as a tuple under ``conv1.__kernel`` and ``conv2.__kernel``, so the
    conv wrappers launch their kernels alone. The derived entries are not
    tensors, and the savers and ``to_jax_params`` leave them out."""
    out = {k: v.to(device) for k, v in params.items() if not k.endswith(KERNEL_KEY)}
    for pair in _PAIRS:
        out[f"{pair}.{KERNEL_KEY}"] = pair_operands(*_pair_weights(out, pair))
    return out


def _conv(x: torch.Tensor, params: Params, name: str, dtype) -> torch.Tensor:
    """3x3 (SAME) or 1x1 conv, NCHW, in ``dtype``; the bias is added after
    the conv's rounding to ``dtype``, as in the JAX package."""
    w = params[f"{name}.weight"].to(dtype)
    b = params[f"{name}.bias"].to(dtype)
    return F.conv2d(x.to(dtype), w, padding=w.shape[-1] // 2) + b[:, None, None]


def _tail(params: Params, x: torch.Tensor, compute_dtype):
    """conv3a..both heads from the quarter-resolution (B, 64, H/4, W/4) map:
    cuDNN convs, as the JAX package leaves them to XLA.

    Returns (logits (B, 65, H/8, W/8) f32, desc_raw (B, 256, H/8, W/8)
    unnormalized in compute_dtype)."""
    p = params
    x = F.relu(_conv(x, p, "conv3a", compute_dtype))
    x = F.relu(_conv(x, p, "conv3b", compute_dtype))
    x = F.max_pool2d(x, 2)
    x = F.relu(_conv(x, p, "conv4a", compute_dtype))
    x = F.relu(_conv(x, p, "conv4b", compute_dtype))
    c_pa = F.relu(_conv(x, p, "convPa", compute_dtype))
    logits = _conv(c_pa, p, "convPb", compute_dtype).float()
    c_da = F.relu(_conv(x, p, "convDa", compute_dtype))
    desc = _conv(c_da, p, "convDb", compute_dtype)
    return logits, desc


def _encoder_and_heads(params: Params, image: torch.Tensor, compute_dtype):
    """VGG encoder + both heads at descriptor-grid resolution: the two conv
    pairs through the hand-written kernel, then ``_tail``."""
    x = image[:, None]
    for pair in _PAIRS:
        x = conv_pair_pool(
            x, *_pair_weights(params, pair), compute_dtype=compute_dtype,
            operands=params.get(f"{pair}.{KERNEL_KEY}"),
        )
    return _tail(params, x, compute_dtype)


def superpoint_raw(params: Params, image: torch.Tensor, compute_dtype=torch.float32):
    """Training-time forward: raw detector logits and the L2-normalized
    descriptor grid, both at cell resolution and differentiable end to end.
    Every conv is ``F.conv2d`` (cuDNN on the card), the conv pairs included:
    the JAX package's training forward always takes its XLA conv path, never
    the Pallas kernels, so no hand-written kernel is on this path.

    image: (B, H, W) in [0, 1]; H, W multiples of 8.
    Returns (the JAX package's layouts):
      logits (B, H/8, W/8, 65) f32, 64 in-cell positions + dustbin;
      desc (B, H/8, W/8, 256) f32, L2-normalized over channels.
    """
    x = image[:, None]
    for pair in _PAIRS:
        x = F.relu(_conv(x, params, f"{pair}a", compute_dtype))
        x = F.relu(_conv(x, params, f"{pair}b", compute_dtype))
        x = F.max_pool2d(x, 2)
    logits, desc = _tail(params, x, compute_dtype)
    desc = desc.float()
    desc = desc * torch.rsqrt(torch.sum(torch.square(desc), dim=1, keepdim=True) + 1e-12)
    return logits.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def _scores_and_descriptors(
    logits, desc, nms_radius: int, compute_dtype, return_pre_nms: bool, nms=None
):
    """The heads' outputs -> (NMS'd heatmap, normalized NHWC descriptor grid
    [, pre-NMS heatmap]): softmax, depth-to-space, NMS and the channel-wise
    L2 normalization. By default the score half is ``scores_nms`` (one
    kernel launch on the card); a map-to-map ``nms`` (``nms_plain``, or the
    map-mode kernel ``nms_suppress``) composes it from PyTorch's softmax
    and depth-to-space instead."""
    if nms is None:
        scores, pre_nms = scores_nms(logits, nms_radius, return_pre_nms)
    else:
        pre_nms = scores_nms_plain(logits, 0)[0]  # softmax + depth-to-space
        scores = nms(pre_nms, nms_radius) if nms_radius > 0 else pre_nms
    sq = torch.sum(torch.square(desc.float()), dim=1, keepdim=True)
    desc = desc * torch.rsqrt(sq + 1e-12).to(compute_dtype)
    desc = desc.permute(0, 2, 3, 1).contiguous()  # NHWC
    if return_pre_nms:
        return scores, desc, pre_nms
    return scores, desc


def superpoint_dense(
    params: Params,
    image: torch.Tensor,
    nms_radius: int = 4,
    compute_dtype=torch.bfloat16,
    return_pre_nms: bool = False,
):
    """Dense forward pass.

    Args:
      image: (B, H, W) grayscale in [0, 1]; H, W multiples of 8.
      return_pre_nms: also return the heatmap BEFORE non-max suppression
        (select_keypoints' sub-pixel refinement reads its 3x3 neighbours).
    Returns:
      scores (B, H, W) f32 NMS'd heatmap;
      descriptors (B, H/8, W/8, 256) L2-normalized grid (compute_dtype);
      [pre_nms (B, H, W) f32 when return_pre_nms].
    """
    logits, desc = _encoder_and_heads(params, image, compute_dtype)
    return _scores_and_descriptors(logits, desc, nms_radius, compute_dtype, return_pre_nms)


def select_keypoints(
    scores: torch.Tensor,
    descriptors: torch.Tensor,
    max_keypoints: int,
    keypoint_threshold: float = 0.005,
    remove_borders: int = 4,
    true_width: int | None = None,
    true_height: int | None = None,
    raw_scores: torch.Tensor | None = None,
    use_kernel: bool = True,
):
    """On-device top-K keypoint selection + nearest-cell descriptor gather.

    Static output shapes: exactly K rows per image with a validity mask
    (score > threshold); valid rows form a prefix. Top-K is a stable
    descending sort, so ties keep the lowest flat index (what the JAX
    package's exact CPU top-k does; its TPU approx_max_k is no contract).

    Args:
      scores: (B, H, W) f32 NMS'd heatmap (may include zero padding).
      descriptors: (B, H/8, W/8, D) normalized grid.
      true_width/true_height: the un-padded image extent; borders are
        enforced against it so padding never produces keypoints.
      raw_scores: optional (B, H, W) pre-NMS heatmap; when given, each
        keypoint is refined to sub-pixel position by independent 1-D
        parabolic fits over the raw 3x3 neighbourhood (offsets clamped to
        +-0.5 px).
      use_kernel: gather and renormalize the descriptor rows with the
        hand-written kernel (one launch for the whole batch; the default);
        False takes torch.gather + rsqrt.
    Returns:
      kpts (B, K, 2) f32 (x, y) pixels; kp_scores (B, K) f32;
      valid (B, K) bool; desc (B, K, D) gathered rows (renormalized f32).
    """
    b, h, w = scores.shape
    gh, gw = descriptors.shape[1], descriptors.shape[2]
    tw = true_width if true_width is not None else w
    th = true_height if true_height is not None else h
    dev = scores.device

    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    border = (
        (ys >= remove_borders)
        & (ys < th - remove_borders)
        & (xs >= remove_borders)
        & (xs < tw - remove_borders)
    )
    scores = torch.where(border[None], scores, torch.zeros_like(scores))

    flat = scores.reshape(b, h * w)
    sorted_scores, order = torch.sort(flat, dim=1, descending=True, stable=True)
    top_scores = sorted_scores[:, :max_keypoints]
    top_idx = order[:, :max_keypoints]
    yy = top_idx // w
    xx = top_idx % w
    valid = top_scores > keypoint_threshold

    cy = torch.clamp(yy // CELL, max=gh - 1)
    cx = torch.clamp(xx // CELL, max=gw - 1)
    cell = cy * gw + cx  # (B, K)
    grid = descriptors.reshape(b, gh * gw, -1)
    # Gathered rows are renormalized in f32 (bf16 grid rows are only
    # approximately unit).
    desc = (gather_normalize if use_kernel else gather_normalize_plain)(grid, cell)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))

    kpts = torch.stack([xx, yy], dim=-1).float()
    if raw_scores is not None:
        rflat = raw_scores.reshape(b, h * w)

        def nb(dy: int, dx: int) -> torch.Tensor:
            yq = torch.clamp(yy + dy, 0, h - 1)
            xq = torch.clamp(xx + dx, 0, w - 1)
            return torch.gather(rflat, 1, yq * w + xq)

        def para(sm, s0, sp):
            # Vertex of the parabola through (-1, sm), (0, s0), (1, sp); a
            # peak has negative curvature, anything else keeps 0.
            denom = sm - 2.0 * s0 + sp
            peak = denom < -1e-9
            safe = torch.where(peak, denom, torch.full_like(denom, -1.0))
            off = torch.where(peak, 0.5 * (sm - sp) / safe, torch.zeros_like(denom))
            return torch.clamp(off, -0.5, 0.5)

        s0 = nb(0, 0)
        dx = para(nb(0, -1), s0, nb(0, 1))
        dy = para(nb(-1, 0), s0, nb(1, 0))
        kpts = kpts + torch.stack([dx, dy], dim=-1) * valid[..., None]
    return kpts, top_scores, valid, desc


def superpoint_extract(
    params: Params,
    image: torch.Tensor,
    max_keypoints: int = 1024,
    keypoint_threshold: float = 0.005,
    remove_borders: int = 4,
    nms_radius: int = 4,
    true_width: int | None = None,
    true_height: int | None = None,
    subpixel: bool = False,
    use_kernel: bool = True,
):
    """Full extraction: dense heads + on-device selection.

    image: (B, H, W) f32 in [0, 1]; the stereo path is B=2. subpixel=True
    adds the 3x3 parabolic refinement; use_kernel=False takes the plain
    descriptor gather instead of the hand-written kernel (select_keypoints)."""
    with torch.no_grad():
        out = superpoint_dense(params, image, nms_radius=nms_radius, return_pre_nms=subpixel)
        return select_keypoints(
            out[0], out[1], max_keypoints, keypoint_threshold, remove_borders,
            true_width, true_height, raw_scores=out[2] if subpixel else None,
            use_kernel=use_kernel,
        )


# -- parameter init -----------------------------------------------------------

_SP_LAYERS = [
    ("conv1a", 1, 64),
    ("conv1b", 64, 64),
    ("conv2a", 64, 64),
    ("conv2b", 64, 64),
    ("conv3a", 64, 128),
    ("conv3b", 128, 128),
    ("conv4a", 128, 128),
    ("conv4b", 128, 128),
    ("convPa", 128, 256),
    ("convPb", 256, 65),
    ("convDa", 128, 256),
    ("convDb", 256, DESCRIPTOR_DIM),
]


def init_superpoint_params(seed: int = 0, device="cpu", dtype=torch.float32) -> Params:
    """He-init random parameters (OIHW), drawn through the same numpy RNG
    sequence as the JAX package's init (there HWIO), so a seed gives
    identical weights."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for name, cin, cout in _SP_LAYERS:
        k = 1 if name in ("convPb", "convDb") else 3
        std = float(np.sqrt(2.0 / (k * k * cin)))
        hwio = (rng.standard_normal((k, k, cin, cout)) * std).astype(np.float32)
        params[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(hwio.transpose(3, 2, 0, 1))
        ).to(device=device, dtype=dtype)
        params[f"{name}.bias"] = torch.zeros((cout,), device=device, dtype=dtype)
    return params
