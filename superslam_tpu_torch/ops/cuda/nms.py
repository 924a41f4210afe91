"""9x9 (radius-r) max-window non-maximum suppression of a score map.

``nms_suppress`` is the port of
``superslam_tpu/ops/pallas/nms.py::nms_suppress``: keep s where s equals
the (2r+1) x (2r+1) window max (zero padding, ties kept), else 0. The
kernel is ``nms.cu``; its header says what bounds it on the H100 and how
the design answers that. A CPU tensor goes through ``nms_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

MAX_RADIUS = 8


def nms_plain(scores: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Two 1-D max pools (the window max is separable) and a compare.
    max_pool2d pads with -inf; scores are >= 0, so that equals the kernel's
    zero padding."""
    k = 2 * radius + 1
    x = scores[:, None]
    pooled = F.max_pool2d(x, (1, k), 1, (0, radius))
    pooled = F.max_pool2d(pooled, (k, 1), 1, (radius, 0))[:, 0]
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def nms_suppress(scores: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """(B, H, W) f32 score map -> NMS'd map, non-peaks zeroed."""
    if scores.device.type == "cpu":
        return nms_plain(scores, radius)
    if scores.device.type != "cuda":
        raise ValueError(f"nms_suppress: unsupported device {scores.device}")
    if scores.dtype != torch.float32 or scores.dim() != 3:
        raise ValueError(f"nms_suppress: needs (B, H, W) f32, got {scores.dtype}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"nms_suppress: radius {radius} > {MAX_RADIUS}")
    s = scores.contiguous()
    out = torch.empty_like(s)
    b, h, w = s.shape
    err = _build.library().ssl_nms(
        s.data_ptr(), out.data_ptr(), b, h, w, radius, _build.stream_of(s)
    )
    _build.check(err, "nms_suppress")
    _build.count("nms")
    return out
