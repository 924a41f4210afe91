"""Radius-r max-window non-maximum suppression of SuperPoint's score map,
from the map or straight from the detector's logits.

``nms_suppress`` is the port of
``superslam_tpu/ops/pallas/nms.py::nms_suppress``: keep s where s equals
the (2r+1) x (2r+1) window max (zero padding, ties kept), else 0.
``scores_nms`` is what the main path runs: from the detector head's
65-channel logits to the NMS'd map and the pre-NMS map in one launch, the
function ``superslam_tpu/models/superpoint.py::superpoint_dense`` composes
(softmax over the channels, the dustbin dropped, depth-to-space, then
``nms_suppress``). Both are the kernel ``nms.cu``; its header says what
bounds it on the H100 and how the design answers that. A CPU tensor goes
through the plain versions ``nms_plain`` and ``scores_nms_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

MAX_RADIUS = 8
CELL = 8  # pixels a cell side: channel cy * 8 + cx -> pixel (8y + cy, 8x + cx)
CHANNELS = CELL * CELL + 1  # the cell's pixels and the dustbin
# The kernel's tile: TCY x TCX cells a block (nms.cu; tests/test_torch_nms_model.py
# checks these against the source).
TILE_CELLS = (4, 8)
NWARPS = 8


def tile_layout(tcy: int = TILE_CELLS[0], tcx: int = TILE_CELLS[1]) -> dict[str, int]:
    """The kernel's shared-memory layout in floats (nms.cu's constants): the
    staged pixel tile ``SH`` x ``XP`` at 0, then the logits tile of ``SCY``
    rows of ``SPAN`` floats, reused as the row-max tile ``SH`` x ``TW``."""
    th, tw = tcy * CELL, tcx * CELL
    scy, scx = tcy + 2, tcx + 2
    sh, sw = scy * CELL, scx * CELL
    xp = sw + 8 - sw % 16
    span = scx * CHANNELS
    x_floats, l_floats = sh * xp, scy * span
    return {
        "TH": th, "TW": tw, "SCY": scy, "SCX": scx, "SH": sh, "SW": sw, "XP": xp,
        "SPAN": span, "X_FLOATS": x_floats, "L_FLOATS": l_floats,
        "SMEM_BYTES": 4 * (x_floats + l_floats),
    }


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


def scores_nms_plain(logits: torch.Tensor, radius: int = 4, return_pre: bool = False):
    """The composition ``scores_nms`` fuses: softmax over the channels, the
    dustbin dropped, depth-to-space, ``nms_plain`` (none at radius 0)."""
    scores = torch.softmax(logits, dim=1)[:, :-1]  # (B, 64, h, w)
    b, _, h, w = scores.shape
    scores = scores.reshape(b, CELL, CELL, h, w).permute(0, 3, 1, 4, 2)
    pre = scores.reshape(b, h * CELL, w * CELL).contiguous()
    out = nms_plain(pre, radius) if radius > 0 else pre
    return out, (pre if return_pre else None)


def scores_nms(logits: torch.Tensor, radius: int = 4, return_pre: bool = False):
    """(B, 65, h, w) f32 detector logits -> (NMS'd map, pre-NMS map or None),
    both (B, 8h, 8w) f32. At radius 0 the NMS'd map is the pre-NMS map, as
    the JAX package skips NMS. The kernel reads the logits channels_last,
    the layout the detector head's convs give them (a copy otherwise)."""
    if logits.dtype != torch.float32 or logits.dim() != 4 or logits.shape[1] != CHANNELS:
        raise ValueError(
            f"scores_nms: needs (B, {CHANNELS}, h, w) f32 logits, got "
            f"{tuple(logits.shape)} {logits.dtype}"
        )
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"scores_nms: radius {radius} outside 0..{MAX_RADIUS}")
    if logits.device.type == "cpu":
        return scores_nms_plain(logits, radius, return_pre)
    if logits.device.type != "cuda":
        raise ValueError(f"scores_nms: unsupported device {logits.device}")
    x = logits.contiguous(memory_format=torch.channels_last)
    b, _, h, w = x.shape
    out = torch.empty((b, h * CELL, w * CELL), dtype=torch.float32, device=x.device)
    pre = torch.empty_like(out) if return_pre else None
    err = _build.library().ssl_scores_nms(
        x.data_ptr(), None if pre is None else pre.data_ptr(), out.data_ptr(), b, h, w, radius,
        _build.stream_of(x),
    )
    _build.check(err, "scores_nms")
    _build.count("scores_nms")
    return out, pre
