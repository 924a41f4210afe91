"""Descriptor gather + L2 normalisation for the selected keypoints.

``gather_normalize`` is the port of
``superslam_tpu/ops/pallas/gather.py::gather_normalize``: row ``cells[b, k]``
of the dense (G, D) descriptor grid of image b, scaled by
rsqrt(sum of squares + 1e-12), in f32. The TPU kernel takes one image per
call; this one takes the whole (B, K) batch in one launch. The kernel is
``gather.cu``; its header says what bounds it on the H100 and how the
design answers that. A CPU tensor goes through ``gather_normalize_plain``.
Cell ids must lie in [0, G) (the kernel clamps, the plain version raises).
"""

from __future__ import annotations

import torch

from . import _build


def gather_normalize_plain(grid: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """torch.gather + rsqrt; grid (B, G, D), cells (B, K) integer. The rows
    are gathered in the grid's dtype and then widened to f32 (exact from
    bf16), so no f32 copy of the whole grid is made."""
    idx = cells.to(torch.int64)[..., None].expand(-1, -1, grid.shape[-1])
    desc = torch.gather(grid, 1, idx).float()
    return desc * torch.rsqrt(torch.sum(torch.square(desc), dim=-1, keepdim=True) + 1e-12)


def gather_normalize(grid: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """grid (B, G, D) bf16 or f32 with D a multiple of 8, cells (B, K) int32
    or int64 flat cell ids -> (B, K, D) f32 unit rows."""
    if grid.device.type == "cpu":
        return gather_normalize_plain(grid, cells)
    if grid.device.type != "cuda":
        raise ValueError(f"gather_normalize: unsupported device {grid.device}")
    if grid.dim() != 3 or grid.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gather_normalize: grid {tuple(grid.shape)} {grid.dtype}")
    b, g, d = grid.shape
    if d % 8 or min(b, g, d) < 1:
        raise ValueError(f"gather_normalize: grid {tuple(grid.shape)}")
    if (
        cells.dim() != 2
        or cells.shape[0] != b
        or cells.shape[1] < 1
        or cells.dtype not in (torch.int32, torch.int64)
        or cells.device != grid.device
    ):
        raise ValueError(f"gather_normalize: cells {tuple(cells.shape)} {cells.dtype}")
    gc = grid.contiguous()
    cc = cells.to(torch.int64).contiguous()
    out = torch.empty((b, cells.shape[1], d), dtype=torch.float32, device=grid.device)
    err = _build.library().ssl_gather_normalize(
        gc.data_ptr(), cc.data_ptr(), out.data_ptr(), b, g, cells.shape[1], d,
        int(grid.dtype == torch.bfloat16), _build.stream_of(grid),
    )
    _build.check(err, "gather_normalize")
    _build.count("gather_normalize")
    return out
