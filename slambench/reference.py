"""The plain reference of the front end: SuperPoint in f32, and the check's
reference built from it and the configuration's matcher.

Written from SuperPoint's definition (its VGG encoder, detector and
descriptor heads) in plain PyTorch with TF32 off; the matcher's reference
is its module's (``matchers/<matcher>.py``), built on the helpers here. It
loads the committed safetensors itself and imports nothing of the program.

``precision="fp8"`` is the benchmark's control: every operand of a
convolution, a linear layer and an attention product rounded to float8
e4m3 with one scale per tensor (products still summed in f32), the step
below the bfloat16 the configuration states. It is run by
``calibrate.py`` and the tests, never by a benchmark run.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

CELL = 8
NEG = -1e9
PAD = 32  # frames are zero-padded to a multiple of 32 on both axes (the input contract)


def pad_to(x: int) -> int:
    return (x + PAD - 1) // PAD * PAD


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale, back in f32."""
    s = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def quantizer(precision: str):
    """What every operand goes through: nothing at ``"f32"``, ``_fp8`` at
    ``"fp8"``."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision}")
    return _fp8 if precision == "fp8" else (lambda t: t)


def load_weights(path: str, device) -> dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return {k: v.to(device=device, dtype=torch.float32) for k, v in load_file(path).items()}


class Reference:
    """SuperPoint's features; ``match`` is ``matcher``'s, the reference of the
    configuration's matcher module built at the same precision."""

    def __init__(self, sp_path: str, matcher, device, precision: str = "f32"):
        self.q = quantizer(precision)
        self.device = torch.device(device)
        self.sp = load_weights(sp_path, self.device)
        self.matcher = matcher

    # -- SuperPoint ---------------------------------------------------------
    def _conv(self, x, name):
        w, b = self.sp[f"{name}.weight"], self.sp[f"{name}.bias"]
        return F.conv2d(self.q(x), self.q(w), b, padding=w.shape[-1] // 2)

    def superpoint(self, images: torch.Tensor, nms_radius: int):
        """images (B, H, W) f32 in [0, 1] -> (NMS'd scores, pre-NMS scores,
        unit descriptor grid (B, H/8, W/8, 256))."""
        x = images[:, None]
        for names, pool in ((("conv1a", "conv1b"), True), (("conv2a", "conv2b"), True),
                            (("conv3a", "conv3b"), True), (("conv4a", "conv4b"), False)):
            for n in names:
                x = F.relu(self._conv(x, n))
            if pool:
                x = F.max_pool2d(x, 2)
        logits = self._conv(F.relu(self._conv(x, "convPa")), "convPb")
        desc = self._conv(F.relu(self._conv(x, "convDa")), "convDb")
        prob = torch.softmax(logits, dim=1)[:, :-1]
        b, _, h, w = prob.shape
        pre = prob.reshape(b, CELL, CELL, h, w).permute(0, 3, 1, 4, 2).reshape(b, h * CELL, w * CELL)
        k = 2 * nms_radius + 1
        pooled = F.max_pool2d(pre[:, None], k, 1, nms_radius)[:, 0]
        scores = torch.where(pre == pooled, pre, torch.zeros_like(pre))
        desc = desc / torch.sqrt(torch.sum(desc * desc, dim=1, keepdim=True) + 1e-12)
        return scores, pre, desc.permute(0, 2, 3, 1)

    def features(self, images_u8, sp_cfg: dict, true_w: int, true_h: int, block: int = 8):
        """Keypoints of frames (B, h, w) uint8 (numpy or tensor), in blocks.
        Returns kpts (B, K, 2) f32 pixels (sub-pixel), valid (B, K) bool,
        unit descriptors (B, K, 256) f32 (zero where invalid), each
        keypoint's integer pixel (B, K, 2) and its score (B, K) f32."""
        imgs = torch.as_tensor(np.asarray(images_u8))
        out = [self._features(imgs[i : i + block], sp_cfg, true_w, true_h)
               for i in range(0, imgs.shape[0], block)]
        return tuple(torch.cat(parts) for parts in zip(*out))

    @torch.no_grad()
    def _features(self, imgs, sp_cfg, true_w, true_h):
        b, h0, w0 = imgs.shape
        x = torch.zeros((b, pad_to(h0), pad_to(w0)), dtype=torch.float32, device=self.device)
        x[:, :h0, :w0] = imgs.to(self.device).float() / 255.0
        with full_f32():
            scores, pre, grid = self.superpoint(x, sp_cfg["nms_radius"])
        return select(scores, pre, grid, sp_cfg["max_keypoints"], sp_cfg["keypoint_threshold"],
                      sp_cfg["remove_borders"], true_w, true_h)

    def match(self, f0, f1, true_w: int, true_h: int, block: int = 8):
        """The configuration's matcher on pairs of ``features`` f0 -> f1
        (each side the whole tuple, scores included): (log-assignment,
        mutual matches)."""
        return self.matcher.match(f0, f1, true_w, true_h, block)


def select(scores, pre, grid, K: int, threshold: float, borders: int, true_w: int, true_h: int):
    """Top-K keypoints by a stable descending sort (ties keep the lowest
    flat index), valid above the threshold, away from the true border; the
    nearest cell's descriptor renormalized; a 3x3 parabolic sub-pixel
    offset (clamped to +-0.5 px) from the pre-NMS map. Returns (kpts,
    valid, desc, integer pixel, score): the score is the key of the sort,
    the NMS'd map at the integer pixel (0 on the border), as the port's
    ``select_keypoints`` gives it."""
    b, h, w = scores.shape
    gh, gw = grid.shape[1], grid.shape[2]
    ys = torch.arange(h, device=scores.device)[:, None]
    xs = torch.arange(w, device=scores.device)[None, :]
    inside = (ys >= borders) & (ys < true_h - borders) & (xs >= borders) & (xs < true_w - borders)
    flat = torch.where(inside[None], scores, torch.zeros_like(scores)).reshape(b, h * w)
    top, order = torch.sort(flat, dim=1, descending=True, stable=True)
    top, idx = top[:, :K], order[:, :K]
    yy, xx = idx // w, idx % w
    valid = top > threshold
    cell = torch.clamp(yy // CELL, max=gh - 1) * gw + torch.clamp(xx // CELL, max=gw - 1)
    desc = torch.gather(grid.reshape(b, gh * gw, -1), 1, cell[..., None].expand(-1, -1, grid.shape[-1]))
    desc = desc / torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True) + 1e-12)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    rflat = pre.reshape(b, h * w)

    def at(dy, dx):
        return torch.gather(rflat, 1, torch.clamp(yy + dy, 0, h - 1) * w + torch.clamp(xx + dx, 0, w - 1))

    def vertex(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        peak = denom < -1e-9
        off = torch.where(peak, 0.5 * (sm - sp) / torch.where(peak, denom, -torch.ones_like(denom)),
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    s0 = at(0, 0)
    off = torch.stack([vertex(at(0, -1), s0, at(0, 1)), vertex(at(-1, 0), s0, at(1, 0))], dim=-1)
    pix = torch.stack([xx, yy], dim=-1)
    return pix.float() + off * valid[..., None], valid, desc, pix, top


def extract_matches(p: torch.Tensor, mask0, mask1, threshold: float) -> torch.Tensor:
    """Mutual argmax above the threshold: row i matches column j when j is
    row i's first maximum and i is the first row reaching column j's
    maximum. Returns (B, M) int64, -1 where unmatched."""
    max0, m0 = torch.max(p, dim=2)
    rows = torch.arange(p.shape[1], device=p.device)
    max1 = torch.amax(p, dim=1)
    winner = torch.amin(torch.where(p >= max1[:, None, :], rows[None, :, None], p.shape[1]), dim=1)
    ok = (torch.gather(winner, 1, m0) == rows[None, :]) & (torch.exp(max0) > threshold) & mask0
    ok = ok & torch.gather(mask1, 1, m0)
    return torch.where(ok, m0, torch.full_like(m0, -1))


def stereo_gates(kl, kr, vl, m, min_disparity: float):
    """Disparity uL - uR of each left keypoint's match and whether it passes
    the disparity floor and the rectified-row check (|vL - vR| <= 2 px)."""
    j = torch.clamp(m, min=0)
    uR = torch.gather(kr[..., 0], 1, j)
    vR = torch.gather(kr[..., 1], 1, j)
    disp = kl[..., 0] - uR
    ok = (m >= 0) & (disp >= min_disparity) & (torch.abs(kl[..., 1] - vR) <= 2.0) & vl
    return disp, ok
