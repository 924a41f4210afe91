"""The plain reference of the front end: SuperPoint and LightGlue in f32.

Written from the models' definitions (SuperPoint's VGG encoder, detector
and descriptor heads; LightGlue's 9 layers of rotary self-attention and
cross-attention, dual-softmax assignment and mutual matching, early exit
and pruning off), in plain PyTorch with TF32 off. It loads the committed
safetensors itself and imports nothing of the program.

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


def load_weights(path: str, device) -> dict[str, torch.Tensor]:
    from safetensors.torch import load_file

    return {k: v.to(device=device, dtype=torch.float32) for k, v in load_file(path).items()}


class Reference:
    def __init__(self, sp_path: str, lg_path: str, device, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision}")
        self.device = torch.device(device)
        self.sp = load_weights(sp_path, self.device)
        self.lg = load_weights(lg_path, self.device)
        self.q = _fp8 if precision == "fp8" else (lambda t: t)

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
        unit descriptors (B, K, 256) f32 (zero where invalid) and each
        keypoint's integer pixel (B, K, 2)."""
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

    # -- LightGlue -----------------------------------------------------------
    def _linear(self, x, name):
        y = self.q(x) @ self.q(self.lg[f"{name}.weight"]).t()
        b = self.lg.get(f"{name}.bias")
        return y if b is None else y + b

    def _attention(self, q, k, v, key_mask):
        logits = torch.einsum("bhid,bhjd->bhij", self.q(q), self.q(k)) / float(q.shape[-1]) ** 0.5
        logits = torch.where(key_mask[:, None, None, :], logits, torch.full_like(logits, NEG))
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhij,bhjd->bhid", self.q(p), self.q(v))

    def _ffn(self, x, msg, prefix):
        h = self._linear(torch.cat([x, msg], dim=-1), f"{prefix}.0")
        h = F.layer_norm(h, h.shape[-1:], self.lg[f"{prefix}.1.weight"], self.lg[f"{prefix}.1.bias"], 1e-5)
        return x + self._linear(F.gelu(h), f"{prefix}.3")

    def lightglue(self, kpts0, desc0, kpts1, desc1, mask0, mask1, heads: int, layers: int):
        """Log-assignment (B, M, N) of normalized keypoints and unit
        descriptors; masks mark real keypoints."""
        b, n, _ = desc0.shape
        x = torch.stack([desc0, desc1], 1).reshape(2 * b, n, -1)
        kp = torch.stack([kpts0, kpts1], 1).reshape(2 * b, n, 2)
        mask = torch.stack([mask0, mask1], 1).reshape(2 * b, n)
        dim = x.shape[-1]
        hd = dim // heads
        x = self._linear(x, "input_proj")
        proj = kp @ self.lg["posenc.Wr.weight"].t()
        cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)[:, None]
        sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)[:, None]

        def rotate(t):
            t2 = t.reshape(*t.shape[:-1], -1, 2)
            half = torch.stack([-t2[..., 1], t2[..., 0]], dim=-1).reshape(t.shape)
            return t * cos + half * sin

        def split(t):
            return t.reshape(2 * b, n, heads, hd).permute(0, 2, 1, 3)

        def merge(t):
            return t.permute(0, 2, 1, 3).reshape(2 * b, n, dim)

        def swap(t):
            return t.reshape(b, 2, *t.shape[1:]).flip(1).reshape(t.shape)

        for i in range(layers):
            p = f"transformers.{i}.self_attn"
            qkv = self._linear(x, f"{p}.Wqkv").reshape(2 * b, n, heads, hd, 3).permute(0, 2, 1, 3, 4)
            ctx = self._attention(rotate(qkv[..., 0]), rotate(qkv[..., 1]), qkv[..., 2], mask)
            x = self._ffn(x, self._linear(merge(ctx), f"{p}.out_proj"), f"{p}.ffn")
            p = f"transformers.{i}.cross_attn"
            qk, v = split(self._linear(x, f"{p}.to_qk")), split(self._linear(x, f"{p}.to_v"))
            ctx = self._attention(qk, swap(qk), swap(v), swap(mask))
            x = self._ffn(x, self._linear(merge(ctx), f"{p}.to_out"), f"{p}.ffn")
        a = f"log_assignment.{layers - 1}"
        x0, x1 = x[0::2], x[1::2]
        s = float(dim) ** 0.25
        d0 = self._linear(x0, f"{a}.final_proj") / s
        d1 = self._linear(x1, f"{a}.final_proj") / s
        sim = torch.einsum("bmd,bnd->bmn", self.q(d0), self.q(d1))
        both = mask0[:, :, None] & mask1[:, None, :]
        sim = torch.where(both, sim, torch.full_like(sim, NEG))
        z0 = self._linear(x0, f"{a}.matchability")[..., 0]
        z1 = self._linear(x1, f"{a}.matchability")[..., 0]
        cert = F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
        return torch.log_softmax(sim, dim=2) + torch.log_softmax(sim, dim=1) + cert

    @torch.no_grad()
    def match(self, f0, f1, lg_cfg: dict, true_w: int, true_h: int, block: int = 8):
        """Log-assignment and mutual matches of pairs (kpts, valid, desc)
        f0 -> f1, each (B, K, ...), in blocks of pairs."""
        center = torch.tensor([true_w / 2.0, true_h / 2.0], device=self.device)
        scale = max(true_w, true_h) / 2.0
        la, mt = [], []
        for i in range(0, f0[0].shape[0], block):
            sl = slice(i, i + block)
            k0, v0, d0 = (t[sl].to(self.device) for t in f0[:3])
            k1, v1, d1 = (t[sl].to(self.device) for t in f1[:3])
            with full_f32():
                p = self.lightglue((k0 - center) / scale, d0, (k1 - center) / scale, d1, v0, v1,
                                   lg_cfg["heads"], lg_cfg["layers"])
            la.append(p)
            mt.append(extract_matches(p, v0, v1, lg_cfg["match_threshold"]))
        return torch.cat(la), torch.cat(mt)


def select(scores, pre, grid, K: int, threshold: float, borders: int, true_w: int, true_h: int):
    """Top-K keypoints by a stable descending sort (ties keep the lowest
    flat index), valid above the threshold, away from the true border; the
    nearest cell's descriptor renormalized; a 3x3 parabolic sub-pixel
    offset (clamped to +-0.5 px) from the pre-NMS map. Returns (kpts,
    valid, desc, integer pixel)."""
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
    return pix.float() + off * valid[..., None], valid, desc, pix


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
