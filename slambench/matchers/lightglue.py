"""LightGlue as a configuration's matcher (``"matcher": "lightglue"``).

Its settings are the configuration's ``"lightglue"`` block: ``layers``,
``width``, ``heads``, ``match_threshold``, ``early_exit`` and ``pruning``
(both off) and ``checkpoint``. What the harness takes from a matcher module:

- ``load(cfg, root, device)``: the parameters handed to the port;
- ``port_kwargs(cfg)``: the port's keyword arguments beside them;
- ``prepared(pipeline)``: the parameters as the port's RGB-D pipeline
  prepared them, which its step is called with;
- ``Reference(cfg, root, device, precision)``: the plain reference, whose
  ``match(f0, f1, true_w, true_h)`` gives (log-assignment, matches);
- ``work(cfg, n0, n1)``: (operations, bytes) of one pair problem.

The reference is written from the model's definition (9 layers of rotary
self-attention and cross-attention, dual-softmax assignment and mutual
matching, early exit and pruning off) in plain PyTorch with TF32 off. It
loads the committed safetensors itself and imports nothing of the program.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from slambench.reference import NEG, extract_matches, full_f32, load_weights, quantizer

BLOCK = "lightglue"


def load(cfg: dict, root: str, device) -> dict[str, torch.Tensor]:
    return load_weights(os.path.join(root, cfg[BLOCK]["checkpoint"]), device)


def port_kwargs(cfg: dict) -> dict:
    return {"match_threshold": cfg[BLOCK]["match_threshold"]}


def prepared(pipeline) -> dict:
    return pipeline.lg_params


class Reference:
    def __init__(self, cfg: dict, root: str, device, precision: str = "f32"):
        self.cfg = cfg[BLOCK]
        self.device = torch.device(device)
        self.lg = load_weights(os.path.join(root, self.cfg["checkpoint"]), self.device)
        self.q = quantizer(precision)

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
    def match(self, f0, f1, true_w: int, true_h: int, block: int = 8):
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
                                   self.cfg["heads"], self.cfg["layers"])
            la.append(p)
            mt.append(extract_matches(p, v0, v1, self.cfg["match_threshold"]))
        return torch.cat(la), torch.cat(mt)


# -- the work (flops.py's conventions) -------------------------------------------


def lightglue_linear_params(dim: int, layers: int) -> int:
    """Weights of the linear layers (bias included)."""
    lin = lambda i, o: i * o + o  # noqa: E731
    per_layer = (lin(dim, 3 * dim) + lin(dim, dim) + lin(2 * dim, 2 * dim) + lin(2 * dim, dim)
                 + 3 * lin(dim, dim) + lin(2 * dim, 2 * dim) + lin(2 * dim, dim))
    return lin(dim, dim) + layers * per_layer + lin(dim, dim) + lin(dim, 1)


def lightglue_flops(n0: int, n1: int, dim: int, layers: int, heads: int) -> float:
    """One pair problem with n0 and n1 keypoints."""
    tokens = n0 + n1
    per_token = (
        2 * dim * 3 * dim + 2 * dim * dim + 2 * (2 * dim) * (2 * dim) + 2 * (2 * dim) * dim  # self
        + 3 * 2 * dim * dim + 2 * (2 * dim) * (2 * dim) + 2 * (2 * dim) * dim  # cross
    )
    attention = 4.0 * dim * (n0 * n0 + n1 * n1) + 8.0 * dim * n0 * n1  # QK^T and PV, both blocks
    head = 2.0 * dim * dim * tokens + 2.0 * n0 * n1 * dim + 2.0 * dim * tokens  # assignment
    rotary = 2.0 * 2 * (dim // heads // 2) * tokens  # the positional projection
    return 2.0 * dim * dim * tokens + layers * (per_token * tokens + attention) + head + rotary


def lightglue_bytes(n0: int, n1: int, dim: int, layers: int) -> float:
    """Keypoints (2 f32), validity and f32 descriptors of both sides and the
    bf16 weights in; one int32 match index a row of side 0 out."""
    return (n0 + n1) * (2 * 4 + 1 + dim * 4) + 2.0 * lightglue_linear_params(dim, layers) + 4.0 * n0


def work(cfg: dict, n0: int, n1: int) -> tuple[float, float]:
    c = cfg[BLOCK]
    return (lightglue_flops(n0, n1, c["width"], c["layers"], c["heads"]),
            lightglue_bytes(n0, n1, c["width"], c["layers"]))
