"""Key-masked scaled dot-product attention for LightGlue (forward).

``masked_attention`` is the port of the forward of
``superslam_tpu/ops/pallas/attention.py::masked_attention``: softmax over
keys of q k^T / sqrt(64) with masked keys at -1e9, the probabilities cast
to v's type before the PV product. The kernel is ``masked_attention.cu``;
its header says what bounds it on the H100 and how the design answers
that. A CPU tensor goes through ``masked_attention_plain``.

A query row whose keys are all masked gets the uniform mean of v over the
N real keys (masked logits are replaced, not offset), as the XLA route of
the JAX package does. Its Pallas kernel pads N to a multiple of 128 with
masked zero keys, so there such a row gets n/n_pad times that mean.
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 64
NEG = -1e9


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """einsum + f32 softmax; q, k, v (B, H, N, D), key_mask (B, N) bool."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    logits = torch.where(
        key_mask[:, None, None, :], logits, torch.full_like(logits, NEG)
    )
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """(B, H, N, 64) q, k, v in bf16 or f32 + (B, N) bool key mask ->
    (B, H, N, 64) in v's type."""
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    b, h, n, d = q.shape
    if d != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"masked_attention: shapes {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.bfloat16,
        torch.float32,
    ):
        raise ValueError(f"masked_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if key_mask.shape != (b, n) or key_mask.dtype != torch.bool:
        raise ValueError(f"masked_attention: key_mask {key_mask.shape} {key_mask.dtype}")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    mc = key_mask.contiguous()
    out = torch.empty_like(vc)
    err = _build.library().ssl_masked_attention(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), mc.data_ptr(), out.data_ptr(),
        b, h, n, int(q.dtype == torch.bfloat16), _build.stream_of(q),
    )
    _build.check(err, "masked_attention")
    _build.count("masked_attention")
    return out
