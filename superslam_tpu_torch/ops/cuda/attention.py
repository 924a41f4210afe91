"""Key-masked scaled dot-product attention for LightGlue, differentiable.

``masked_attention`` is the port of
``superslam_tpu/ops/pallas/attention.py::masked_attention``: softmax over
keys of q k^T / sqrt(64) with masked keys at -1e9, the probabilities cast
to v's type before the PV product. The forward kernel is
``masked_attention.cu``, the backward kernels ``attention_bwd.cu`` (the
port of the JAX function's custom VJP, ``_sdpa_bwd``); their headers say
what bounds them on the H100 and how the designs answer that. A CPU tensor
goes through ``masked_attention_plain`` and
``masked_attention_backward_plain``.

One ``torch.autograd.Function`` serves every device, so a result carries a
``grad_fn`` on the card as on the CPU. It saves q, k, v and the mask (the
JAX VJP's residuals); under ``torch.no_grad()`` nothing is saved. The mask
gets no gradient. Launches count as ``masked_attention`` (forward) and
``masked_attention_bwd`` (backward).

A query row whose keys are all masked gets the uniform mean of v over the
N real keys (masked logits are replaced, not offset), as the XLA route of
the JAX package does. Its Pallas kernel pads N to a multiple of 128 with
masked zero keys, so there such a row gets n/n_pad times that mean. The
backward is the gradient of this forward: a replaced logit is a constant,
so in such a row only dv is non-zero (``_sdpa_bwd`` offsets the logits
instead; the two agree wherever a row has one real key).
"""

from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 64
NEG = -1e9


def _inner_dtype(t: torch.Tensor) -> torch.dtype:
    """f32 inside, except f64 inputs (CPU gradient checks) stay f64."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _masked_probabilities(q, k, key_mask, ft):
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bhid,bhjd->bhij", q.to(ft), k.to(ft)) * scale
    logits = torch.where(
        key_mask[:, None, None, :], logits, torch.full_like(logits, NEG)
    )
    return torch.softmax(logits, dim=-1), scale


def masked_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """einsum + f32 softmax; q, k, v (B, H, N, D), key_mask (B, N) bool."""
    ft = _inner_dtype(q)
    attn, _ = _masked_probabilities(q, k, key_mask, ft)
    out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype).to(ft), v.to(ft))
    return out.to(v.dtype)


def masked_attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the formula of ``_sdpa_bwd``: the probabilities are
    recomputed in f32, results are cast to the inputs' types. A masked
    logit is a constant of the forward, so its ds is zeroed."""
    ft = _inner_dtype(q)
    p, scale = _masked_probabilities(q, k, key_mask, ft)
    g = grad_out.to(ft)
    dv = torch.einsum("bhij,bhid->bhjd", p, g)
    dp = torch.einsum("bhid,bhjd->bhij", g, v.to(ft))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = torch.where(key_mask[:, None, None, :], ds, torch.zeros_like(ds))
    dq = torch.einsum("bhij,bhjd->bhid", ds, k.to(ft)) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q.to(ft)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name: str, q, k, v, key_mask) -> None:
    b, _, n, d = q.shape
    if d != HEAD_DIM or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: shapes {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.bfloat16,
        torch.float32,
    ):
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if key_mask.shape != (b, n) or key_mask.dtype != torch.bool:
        raise ValueError(f"{name}: key_mask {key_mask.shape} {key_mask.dtype}")


def _forward(q, k, v, key_mask) -> torch.Tensor:
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention: unsupported device {q.device}")
    _check("masked_attention", q, k, v, key_mask)
    b, h, n, _ = q.shape
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


def masked_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    grad_out: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``masked_attention`` with respect to q, k and v, each
    (B, H, N, 64) in its input's type, given the output's gradient."""
    if q.device.type == "cpu":
        return masked_attention_backward_plain(q, k, v, key_mask, grad_out)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention_backward: unsupported device {q.device}")
    _check("masked_attention_backward", q, k, v, key_mask)
    if grad_out.shape != q.shape or grad_out.dtype != q.dtype:
        raise ValueError(
            f"masked_attention_backward: grad_out {grad_out.shape} {grad_out.dtype}"
        )
    b, h, n, _ = q.shape
    qc, kc, vc, gc = (t.contiguous() for t in (q, k, v, grad_out))
    mc = key_mask.contiguous()
    dq, dk, dv = torch.empty_like(qc), torch.empty_like(kc), torch.empty_like(vc)
    # Row maximum, 1 / row sum and delta of every query row, f32.
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)
    err = _build.library().ssl_masked_attention_bwd(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), mc.data_ptr(), gc.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        b, h, n, int(q.dtype == torch.bfloat16), _build.stream_of(q),
    )
    _build.check(err, "masked_attention_backward")
    _build.count("masked_attention_bwd")
    return dq, dk, dv


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        ctx.save_for_backward(q, k, v, key_mask)
        return _forward(q, k, v, key_mask)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        q, k, v, key_mask = ctx.saved_tensors
        dq, dk, dv = masked_attention_backward(q, k, v, key_mask, grad_out)
        return dq, dk, dv, None


def masked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """(B, H, N, 64) q, k, v in bf16 or f32 + (B, N) bool key mask ->
    (B, H, N, 64) in v's type; differentiable in q, k and v."""
    return _MaskedAttention.apply(q, k, v, key_mask)
