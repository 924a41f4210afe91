"""SuperPoint's conv pairs with the 2x2 max-pool folded in.

``conv_pair_pool`` computes maxpool2x2(relu(conv_b(relu(conv_a(x) + ba)) +
bb)) with two 3x3 SAME convs. It is the port of
``superslam_tpu/ops/pallas/conv.py::conv1a1b_chw`` (CIN = 1, the gray
image) and ``::conv_pair_chw`` (CIN = 64), both with ``pool_vert=True``
plus the XLA ``hpool_canvas`` that finishes their pool. The kernel is
``conv_pair_pool.cu``; its header says what bounds it on the H100 and how
the design answers that.

A CUDA tensor always goes through the kernel (or raises); a CPU tensor
goes through ``conv_pair_pool_plain``, the same function in plain PyTorch.
On CUDA the convs compute in bf16 with f32 accumulation: the conv_a map
is rounded to bf16 in shared memory, as the TPU kernel rounds it in VMEM.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

C = 64


def conv_pair_pool_plain(
    x: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """F.conv2d -> ReLU -> F.conv2d -> ReLU -> F.max_pool2d in compute_dtype
    (NCHW, OIHW weights). Each bias is added after the conv's rounding to
    compute_dtype, as the JAX package's XLA route does."""
    cdt = compute_dtype
    y = F.relu(F.conv2d(x.to(cdt), wa.to(cdt), padding=1) + ba.to(cdt)[:, None, None])
    y = F.relu(F.conv2d(y, wb.to(cdt), padding=1) + bb.to(cdt)[:, None, None])
    return F.max_pool2d(y, 2).to(out_dtype or cdt)


def conv_pair_pool(
    x: torch.Tensor,
    wa: torch.Tensor,
    ba: torch.Tensor,
    wb: torch.Tensor,
    bb: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """(B, CIN, H, W) -> (B, 64, H/2, W/2); CIN in {1, 64}, H and W even.

    Weights are OIHW (64, CIN, 3, 3) and (64, 64, 3, 3). On CUDA the output
    is a channels_last tensor (NHWC in memory) in ``out_dtype`` (bf16 or
    f32; default compute_dtype), ready for the next conv."""
    if x.device.type == "cpu":
        return conv_pair_pool_plain(x, wa, ba, wb, bb, out_dtype, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pair_pool: unsupported device {x.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("conv_pair_pool: the CUDA kernel computes in bf16")
    out_dtype = out_dtype or compute_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"conv_pair_pool: unsupported out_dtype {out_dtype}")
    b, cin, h, w = x.shape
    if cin not in (1, C) or h % 2 or w % 2:
        raise ValueError(f"conv_pair_pool: unsupported input shape {tuple(x.shape)}")
    if tuple(wa.shape) != (C, cin, 3, 3) or tuple(wb.shape) != (C, C, 3, 3):
        raise ValueError(
            f"conv_pair_pool: weights {tuple(wa.shape)}, {tuple(wb.shape)}"
        )
    if cin == 1:
        xk = x.float().contiguous()
        wak = wa.float().reshape(C, 9).contiguous()
    else:
        xk = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        wak = _tap_major(wa)
    wbk = _tap_major(wb)
    bak = ba.float().contiguous()
    bbk = bb.float().contiguous()
    out = torch.empty(
        (b, C, h // 2, w // 2),
        dtype=out_dtype,
        device=x.device,
        memory_format=torch.channels_last,
    )
    lib = _build.library()
    err = lib.ssl_conv_pair_pool(
        xk.data_ptr(), wak.data_ptr(), bak.data_ptr(), wbk.data_ptr(),
        bbk.data_ptr(), out.data_ptr(), b, cin, h, w,
        int(out_dtype == torch.float32), _build.stream_of(x),
    )
    _build.check(err, "conv_pair_pool")
    _build.count("conv1a1b" if cin == 1 else "conv_pair")
    return out


def _tap_major(w: torch.Tensor) -> torch.Tensor:
    """OIHW (co, ci, ky, kx) -> bf16 (ky*3+kx, ci, co), the kernel's GEMM B
    operand (K = tap x ci rows, N = co columns)."""
    co, ci = w.shape[0], w.shape[1]
    return w.permute(2, 3, 1, 0).reshape(9, ci, co).to(torch.bfloat16).contiguous()
