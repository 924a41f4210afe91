"""f32 matmul precision control for the fused step.

Mirrors ``superslam_tpu/ops/precision.py::highest_f32_matmuls``. On the
card a float32 matrix product runs in full f32 by default, but a float32
convolution goes through cuDNN in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is off. ``highest_f32_matmuls`` turns
TF32 off for both for the duration of a step and restores the flags after;
explicitly-bf16 network layers are unaffected.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_f32_matmuls():
    """Context manager (and, through contextlib, decorator) running its body
    with TF32 off for matmuls and cuDNN convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
