"""f32 matmul precision control for the fused step.

Mirrors ``superslam_tpu/ops/precision.py::highest_f32_matmuls``. On the
card a float32 matrix product runs in full f32 by default, but a float32
convolution goes through cuDNN in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is off. ``highest_f32_matmuls`` turns
TF32 off for both for the duration of a step and restores the flags after;
explicitly-bf16 network layers are unaffected.

The flags are process-wide and the loop-closure worker runs the matcher on
a second thread, so the bodies are counted under a lock: the first to
enter saves and clears the flags, the last to leave restores them.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.Lock()
_state = {"depth": 0, "saved": None}


@contextlib.contextmanager
def highest_f32_matmuls():
    """Context manager (and, through contextlib, decorator) running its body
    with TF32 off for matmuls and cuDNN convolutions."""
    with _LOCK:
        if _state["depth"] == 0:
            _state["saved"] = (
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            )
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _state["depth"] += 1
    try:
        yield
    finally:
        with _LOCK:
            _state["depth"] -= 1
            if _state["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _state["saved"]
