"""f32 matmul precision control for the fused step.

Mirrors ``superslam_tpu/ops/precision.py::highest_f32_matmuls``. On the
card a float32 matrix product runs in full f32 by default, but a float32
convolution goes through cuDNN in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is off. ``highest_f32_matmuls`` sets
TF32 for both as the mode says (off by default) for the duration of a
step and restores the flags after; explicitly-bf16 network layers are
unaffected.

``SUPERSLAM_F32_PRECISION`` overrides the mode. It is read once, at
import, into ``F32_PRECISION_MODE`` (as the JAX module reads it,
``superslam_tpu/ops/precision.py:39-44``), so an A/B is two processes,
never one:

- ``highest`` (the default) or ``float32``: TF32 off for matmuls and cuDNN;
- ``high`` or ``tensorfloat32``: TF32 on for both (what JAX runs these
  two as on a GPU);
- ``bfloat16``: the same TF32 flags. JAX's ``bfloat16`` is one bf16 pass
  over f32 operands, and PyTorch's cuBLAS flags have no such mode: the
  per-op ``torch.backends.cuda.matmul.fp32_precision = "bf16"`` is refused
  ("backend 'cuda' does not support precision 'bf16'"), and the
  process-wide ``torch.set_float32_matmul_precision("medium")`` also turns
  the CPU's oneDNN f32 products to bf16 (a 256 x 256 product moves by up
  to 0.18), where the JAX package's precision changes nothing on the CPU
  (``superslam_tpu/ops/precision.py:29``). So the module never calls
  ``set_float32_matmul_precision``; TF32 is the reduced f32 precision the
  flags offer;
- ``0``, the empty string or ``default``: the A/B kill-switch of the
  solver-precision fix. The body runs under the flags as they are: nothing
  is saved, set or restored.

Any other value raises ``ValueError`` at import, naming it. The legacy
TF32 flags touch only CUDA products and cuDNN convolutions, so on the CPU
every accepted value computes the same bits.

The flags are process-wide and the loop-closure worker runs the matcher on
a second thread, so the bodies are counted under a lock: the first to
enter saves and clears the flags, the last to leave restores them.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

_OFF = ("0", "", "default")
_HIGHEST = ("highest", "float32")
_TF32 = ("high", "tensorfloat32", "bfloat16")

F32_PRECISION_MODE = os.environ.get("SUPERSLAM_F32_PRECISION", "highest")
if F32_PRECISION_MODE not in _OFF + _HIGHEST + _TF32:
    raise ValueError(
        f"SUPERSLAM_F32_PRECISION={F32_PRECISION_MODE!r}: want highest, float32, high, "
        "tensorfloat32, bfloat16, 0, '' or default"
    )

_LOCK = threading.Lock()
_state = {"depth": 0, "saved": None}


@contextlib.contextmanager
def highest_f32_matmuls():
    """Context manager (and, through contextlib, decorator) running its body
    with TF32 off for matmuls and cuDNN convolutions (on under the TF32
    modes); with the flags as they are when ``F32_PRECISION_MODE`` is the
    kill-switch."""
    if F32_PRECISION_MODE in _OFF:
        yield
        return
    with _LOCK:
        if _state["depth"] == 0:
            _state["saved"] = (
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            )
            tf32 = F32_PRECISION_MODE in _TF32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
        _state["depth"] += 1
    try:
        yield
    finally:
        with _LOCK:
            _state["depth"] -= 1
            if _state["depth"] == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _state["saved"]
