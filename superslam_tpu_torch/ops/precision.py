"""f32 matmul precision control for the fused step.

Mirrors ``superslam_tpu/ops/precision.py::highest_f32_matmuls``. On the
card a float32 matrix product runs in full f32 by default, but a float32
convolution goes through cuDNN in TF32 (about three decimal digits) unless
``torch.backends.cudnn.allow_tf32`` is off. ``highest_f32_matmuls`` turns
TF32 off for both for the duration of a step and restores the flags after;
explicitly-bf16 network layers are unaffected.

``SUPERSLAM_F32_PRECISION`` overrides the mode. It is read once, at
import, into ``F32_PRECISION_MODE`` (as the JAX module reads it,
``superslam_tpu/ops/precision.py:39-44``), so an A/B is two processes,
never one:

- ``highest`` (the default) or ``float32``: TF32 off for matmuls and cuDNN;
- ``0``, the empty string or ``default``: the A/B kill-switch of the
  solver-precision fix. The body runs under the flags as they are: nothing
  is saved, cleared or restored.

The JAX package's other values (``high``, ``tensorfloat32``, ``bfloat16``)
have no caller in the port and raise ``ValueError`` at import, as any other
value does.

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

F32_PRECISION_MODE = os.environ.get("SUPERSLAM_F32_PRECISION", "highest")
if F32_PRECISION_MODE not in _OFF + _HIGHEST:
    raise ValueError(
        f"SUPERSLAM_F32_PRECISION={F32_PRECISION_MODE!r}: want highest, float32, 0, '' or "
        "default (the JAX package's high, tensorfloat32 and bfloat16 have no caller here)"
    )

_LOCK = threading.Lock()
_state = {"depth": 0, "saved": None}


@contextlib.contextmanager
def highest_f32_matmuls():
    """Context manager (and, through contextlib, decorator) running its body
    with TF32 off for matmuls and cuDNN convolutions; with the flags as
    they are when ``F32_PRECISION_MODE`` is the kill-switch."""
    if F32_PRECISION_MODE in _OFF:
        yield
        return
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
