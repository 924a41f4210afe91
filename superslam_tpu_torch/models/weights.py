"""Checkpoint loading: safetensors or torch .pth -> flat dicts of torch tensors.

The committed ``weights/*.safetensors`` are torch state dicts: OIHW conv
kernels and (out, in) linear weights, stored in fp16 (written by
``superslam_tpu/models/weights.py::save_params_torch_layout``). The port
keeps that layout, so loading is a dtype cast and a device move. The JAX
package holds the same parameters (SuperPoint, LightGlue, EigenPlaces) as
HWIO convs and (in, out) linears; ``from_jax_params`` carries its dicts
over (the inverse of its ``convert_torch_layout``; EigenPlaces' 0-d GeM
exponent passes as it is) and ``to_jax_params`` carries the port's back;
``save_params`` writes the committed format, so a checkpoint trained by
either package loads in the other.

The fused LightGlue blocks and SuperPoint's conv pairs need nothing more
from a checkpoint: their kernel operands derive from this same flat dict
(``ops/cuda/lightglue_layer.py::augment_fused_layer_params`` and
``models/superpoint.py::prepare_superpoint_params``, called once by the
matcher, the extractor and the pipeline).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..utils.logging import get_logger

Params = dict[str, torch.Tensor]


def to_torch_layout(arr: np.ndarray) -> np.ndarray:
    """JAX-package layout -> torch layout: HWIO -> OIHW, (in,out) -> (out,in)."""
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if arr.ndim == 2:
        return np.transpose(arr, (1, 0))
    return arr


def from_jax_params(
    params: dict[str, np.ndarray], device="cpu", dtype=torch.float32
) -> Params:
    """A JAX-package parameter dict (HWIO / (in, out) arrays) -> the port's
    torch-layout dict."""
    return {
        name: torch.from_numpy(
            np.array(to_torch_layout(np.asarray(arr, np.float32)), order="C")
        ).to(device=device, dtype=dtype)
        for name, arr in params.items()
    }


def to_jax_params(params: Params) -> dict[str, np.ndarray]:
    """The port's torch-layout dict -> a JAX-package parameter dict of f32
    numpy arrays (OIHW -> HWIO, (out, in) -> (in, out)): the inverse of
    ``from_jax_params``. The prepared operands of the fused LightGlue blocks
    (``__fused`` keys) and of SuperPoint's conv pairs (``__kernel`` keys) are
    derived, not parameters, and are left out."""
    out: dict[str, np.ndarray] = {}
    for name, t in params.items():
        if not isinstance(t, torch.Tensor):
            continue
        arr = t.detach().to("cpu", torch.float32).numpy()
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))
        elif arr.ndim == 2:
            arr = np.transpose(arr, (1, 0))
        out[name] = np.ascontiguousarray(arr)
    return out


def save_params(params: Params, path: str, dtype: torch.dtype = torch.float16) -> None:
    """Write the port's dict as a torch-layout safetensors checkpoint (no
    transposes; fp16 by default, as the committed checkpoints and the JAX
    package's ``save_params_torch_layout``). Derived kernel operands (lists
    and tuples of tensors) are left out."""
    from safetensors.torch import save_file

    save_file(
        {
            name: t.detach().to("cpu", dtype).contiguous()
            for name, t in params.items()
            if isinstance(t, torch.Tensor)
        },
        path,
    )


def load_safetensors(path: str, device="cpu", dtype=torch.float32) -> Params:
    """Load a torch-layout safetensors checkpoint (no transposes)."""
    from safetensors.torch import load_file

    return {
        name: t.to(device=device, dtype=dtype)
        for name, t in load_file(path, device="cpu").items()
        if not name.endswith("num_batches_tracked")
    }


def load_torch_pth(path: str, device="cpu", dtype=torch.float32) -> Params:
    """Load a torch ``.pth`` state dict (the layout the port keeps: no
    transposes). A checkpoint that wraps its state dict under ``"model"`` or
    ``"state_dict"`` is unwrapped; ``num_batches_tracked`` counters are
    dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict):
        state = state.get("model", state.get("state_dict", state))
    return {
        name: t.detach().to(device=device, dtype=dtype)
        for name, t in state.items()
        if not name.endswith("num_batches_tracked")
    }


def load_params(
    path: str | None,
    fallback: Callable[[], Params],
    device="cpu",
    dtype=torch.float32,
) -> Params:
    """Load a ``.safetensors`` or ``.pth`` checkpoint from ``path``; fall
    back to a random init when it is missing, so the framework stays
    runnable weight-free. Any other extension raises."""
    if path and os.path.exists(path):
        if path.endswith(".safetensors"):
            return load_safetensors(path, device, dtype)
        if path.endswith(".pth"):
            return load_torch_pth(path, device, dtype)
        raise ValueError(f"not a .safetensors or .pth checkpoint: {path}")
    if path:
        get_logger().warning("weights not found at %s; using random initialization", path)
    return {k: v.to(device=device, dtype=dtype) for k, v in fallback().items()}
