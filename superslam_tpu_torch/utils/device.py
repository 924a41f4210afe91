"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: with no GPU
and no explicit ``device="cpu"`` they raise instead of silently falling
back (a CPU run is a different, much slower program).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "superslam_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
