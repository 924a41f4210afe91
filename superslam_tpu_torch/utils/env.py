"""Env-var tunables, mirroring the reference's use-site env reads
(``env_double`` in ``src/VoEstimator.cc:15-18``).

Precedence contract (reference README.md:203-205): env var > YAML > default.
The facade bridges YAML keys to env vars without overwriting pre-existing
ones (see superslam_tpu.config).
"""

from __future__ import annotations

import os


def env_float(key: str, fallback: float) -> float:
    v = os.environ.get(key)
    if v is None:
        return fallback
    try:
        return float(v)
    except ValueError:
        return fallback


def env_int(key: str, fallback: int) -> int:
    v = os.environ.get(key)
    if v is None:
        return fallback
    try:
        return int(float(v))
    except ValueError:
        return fallback


def env_flag(key: str, default: bool = False) -> bool:
    v = os.environ.get(key)
    if v is None:
        return default
    return v not in ("", "0", "false", "False")


def device_tracker_wanted(device) -> bool:
    """Whether the per-frame pose solve runs inside the fused device step
    (ops.frontend_step.track_kf_scan / track_scan), for a facade on
    ``device`` (a torch.device or its name; the port's rule takes it as an
    argument where the JAX package asks its default backend).
    SUPERSLAM_DEVICE_TRACKER=0/1 overrides. Otherwise it is on for a CUDA
    device, as the JAX package's default is on for its TPU backend, and off
    on the CPU, as the JAX default is off on its CPU."""
    v = os.environ.get("SUPERSLAM_DEVICE_TRACKER")
    if v is not None:
        return v not in ("", "0", "false", "False")
    return str(device).split(":")[0] == "cuda"
