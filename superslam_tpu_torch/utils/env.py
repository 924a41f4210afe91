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


def device_tracker_wanted() -> bool:
    """Whether the per-frame pose solve runs inside the fused device
    program. The JAX package defaults it on for TPU backends; the port has
    no device tracker yet (ROADMAP queue 1), so it is off unless
    SUPERSLAM_DEVICE_TRACKER is set, and the facade refuses a truthy
    setting."""
    return env_flag("SUPERSLAM_DEVICE_TRACKER", False)
