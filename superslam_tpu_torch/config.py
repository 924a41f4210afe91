"""YAML config + env-var bridging.

Equivalent of the reference's config plumbing (``src/
SuperSLAM.cc:19-60`` and the per-dataset YAMLs in ``examples/``): the
documented precedence is **env var > YAML > built-in default**
(reference README.md:203-205). The facade bridges YAML tuning keys to
``SUPERSLAM_*`` env vars with overwrite=0 so a pre-existing env var wins;
components read env at use-site.

The YAML schema is the reference's: flat ``Camera.*`` keys, ``superpoint:``
/ ``lightglue:`` / ``loop:`` blocks, ``Backend.*`` / ``Tracking.*`` /
``KeyFrame.*`` tuning keys, an optional ``DepthMapFactor`` (the RGB-D
switch), and EuRoC-only ``LEFT.*``/``RIGHT.*`` rectification matrices.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import yaml

from .geometry.stereo_camera import StereoCalib
from .utils.logging import get_logger

# YAML key -> env var, exactly the bridge list in SuperSLAM.cc:27-38.
_TUNING_BRIDGE = [
    ("Backend.max_iters", "SUPERSLAM_WS_MAX_ITERS"),
    ("Backend.smart_sigma_px", "SUPERSLAM_SMART_SIGMA_PX"),
    ("Backend.odom_rot_sigma", "SUPERSLAM_ODOM_ROT_SIGMA"),
    ("Backend.odom_trans_sigma", "SUPERSLAM_ODOM_TRANS_SIGMA"),
    ("Tracking.min_matches", "SUPERSLAM_TRACK_MIN_MATCHES"),
    ("Tracking.disp_sigma_px", "SUPERSLAM_DISP_SIGMA_PX"),
    ("Tracking.cond_depth_m", "SUPERSLAM_STEREO_COND_DEPTH_M"),
]


class Config:
    """Loaded YAML with reference-style access helpers."""

    def __init__(self, data: dict[str, Any]):
        self.data = data or {}

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(yaml.safe_load(f))

    def get(self, key: str, default: Any = None) -> Any:
        """Flat key lookup ('Camera.fx') with nested-block fallback
        ('superpoint.max_keypoints' -> data['superpoint']['max_keypoints'])."""
        if key in self.data:
            return self.data[key]
        node: Any = self.data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def has(self, key: str) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def matrix(self, key: str) -> np.ndarray | None:
        """An OpenCV-style matrix node: {rows, cols, data} or a plain list."""
        node = self.get(key)
        if node is None:
            return None
        if isinstance(node, dict) and "data" in node:
            rows = int(node.get("rows", 0)) or None
            arr = np.asarray(node["data"], np.float64)
            if rows:
                return arr.reshape(rows, -1)
            return arr
        return np.asarray(node, np.float64)


_MISSING = object()


def apply_tuning_overrides(cfg: Config) -> None:
    """Bridge YAML tuning knobs to env vars (overwrite=0: env wins)."""
    log = get_logger()

    def bridge(key: str, env: str) -> None:
        val = cfg.get(key)
        if val is not None and os.environ.get(env) is None:
            os.environ[env] = str(val)
            log.info("Config: %s = %s (from YAML)", env, val)

    for key, env in _TUNING_BRIDGE:
        bridge(key, env)
    if cfg.get("loop") is not None:
        bridge("loop.min_inliers", "SUPERSLAM_LOOP_MIN_INLIERS")
        bridge("loop.min_score", "SUPERSLAM_LOOP_MIN_SCORE")


def read_calib(cfg: Config) -> StereoCalib:
    """Camera.fx/fy/cx/cy + Camera.bf; baseline = bf/fx (SuperSLAM.cc:40-46)."""
    fx = float(cfg.get("Camera.fx"))
    fy = float(cfg.get("Camera.fy"))
    cx = float(cfg.get("Camera.cx"))
    cy = float(cfg.get("Camera.cy"))
    bf = float(cfg.get("Camera.bf"))
    return StereoCalib(fx=fx, fy=fy, cx=cx, cy=cy, baseline=bf / fx)


def read_dist_coeffs(cfg: Config) -> np.ndarray:
    return np.array(
        [
            float(cfg.get("Camera.k1", 0.0)),
            float(cfg.get("Camera.k2", 0.0)),
            float(cfg.get("Camera.p1", 0.0)),
            float(cfg.get("Camera.p2", 0.0)),
            float(cfg.get("Camera.k3", 0.0)),
        ]
    )
