"""Trajectory accuracy metrics: ATE, RPE, and the official KITTI segment
metric.

Equivalent of the reference's evo-based evaluation
(``scripts/benchmarks/_eval_common.py:38-111``):
- ATE: SE(3) Umeyama alignment (no scale) then RMSE/mean/max of the
  translational residuals.
- RPE: relative pose error at a fixed travelled-distance delta (1 m
  default), translational RMSE.
- KITTI segments: average translational (%) and rotational (deg/m) error
  over subsequences of 100..800 m, the devkit definition.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..geometry.se3 import Pose3, so3_logmap


@dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    max: float


@dataclass
class RpeResult:
    rmse: float
    mean: float
    max: float


def umeyama_alignment(
    est: np.ndarray, ref: np.ndarray, with_scale: bool = False
) -> tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid alignment est -> ref. Points are (N, 3) rows.
    Returns (R, t, s) with ref ~= s * R @ est + t."""
    mu_e = est.mean(axis=0)
    mu_r = ref.mean(axis=0)
    de = est - mu_e
    dr = ref - mu_r
    cov = dr.T @ de / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (de**2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_r - s * R @ mu_e
    return R, t, s


def ate(
    est: list[Pose3], ref: list[Pose3], align: bool = True, with_scale: bool = False
) -> AteResult:
    """Absolute trajectory error after (optional) SE(3) Umeyama alignment."""
    n = min(len(est), len(ref))
    pe = np.stack([p.t for p in est[:n]])
    pr = np.stack([p.t for p in ref[:n]])
    if align and n >= 3:
        R, t, s = umeyama_alignment(pe, pr, with_scale)
        pe = (s * (pe @ R.T)) + t
    err = np.linalg.norm(pe - pr, axis=1)
    return AteResult(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
    )


def _distances(ref: list[Pose3]) -> np.ndarray:
    pts = np.stack([p.t for p in ref])
    step = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(step)])


def rpe(
    est: list[Pose3], ref: list[Pose3], delta_m: float = 1.0
) -> RpeResult:
    """Relative pose error at a travelled-distance delta (translational)."""
    n = min(len(est), len(ref))
    dist = _distances(ref[:n])
    errs = []
    j = 0
    for i in range(n):
        target = dist[i] + delta_m
        while j < n and dist[j] < target:
            j += 1
        if j >= n:
            break
        rel_ref = ref[i].between(ref[j])
        rel_est = est[i].between(est[j])
        e = rel_ref.inverse() * rel_est
        errs.append(np.linalg.norm(e.t))
    if not errs:
        return RpeResult(np.nan, np.nan, np.nan)
    errs = np.array(errs)
    return RpeResult(
        rmse=float(np.sqrt(np.mean(errs**2))),
        mean=float(errs.mean()),
        max=float(errs.max()),
    )


def kitti_segment_errors(
    est: list[Pose3],
    ref: list[Pose3],
    lengths: tuple[float, ...] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> tuple[float, float]:
    """Official KITTI devkit metric: mean translational error (%) and
    rotational error (deg/m) over all subsequences of the given lengths.
    Returns (t_rel_percent, r_rel_deg_per_m); NaNs when the trajectory is
    shorter than the smallest segment."""
    n = min(len(est), len(ref))
    dist = _distances(ref[:n])
    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            rel_ref = ref[first].between(ref[last])
            rel_est = est[first].between(est[last])
            e = rel_ref.inverse() * rel_est
            t_errs.append(np.linalg.norm(e.t) / length)
            angle = np.linalg.norm(so3_logmap(e.R))
            r_errs.append(np.degrees(angle) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs) * 100.0), float(np.mean(r_errs))
