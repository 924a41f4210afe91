"""Tier-2 global pose graph with loop-edge rollback.

Equivalent of the reference GlobalPoseGraph
(``src/GlobalPoseGraph.cc:23-98``): X(keyframe_id) Pose3
nodes, a strong prior (sigma 1e-4) on the first node, BetweenFactor odometry
backbone, loop edges kept in a separate list; batch LM, and on a diverged or
indeterminate solve the newest loop edge is popped and the solve retried
until sane (``last_loop_rejected`` flags the rollback). Seeds warm-start from
the previous estimate.

The between-factor residual is ``Log(rel^-1 * (Ti^-1 * Tj))`` with
right-retraction Jacobians; the sparse system is assembled per-edge and
solved dense (pose graphs here are a few hundred nodes).
"""

from __future__ import annotations

import numpy as np

from ..geometry.se3 import Pose3
from ..utils.logging import get_logger


def _between_residual(
    Ti: Pose3, Tj: Pose3, rel: Pose3
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Residual r = Log(rel^-1 * Ti^-1 * Tj) and 6x6 Jacobians wrt xi_i, xi_j.

    With right retraction T <- T Exp(xi) and first-order BCH:
      d r/d xi_j ~= I  (evaluated near convergence; exactness not required
                        for LM convergence, only for the descent direction)
      d r/d xi_i ~= -Ad(Tj^-1 Ti)
    """
    E = rel.inverse() * (Ti.inverse() * Tj)
    r = E.logmap()
    Jj = np.eye(6)
    Ji = -(Tj.inverse() * Ti).adjoint()
    return r, Ji, Jj


def _sane_pose(p: Pose3) -> bool:
    return p.is_finite() and p.translation_norm() <= 1e6


class GlobalPoseGraph:
    def __init__(self) -> None:
        self._nodes: list[int] = []
        self._node_set: set[int] = set()
        self._seeds: dict[int, Pose3] = {}
        self._estimate: dict[int, Pose3] = {}
        # backbone: (i, j, rel, inv_sigmas (6,)) odometry edges + first prior
        self._odom: list[tuple[int, int, Pose3, np.ndarray]] = []
        self._loops: list[tuple[int, int, Pose3, np.ndarray, float]] = []
        self._prior: tuple[int, Pose3, float] | None = None
        self._last_loop_rejected = False

    # -- graph construction -------------------------------------------------
    def add_keyframe(self, keyframe_id: int, initial: Pose3, is_first: bool) -> None:
        if keyframe_id in self._node_set:
            return
        init = initial if initial.is_finite() else Pose3()
        self._seeds[keyframe_id] = init
        self._nodes.append(keyframe_id)
        self._node_set.add(keyframe_id)
        if is_first:
            self._prior = (keyframe_id, init, 1e-4)

    def add_odometry(
        self, from_id: int, to_id: int, rel: Pose3, sigmas: np.ndarray
    ) -> None:
        r = rel if rel.is_finite() else Pose3()
        self._odom.append((from_id, to_id, r, 1.0 / np.asarray(sigmas, float)))

    def add_loop(
        self,
        from_id: int,
        to_id: int,
        rel: Pose3,
        sigmas: np.ndarray,
        huber_k: float = float(np.sqrt(7.815)),
    ) -> None:
        if not rel.is_finite():
            return
        self._loops.append(
            (from_id, to_id, rel, 1.0 / np.asarray(sigmas, float), huber_k)
        )

    def size(self) -> int:
        return len(self._nodes)

    def has(self, keyframe_id: int) -> bool:
        return keyframe_id in self._node_set

    def last_loop_rejected(self) -> bool:
        return self._last_loop_rejected

    # -- solve ---------------------------------------------------------------
    def optimize_and_get_all(self) -> dict[int, Pose3]:
        """Batch LM; on divergence pop the newest loop edge and retry
        (loop-edge rollback, GlobalPoseGraph.cc:68-98)."""
        self._last_loop_rejected = False
        while True:
            result = self._solve()
            if result is not None and all(_sane_pose(p) for p in result.values()):
                self._estimate = result
                self._seeds.update(result)
                break
            if not self._loops:
                get_logger().error(
                    "GlobalPoseGraph: pose graph unsolvable; keeping last estimate"
                )
                break
            self._loops.pop()
            self._last_loop_rejected = True
        return {k: self.pose_of(k) for k in self._nodes}

    def pose_of(self, keyframe_id: int) -> Pose3:
        if keyframe_id in self._estimate:
            return self._estimate[keyframe_id]
        return self._seeds[keyframe_id]

    # -- internals ------------------------------------------------------------
    def _solve(self) -> dict[int, Pose3] | None:
        """Native C++ LM when the core is built (SUPERSLAM_NATIVE=0 forces
        the numpy oracle); both run the same factors/Huber/damping. The
        Python loop costs E edges x up to 100 iters on the loop worker —
        real minutes of the single host core at a few hundred keyframes."""
        import os

        if os.environ.get("SUPERSLAM_NATIVE", "1") != "0":
            from .. import native

            if native.available():
                return self._solve_native()
        return self._solve_numpy()

    def _solve_native(self) -> dict[int, Pose3] | None:
        from .. import native

        ids = self._nodes
        if not ids:
            return {}
        idx = {k: i for i, k in enumerate(ids)}
        seeds = [self._seeds[k] for k in ids]
        edges = [
            (idx[i], idx[j], rel, w, 0.0) for i, j, rel, w in self._odom
        ] + [(idx[i], idx[j], rel, w, hk) for i, j, rel, w, hk in self._loops]
        prior_idx, prior_sigma = 0, 1e-4
        if self._prior is not None:
            pid, pp, psig = self._prior
            prior_idx, prior_sigma = idx[pid], psig
            seeds[prior_idx] = seeds[prior_idx] if seeds[prior_idx].is_finite() else pp
        result = native.pose_graph_lm(seeds, edges, prior_idx, prior_sigma)
        if result is None:
            return None
        return {k: result[i] for k, i in idx.items()}

    def _solve_numpy(self) -> dict[int, Pose3] | None:
        ids = self._nodes
        K = len(ids)
        if K == 0:
            return {}
        idx = {k: i for i, k in enumerate(ids)}
        poses = [self._seeds[k] for k in ids]

        edges = [(i, j, rel, w, 0.0) for i, j, rel, w in self._odom] + self._loops

        def total_error(ps: list[Pose3]) -> float:
            e = 0.0
            for i, j, rel, w, hk in edges:
                r, _, _ = _between_residual(ps[idx[i]], ps[idx[j]], rel)
                rw = r * w
                n = float(np.linalg.norm(rw))
                if hk > 0 and n > hk:
                    e += hk * n - 0.5 * hk * hk
                else:
                    e += 0.5 * n * n
            if self._prior is not None:
                pid, pp, psig = self._prior
                dxi = pp.local(ps[idx[pid]]) / psig
                e += 0.5 * float(dxi @ dxi)
            return e

        err = total_error(poses)
        if not np.isfinite(err):
            return None
        lam, lam_factor = 1e-5, 10.0
        max_iters = 100

        for _ in range(max_iters):
            H = np.zeros((6 * K, 6 * K))
            b = np.zeros(6 * K)
            for i, j, rel, w, hk in edges:
                ii, jj = idx[i], idx[j]
                r, Ji, Jj = _between_residual(poses[ii], poses[jj], rel)
                rw = r * w
                Jiw = Ji * w[:, None]
                Jjw = Jj * w[:, None]
                if hk > 0:
                    n = float(np.linalg.norm(rw))
                    if n > hk:
                        # IRLS weight w = hk/|r| applied once to the normal
                        # equations; rw/J each get sqrt(w) so JᵀJ and Jᵀr
                        # carry w (not w², which over-deweights loop edges).
                        s = np.sqrt(hk / n)
                        rw, Jiw, Jjw = rw * s, Jiw * s, Jjw * s
                si, sj = slice(6 * ii, 6 * ii + 6), slice(6 * jj, 6 * jj + 6)
                H[si, si] += Jiw.T @ Jiw
                H[sj, sj] += Jjw.T @ Jjw
                H[si, sj] += Jiw.T @ Jjw
                H[sj, si] += Jjw.T @ Jiw
                b[si] += Jiw.T @ rw
                b[sj] += Jjw.T @ rw
            if self._prior is not None:
                pid, pp, psig = self._prior
                pi = idx[pid]
                sp = slice(6 * pi, 6 * pi + 6)
                info = 1.0 / (psig * psig)
                H[sp, sp] += info * np.eye(6)
                b[sp] += info * pp.local(poses[pi])

            stepped = False
            for _try in range(10):
                try:
                    delta = np.linalg.solve(H + lam * np.eye(6 * K), -b)
                except np.linalg.LinAlgError:
                    lam *= lam_factor
                    if lam > 1e10:
                        return None
                    continue
                if not np.isfinite(delta).all():
                    return None
                cand = [
                    p.retract(delta[6 * i : 6 * i + 6]) for i, p in enumerate(poses)
                ]
                cand_err = total_error(cand)
                if cand_err < err:
                    improvement = err - cand_err
                    poses, err = cand, cand_err
                    lam = max(lam / lam_factor, 1e-10)
                    stepped = True
                    if improvement < 1e-5 * max(err, 1.0) or improvement < 1e-6:
                        return {k: poses[idx[k]] for k in ids}
                    break
                lam *= lam_factor
                if lam > 1e10:
                    break
            if not stepped:
                break
        return {k: poses[idx[k]] for k in ids}
