"""Multi-sequence batched SLAM tracking (BASELINE config 5).

Port of ``superslam_tpu/parallel/multi_tracker.py``. S independent camera
streams go through ONE fused device step a frame: SuperPoint over all 2S
images, 2S LightGlue pair problems (S stereo + S per-sequence keyframe
track matches), one packed readback; then S host estimators consume their
slices. Each sequence keeps its own ``VoEstimator`` (window, pose graph,
anchors) and its own device-resident keyframe features, stacked (S, K, .)
and updated in place by index assignment on the device.

With a mesh, the sequences are split over its ``data`` axis (S must be a
multiple of it) and each distinct device of that axis runs one step for
its share, every step dispatched before any is read back. On one card, or
on a mesh whose devices repeat one device, that is the one step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vo_estimator import VoEstimator
from ..frontend.extractor import pad_to_multiple
from ..frontend.features import PaddedFeatures
from ..frontend.fused import UploadRing, decode_packed, fill_padded
from ..geometry.se3 import Pose3
from ..geometry.stereo_camera import StereoCalib
from ..models.lightglue import prepare_params
from ..models.superpoint import prepare_superpoint_params
from ..ops.frontend_step import fused_stereo_step_multi
from ..utils.device import resolve_device


class _Group:
    """The sequences one device steps, with that device's copies of the
    models, their keyframe state and their upload ring."""

    def __init__(self, device, seqs, sp_params, lg_params, K, shape):
        self.device, self.seqs = device, seqs
        self.sp = prepare_superpoint_params(sp_params, device)
        self.lg = prepare_params(lg_params, device)
        n = len(seqs)
        self.kf_kpts = torch.zeros((n, K, 2), dtype=torch.float32, device=device)
        self.kf_desc = torch.zeros((n, K, 256), dtype=torch.float32, device=device)
        self.kf_valid = torch.zeros((n, K), dtype=torch.bool, device=device)
        self.ring = UploadRing((2 * n, *shape), device)


class MultiSequenceTracker:
    def __init__(
        self,
        sp_params,
        lg_params,
        calib: StereoCalib,
        num_sequences: int,
        width: int,
        height: int,
        max_keypoints: int = 512,
        keypoint_threshold: float = 0.005,
        remove_borders: int = 4,
        nms_radius: int = 4,
        min_disparity: float = 1.0,
        match_threshold: float = 0.1,
        window_size: int = 8,
        matcher=None,
        mesh=None,
        device="cuda",
    ):
        self.calib = calib
        self.S = int(num_sequences)
        self.width, self.height = int(width), int(height)
        self.pad_w, self.pad_h = pad_to_multiple(width), pad_to_multiple(height)
        self.K = int(max_keypoints)
        self.step_kw = dict(
            max_keypoints=self.K,
            keypoint_threshold=float(keypoint_threshold),
            remove_borders=int(remove_borders),
            nms_radius=int(nms_radius),
            true_width=self.width,
            true_height=self.height,
            min_disparity=float(min_disparity),
            match_threshold=float(match_threshold),
        )
        if mesh is None:
            shards = [resolve_device(device)]
        else:
            n_data = mesh.devices.shape[0]
            if self.S % n_data:
                raise ValueError(
                    f"num_sequences ({self.S}) must be a multiple of the "
                    f"mesh data axis ({n_data}) for sharded batching"
                )
            shards = [resolve_device(d) for d in mesh.devices[:, 0]]
        # Consecutive shards on one device share its step.
        per = self.S // len(shards)
        owners: list[tuple[torch.device, list[int]]] = []
        for i, dev in enumerate(shards):
            seqs = list(range(i * per, (i + 1) * per))
            if owners and owners[-1][0] == dev:
                owners[-1][1].extend(seqs)
            else:
                owners.append((dev, seqs))
        self.groups = [
            _Group(dev, seqs, sp_params, lg_params, self.K, (self.pad_h, self.pad_w))
            for dev, seqs in owners
        ]
        self.estimators = [
            VoEstimator(matcher, calib, window_size, device=self._group_of(s).device)
            for s in range(self.S)
        ]

    def _group_of(self, s: int) -> _Group:
        return next(g for g in self.groups if s in g.seqs)

    def _prepare(self, lefts, rights, seqs, out=None) -> np.ndarray:
        if out is None:
            out = np.empty((2 * len(seqs), self.pad_h, self.pad_w), np.uint8)
        return fill_padded(out, [img for s in seqs for img in (lefts[s], rights[s])])

    def step(
        self,
        lefts: list[np.ndarray],
        rights: list[np.ndarray],
        timestamps: list[float],
    ) -> list[Pose3]:
        """Track one frame of every sequence; returns S poses."""
        outs = []
        for g in self.groups:
            # ONE upload of the group's (2S, H, W) uint8 batch through a
            # pinned slot.
            images = g.ring.upload(
                lambda out=None, g=g: self._prepare(lefts, rights, g.seqs, out=out))
            outs.append(fused_stereo_step_multi(
                g.sp, g.lg, images, g.kf_kpts, g.kf_desc, g.kf_valid, **self.step_kw))

        poses: list[Pose3] = [None] * self.S
        for g, (packed, desc, kpts, valid) in zip(self.groups, outs):
            # The step emits rank-2 (S * PACK_ROWS, K): ONE readback, split
            # per sequence.
            p_all = packed.cpu().numpy().reshape(len(g.seqs), -1, packed.shape[-1])
            for j, s in enumerate(g.seqs):
                feats = PaddedFeatures(
                    kpts=kpts[j],
                    desc=desc[j],
                    n=0,  # filled by decode_packed
                    width=self.width,
                    height=self.height,
                    valid=valid[j],
                )
                frame, m = decode_packed(p_all[j], timestamps[s], feats)
                est = self.estimators[s]
                poses[s] = est.track(frame, kf_matches=m)
                if est._last_keyframe is frame:
                    # The new keyframe's features, written on the device.
                    g.kf_kpts[j] = kpts[j]
                    g.kf_desc[j] = desc[j]
                    g.kf_valid[j] = valid[j]
        return poses

    def trajectories(self) -> list[list[Pose3]]:
        return [e.corrected_trajectory() for e in self.estimators]
