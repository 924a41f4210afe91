"""S stereo streams through the port's multi-sequence step, in a closed loop.

Each step is what ``parallel/multi_tracker.py::MultiSequenceTracker.step``
dispatches for its one group, without the host estimators: the streams'
frames prepared into a pinned slot and uploaded as one (2S, H, W) uint8
batch (``frontend/fused.py::UploadRing``), one
``ops/frontend_step.py::fused_stereo_step_multi`` against the per-stream
keyframe state (S, K, ...), one packed readback, then the promoted
streams' features written into the keyframe state on the device by index.
Stream s promotes after step t when (t + s) is a multiple of
``keyframe_every``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from slambench.compare import Unit
from slambench.render import pingpong
from slambench.sampling import Reservoir

VIEWS = 2
ROWS = 4  # packed rows a frame: x, y, disparity, track match


class Entry:
    def __init__(self, ctx):
        from superslam_tpu_torch.geometry.stereo_camera import StereoCalib
        from superslam_tpu_torch.parallel.multi_tracker import MultiSequenceTracker

        cfg, tr = ctx.config, ctx.traffic
        cam, sp = cfg["camera"], cfg["superpoint"]
        self.ctx = ctx
        self.S = tr["streams"]
        self.every = tr["keyframe_every"]
        calib = StereoCalib(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                            baseline=cam["bf"] / cam["fx"])
        self.trk = MultiSequenceTracker(
            ctx.sp_params, ctx.lg_params, calib, self.S, cam["width"], cam["height"],
            max_keypoints=sp["max_keypoints"], keypoint_threshold=sp["keypoint_threshold"],
            remove_borders=sp["remove_borders"], nms_radius=sp["nms_radius"],
            min_disparity=cfg["stereo"]["min_disparity"],
            match_threshold=cfg["lightglue"]["match_threshold"], device=ctx.device,
        )
        self.g = self.trk.groups[0]
        n = ctx.frames.shape[0]
        self.offsets = ctx.rng.integers(0, 2 * (n - 1), self.S)
        # The streams that promote after step t, by t % every, as device indices.
        self.promote = [
            torch.tensor([s for s in range(self.S) if (r + s) % self.every == 0],
                         dtype=torch.long, device=self.g.kf_kpts.device)
            for r in range(self.every)
        ]
        self.frames_per_step = self.S
        self.t = 0  # global step number, warm-up included
        self.blocks: dict[int, np.ndarray] = {}  # step -> its packed block on the host
        self.window: list[int] = []  # the steps completed inside the window
        self.sample = Reservoir(tr["check_steps"], ctx.seed)

    def _frame(self, t: int, s: int) -> int:
        return pingpong(int(self.offsets[s]) + t, self.ctx.frames.shape[0])

    def _step(self):
        from superslam_tpu_torch.ops.frontend_step import fused_stereo_step_multi

        t, g, span, fr = self.t, self.g, self.ctx.span, self.ctx.frames
        idx = [self._frame(t, s) for s in range(self.S)]
        lefts = [fr[i, 0] for i in idx]
        rights = [fr[i, 1] for i in idx]
        with span("prep_upload"):
            images = g.ring.upload(
                lambda out=None: self.trk._prepare(lefts, rights, g.seqs, out=out))
        with span("issue"):
            packed, desc, kpts, valid = fused_stereo_step_multi(
                g.sp, g.lg, images, g.kf_kpts, g.kf_desc, g.kf_valid, **self.trk.step_kw)
        with span("readback"):
            p = packed.cpu().numpy()
        with span("kf_write"):
            i = self.promote[t % self.every]
            g.kf_kpts[i] = kpts[i]
            g.kf_desc[i] = desc[i]
            g.kf_valid[i] = valid[i]
        self.t += 1
        return t, p, desc

    def warm(self, n: int):
        for _ in range(n):
            t, p, _desc = self._step()
            self.blocks[t] = p
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, t_end: int):
        """Steps until the window closes. Returns (dispatch ns, done ns) of
        the steps whose packed block reached the host inside it, and the
        frames dispatched inside it."""
        done, dispatched = [], 0
        while True:
            t_disp = time.time_ns()
            if t_disp >= t_end:
                return done, dispatched
            dispatched += self.S
            t, p, desc = self._step()
            t_done = time.time_ns()
            self.blocks[t] = p
            if t_done <= t_end:
                done.append((t_disp, t_done))
                self.window.append(t)
                self.sample.offer(lambda: (t, desc))

    def finish(self):
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def _kf_step(self, t: int, s: int) -> int | None:
        """The step whose features stream s matched against at step t."""
        for tk in range(t - 1, max(t - 1 - self.every, -1), -1):
            if (tk + s) % self.every == 0:
                return tk
        return None

    def _valid(self, t: int):
        """Each stream's valid keypoints at step t, from its packed block."""
        return (self.blocks[t].reshape(self.S, ROWS, -1)[:, 0] >= 0).sum(1)

    def window_work(self) -> list:
        """(images, [(n0, n1) of each pair problem]) of each step completed in
        the window: the S stereo pairs (the right image's count is not read
        back; the left's stands in) and the S keyframe pairs."""
        out = []
        for t in self.window:
            n = self._valid(t)
            kf = [self._valid(self._kf_step(t, s))[s] for s in range(self.S)]
            out.append((2 * self.S, [(int(a), int(a)) for a in n] +
                        [(int(k), int(a)) for k, a in zip(kf, n)]))
        return out

    def units(self) -> list[Unit]:
        out, fr = [], self.ctx.frames
        for t, desc in self.sample.items:
            blocks = self.blocks[t].reshape(self.S, ROWS, -1)
            for s in range(self.S):
                tk = self._kf_step(t, s)
                have = tk is not None and tk in self.blocks
                f, fk = self._frame(t, s), (self._frame(tk, s) if have else None)
                out.append(Unit(
                    fr[f, 0], fr[f, 1], blocks[s], desc[s],
                    fr[fk, 0] if have else None,
                    self.blocks[tk].reshape(self.S, ROWS, -1)[s, :2] if have else None,
                ))
        return out

    def release(self):
        self.trk = self.g = None
