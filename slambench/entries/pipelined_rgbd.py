"""One RGB-D stream through the port's batched RGB-D step, pipelined.

What ``frontend/pipelined_rgbd.py::PipelinedRgbdTracker`` does in
host-solved mode, without the host estimator: each frame uploaded at
submit through the pipeline's ring of pinned slots
(``frontend/fused_rgbd.py::FusedRgbdPipeline.upload``), a full batch
joined on the device and sent through one
``ops/rgbd_step.py::fused_rgbd_step_multi``, its packed block read back
without blocking into a pooled pinned block
(``frontend/pipelined.py::_AsyncHost``), and the dispatch ``depth``
before drained when a new one is due. The last frame of each drained
dispatch becomes the keyframe (``FusedRgbdPipeline.set_keyframe``, the
step's own device outputs), so dispatch i matches the last frame of
dispatch i - depth.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from slambench.compare import Unit
from slambench.render import pingpong
from slambench.sampling import Reservoir

VIEWS = 1
ROWS = 3  # packed rows a frame: x, y, track match


class Entry:
    def __init__(self, ctx):
        from superslam_tpu_torch.frontend.fused_rgbd import FusedRgbdPipeline
        from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

        cfg, tr = ctx.config, ctx.traffic
        cam, sp = cfg["camera"], cfg["superpoint"]
        self.ctx = ctx
        self.B, self.depth = tr["batch"], tr["depth"]
        calib = StereoCalib(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"],
                            baseline=cam["bf"] / cam["fx"])
        self.pl = FusedRgbdPipeline(
            ctx.sp_params, ctx.matcher_params, calib, cam["width"], cam["height"],
            depth_factor=cam["depth_map_factor"], max_depth=40.0,
            max_keypoints=sp["max_keypoints"], keypoint_threshold=sp["keypoint_threshold"],
            remove_borders=sp["remove_borders"], nms_radius=sp["nms_radius"], device=ctx.device,
            **ctx.matcher.port_kwargs(cfg),
        )
        self.pl.upload_slots = max(self.pl.upload_slots, self.depth * self.B + 1)
        n = ctx.frames.shape[0]
        self.offset = int(ctx.rng.integers(0, 2 * (n - 1)))
        self.frames_per_step = self.B
        self.i = 0  # global dispatch number, warm-up included
        self.pending: deque = deque()  # (dispatch, t_dispatch, _AsyncHost, desc, kpts, valid)
        self.pool: dict = {}
        self.blocks: dict[int, np.ndarray] = {}  # dispatch -> its packed block on the host
        self.window: list[int] = []  # the dispatches drained inside the window
        self.sample = Reservoir(tr["check_steps"], ctx.seed)

    def _frame(self, i: int, f: int) -> int:
        return pingpong(self.offset + i * self.B + f, self.ctx.frames.shape[0])

    def _drain(self):
        """The oldest dispatch's block on the host, its last frame the
        keyframe. Returns (dispatch, t_dispatch, desc)."""
        from superslam_tpu_torch.frontend.features import LazySlotFeatures

        i, t_disp, fut, desc, kpts, valid = self.pending.popleft()
        with self.ctx.span("readback_wait"):
            block = fut.result().copy()
        fut.release()
        with self.ctx.span("kf_write"):
            self.pl.set_keyframe(LazySlotFeatures(
                kpts, desc, valid, slot=self.B - 1, n=0, width=self.pl.width,
                height=self.pl.height))
        self.blocks[i] = block
        return i, t_disp, desc

    def _dispatch(self, on_drain):
        from superslam_tpu_torch.frontend.pipelined import _AsyncHost
        from superslam_tpu_torch.ops.rgbd_step import fused_rgbd_step_multi

        i, fr, pl = self.i, self.ctx.frames, self.pl
        t_disp = time.time_ns()
        with self.ctx.span("prep_upload"):
            staged = [pl.upload(fr[self._frame(i, f), 0]) for f in range(self.B)]
        while len(self.pending) > self.depth - 1:
            on_drain(*self._drain())
        with self.ctx.span("issue"):
            images = torch.cat(staged, dim=0)
            packed, desc, kpts, valid = fused_rgbd_step_multi(
                pl.sp_params, self.ctx.matcher.prepared(pl), images, pl._kf_kpts, pl._kf_desc,
                pl._kf_valid, **pl.step_kw())
            fut = _AsyncHost(packed, self.pool, 1)
        self.pending.append((i, t_disp, fut, desc, kpts, valid))
        self.i += 1

    def warm(self, n: int):
        for _ in range(n):
            self._dispatch(lambda *a: None)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, t_end: int):
        """Dispatches until the window closes. Returns (dispatch ns, done ns)
        of the dispatches drained inside it, and the frames dispatched
        inside it."""
        done, dispatched = [], 0
        first = self.i  # dispatches before the window are warm-up's

        def on_drain(i, t_disp, desc):
            t_done = time.time_ns()
            if i >= first and t_done <= t_end:
                done.append((t_disp, t_done))
                self.window.append(i)
                self.sample.offer(lambda: (i, desc))

        while time.time_ns() < t_end:
            dispatched += self.B
            self._dispatch(on_drain)
        return done, dispatched

    def finish(self):
        while self.pending:
            self._drain()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def _valid(self, i: int):
        """Each frame's valid keypoints in dispatch i, from its packed block."""
        return (self.blocks[i].reshape(self.B, ROWS, -1)[:, 0] >= 0).sum(1)

    def window_work(self) -> list:
        """(images, [(n0, n1) of each pair problem]) of each dispatch drained
        in the window: B keyframe pairs against the last frame of the
        dispatch ``depth`` before."""
        out = []
        for i in self.window:
            kf = int(self._valid(i - self.depth)[-1])
            out.append((self.B, [(kf, int(n)) for n in self._valid(i)]))
        return out

    def units(self) -> list[Unit]:
        out, fr = [], self.ctx.frames
        for i, desc in self.sample.items:
            blocks = self.blocks[i].reshape(self.B, ROWS, -1)
            ik = i - self.depth
            have = ik in self.blocks
            for f in range(self.B):
                out.append(Unit(
                    fr[self._frame(i, f), 0], None, blocks[f], desc[f],
                    fr[self._frame(ik, self.B - 1), 0] if have else None,
                    self.blocks[ik].reshape(self.B, ROWS, -1)[self.B - 1, :2] if have else None,
                ))
        return out

    def release(self):
        self.pl = None
        self.pending.clear()
