#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``superslam_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

In order, any failure exiting non-zero:

1. prints the card (``nvidia-smi`` name and power limit, and
   ``torch.cuda.get_device_name``);
2. builds the hand-written kernels from the sources in the checkout
   (``superslam_tpu_torch/ops/cuda/_build.py``) and the host estimator's
   C++ core (``csrc/``), prints the build times and the registers, shared
   memory and spills from nvcc's report of the mma.sync conv pair kernel's
   eight instantiations (CIN 1 and 64, pooled or not, bf16 or f32 out),
   conv3x3's four (CIN 1 and 64, bf16 or f32 out), the attention
   backward's four (dq and dk/dv kernels, f32 and bf16), the attention
   forward's four (bf16 and f32, in masked_attention.cu and
   lightglue_layer.cu), the fused blocks' two bf16 linears (projection
   and tail), the NMS kernel's two modes (map and logits), the pose solve
   and the per-frame tracking kernel's two epilogues; any spill fails;
3. launches each kernel at the shapes of the main path and holds it against
   its plain PyTorch version on the card (bf16 conv pairs: max error over
   max |plain| <= 2e-2 after the pool; NMS: exact; NMS from SuperPoint's
   logits (random logits with peaks and the checkpoint's on a rendered
   frame): the pre-NMS map within 1e-6 abs of the plain softmax's, the
   NMS'd map exactly ``nms_plain`` of the kernel's own pre-NMS map, the
   same without the pre-NMS map, and the peaks that differ from the plain
   composition printed; bf16 attention: atol
   2e-2, plus the fully-masked row against the mean of v; the fused
   LightGlue self and cross blocks: max error over max |plain| <= 2e-2 in
   bf16 and atol 1e-3 in f32; the descriptor gather: atol 1e-5; the
   unpooled conv pairs and the single conv: 2e-2 of max |plain|; the conv
   pairs and the single conv on operands prepared once give the same bits
   as on OIHW weights; the forward's row statistics against the plain
   softmax's; at the training shape (16, 4, 256, 64) f32 with ragged masks
   and one fully-masked batch row, the forward within 1e-4 of max |plain|
   (the same bits with and without its row statistics; recorded as
   ``masked_attention_f32``) and the attention backward on the forward's
   residuals: dq, dk, dv within 1e-4 of max |plain|, dq = dk = 0
   in that row, autograd's gradients bit-equal), timing kernel (the convs
   on prepared operands, the backward on the forward's residuals), plain
   version and, where one exists, a library call as a yardstick (CUDA
   events, median of 20 after 3 warm-ups; for row 4 also the library's
   forward at the training shape);
4. runs the port's ``SuperSLAM`` facade synchronously (depth 0,
   host-solved: ``SUPERSLAM_PIPELINE=0``, ``SUPERSLAM_DEVICE_TRACKER=0``)
   on 30 rendered frames at the KITTI 00 geometry (1241x376, padded to
   1248x384; 600 keypoints; the committed render-trained SuperPoint and
   synthetic LightGlue weights) on the default, fused LightGlue route,
   checks the poses are finite, the ATE against ground truth is <= 0.5 m
   and the kernels ran exactly 1/1/1/9/9 times per frame (conv1a1b,
   conv_pair, scores_nms, fused_self_block, fused_cross_block; nms,
   masked_attention, pose_solve and track_frame 0), and prints the fused step's median
   ms, the fps and the host estimator's ms a frame (``vo_track_total`` of
   ``utils/profiler.py``);
4b. runs the facade as a user gets it on the card, ``SuperSLAM(cfg)`` with
   no env (depth 3, batch 1, device keyframes), on the same 30 frames: the
   mode, ATE <= 0.5 m, the sustained fps over frames 1..29 by wall clock,
   the host estimator's ms; over the dispatches of frames 5..29 (counters
   reset before frame 5 is submitted, read before the flush) the launches
   a frame, exactly conv1a1b 1, conv_pair 1, scores_nms 1,
   fused_self_block 9, fused_cross_block 9, track_frame 1 and pose_solve 0 once the
   matcher launches of the frames that drain through the host re-match
   path are subtracted (those frames are counted and printed), and every
   dispatch under ``torch.cuda.set_sync_debug_mode("error")``: any
   synchronizing call fails the run (keyframe reseeds are counted); then
   the default and depth 0 once more on new facades, in that order (ABBA
   with the two phases before), each printing its fps, ATE, host
   estimator ms and the host ms a frame of the call that issues its device
   work;
4c. holds ``track_frame`` (the scans' whole per-frame body) against its
   plain twin on the card on every frame of 4b's window in both epilogues
   (track_kf_scan's and track_scan's), and on a promotion (since at
   kf_max_frames), a non-finite solve, a support below the floor, a coast
   and a chi2 stop made from the median frame: the raw solve and the poses
   within 1e-3 of the twin's, and on the kernel's own raw solve the twin's
   epilogue gives exactly its n, support, accept, promo, since, fresh bit,
   matches, valid, depth_ok, nk and desc, its world points within 1e-5 of
   |xw| and its poses within 1e-5; times it (and its scan epilogue, and a
   promoting frame), the twin and its bound; then holds ``pose_solve``
   (the solve alone, on no path since track_frame) against its twin on the
   same frames, a coast and a chi2 stop (|dR|, |dt| <= 1e-3, n and the
   usable mask exact, the kept count within 1% of n) and times it; and
   times the re-match of the frames after the first of a dispatch at
   batch > 1;
4d. runs the 150-frame rendered circuit's legs through
   ``scripts/accuracy_suite_torch.py`` (stereo, stereo_sync, stereo_devkf,
   stereo_loop (with at least one loop closure) and rgbd at ATE <= 1.5x the
   reference's 0.0675, 0.0667, 0.0662, 0.0348 and 0.0969 m; stereo_nogate,
   stereo_passthrough, stereo_devtrack, stereo_devkf_nohybrid,
   stereo_devkf_passthrough, stereo_covis03, rgbd_devtrack (with its gap to
   rgbd), stereo_loop_randomplace, stereo_loop_devkf and stereo_xla_smoother
   (the stereo leg with the device window solver) printed), prints each
   leg's wall time, host pose solves and loop closures and the host-core
   build it loaded, and writes ``ACCURACY_TORCH.json``;
4e. RGB-D at configs/TUM1.yaml's geometry (640x480, its intrinsics, 1000
   keypoints, DepthMapFactor 5000; the bench circuit's room rendered with
   depth): holds conv1a1b, conv_pair, scores_nms (logits) and the fused
   blocks against their plain versions at batch 1, 480x640 and K = 1000
   with the limits of 3; runs 30 frames through the RGB-D facade
   synchronous and host-solved (``SUPERSLAM_PIPELINE=0
   SUPERSLAM_DEVICE_TRACKER=0``), then as a user gets it (``SuperSLAM(cfg)``:
   depth 3, device-tracked mono chain), each at ATE <= 0.5 m with exactly
   1/1/1/9/9 launches a frame and track_frame 1 (device) or 0 (host) over
   frames 5..29 once the host re-match frames' matcher launches are
   subtracted, the device-tracked dispatches under
   ``set_sync_debug_mode("error")``, printing fps, the host estimator's ms
   and the host pose solves; holds ``track_frame`` (mono, track_scan's
   epilogue, K = 1000) against its twin on every device-tracked frame; runs
   10 frames device-tracked with TUM1's distortion (finite poses, the device
   undistortion within 1e-3 px of ``io/undistort.py``); then the loop's
   pieces: EigenPlaces (the committed checkpoint at 512) device-gray
   against host-image descriptor, cosine >= 0.999, one descriptor timed,
   and ``DeviceCosineIndex`` against the host index over 200 descriptors
   (the same ids in the same order); no loop worker runs inside a
   sync-checked window (4d's have stopped);
4f. multi-sequence batched tracking (``parallel/``): the five frame kernels
   at the S = 4 step's shapes (conv1a1b and conv_pair at batch 8,
   scores_nms at (8, 65, 48, 156), the fused blocks at (16, 600, 256), bf16
   and f32) against their plain versions with the limits of 3, timed;
   ``MultiSequenceTracker`` at S = 4 on the bench circuit (sequence s is
   frames 36 s .. 36 s + 29 of the lap), S = 4, 1, 1, 4 (ABBA, sequence-
   frames a second over steps 1..29): exactly 1/1/1/9/9 launches a step for
   all four sequences (nothing else), each sequence's ATE <= 0.5 m and its
   largest position gap to the sequence run alone through
   ``FusedStereoPipeline`` and ``VoEstimator`` <= 0.05 m;
   ``batched_track_scan`` at Q 1, 4 and 16 sequences of 3 frames, K 600
   (tests/test_parallel.py's scene, the last sequence coasting): exactly 3
   launches of ``track_frame_batched`` a call, poses within 1e-4 of the
   plain twin's, counts exact, one launch timed at each Q beside its bound;
   the default facade with ``SUPERSLAM_XLA_SMOOTHER=1`` over the 30 frames
   (ATE <= 0.5 m; every window it solved on the card solved again by the
   host LM, poses within 0.02 m and 0.02 in rotation; ms a solve by CUDA
   events against the host LM's); ``SuperSLAM(cfg, use_viewer=True)`` over 5
   frames (depth 0, 5 poses drawn, ``close()`` returns);
4g. the tooling: ``bench_torch.py``'s run (``run()``, the function its
   ``main()`` calls) at its defaults, depth 3, batch 4, device keyframes,
   on the bench circuit's 144-frame lap (rendered once, cached), with the
   settle cut from 15 s to 3 s and the measure from 135 s to 20 s: its
   stderr lines, its JSON line and its device-only ms printed; the mode;
   over the measured window (counts reset before its first frame, read
   after the flush that ends it) exactly conv1a1b 1, conv_pair 1,
   scores_nms 1, fused_self_block 36, fused_cross_block 36 and track_frame 4
   launches a dispatch and nothing else, once the matcher launches of the
   frames that drain through the host re-match path are subtracted (those
   frames counted and printed); every dispatch and upload of the window
   under ``set_sync_debug_mode("error")``; the ATE against the circuit's
   poses (frame index mod 144) <= 0.3 m over every block of 1000 measured
   frames, each block aligned on its own (the blocks cover the window; the
   error grows with a window's length, and the window's length with the
   fps). Then
   ``scripts/make_synthetic_sequence_torch.py`` writes 30 frames of its
   straight trajectory at 640x352 in the KITTI and the TUM layouts, and
   ``examples/kitti_torch.py``, ``tum_rgbd_torch.py``,
   ``benchmark_torch.py`` and ``multi_sequence_torch.py --replicate 2``
   run on them as subprocesses on the card, each exiting 0, their
   trajectories scored by ``scripts/evaluate_kitti_torch.py`` and
   ``evaluate_tum_torch.py`` at ATE <= 0.5 m each; prints the phase's wall
   time;
4h. tracks 5 more frames of 4's facade under torch.profiler, prints the
   device busy time per frame and the kernels by device time, and fails if
   a softmax kernel ran (the score half is the NMS kernel's logits mode);
5. runs the first 10 frames again on the unfused route
   (``SUPERSLAM_PALLAS_LG=0``): exactly 1/1/1/18 launches per frame
   (masked_attention 18, the fused blocks 0), ATE <= 0.5 m, and prints the
   largest per-frame position gap between the two routes;
6. extracts one rendered stereo pair with
   ``SuperPointExtractor(use_kernel=True)``: descriptors within 1e-5 of
   the default route's, and the gather_normalize kernel launched; then
   runs the map-mode entry point ``nms_suppress`` on that pair's pre-NMS
   map from ``superpoint_dense``: the logits mode's NMS'd map bit for bit;
7. trains the matcher at full width (9 layers, 256 wide, 4 heads, f32,
   batch 8 pairs, cap 256): the gradient of ``matching_loss`` through the
   kernels against the plain versions (every parameter within 1e-3 of that
   tensor's largest plain gradient); ``train_step`` on one fixed synthetic
   batch at lr 3e-4 for FIXED_BATCH_STEPS steps, the last loss below 0.7 x
   the first, with exactly 18 masked_attention and 18
   masked_attention_bwd launches per step and no fused block; then
   ``scripts/train_lightglue_synth_torch.py`` in-process on 24 harvested
   pairs for 20 steps (finite losses, precision and recall printed, the
   checkpoint written and loaded back); and one step under torch.profiler
   for the forward / backward / optimizer split;
7b. the training slice at the scripts' defaults: the gradient of
   ``sp_loss`` (f32, from the committed render-trained checkpoint) on the
   card against the same batch's on the CPU, on a dithered copy (uint8
   images hold pooling windows tied in exact arithmetic, which the last
   bit breaks): with the network in f64 on both, every parameter within
   1e-3 of that tensor's largest CPU gradient; in f32, the card no farther
   from that f64 gradient than twice the CPU's f32 gradient is (the f32
   gradient is 1e-3-1.3e-2 from it on either device), for a wire-format
   batch (8 of the step's 32 at 120x160) and a two-view render batch (8
   at 240x320, hardest-negative term on); ``sp_train_step`` for 10 steps
   on the fixed wire-format batch (32 at 120x160) at lr 1e-3 (finite, last
   loss below the first; step median by CUDA events, steps/s); conv1a1b, conv_pair and scores_nms at (1, 120, 160)
   on a procedural-shapes image and (1, 240, 320) on a sprite render,
   scores_nms against its plain version with the limits of 3 and the conv
   pairs against the pair in f32 within 3's 2e-2 of max (their plain
   versions round the image to bf16 first and part from f32 by 1.5-3.6e-2
   on such images; that distance is printed), timed beside the plain
   version and the library call, and
   ``evaluate_detector`` launching them exactly 1/1/1 an extraction;
   ``scripts/train_superpoint_torch.py`` in-process (40 steps, pool 64,
   render fraction 0.5, render pool 16, evaluations at 20 and 40; finite
   losses, the evaluations printed, the checkpoint loaded back through
   ``load_params`` and one ``SuperPointExtractor`` extraction on it);
   ``scripts/train_eigenplaces_torch.py`` in-process at full width
   (ResNet18, 512-d, 512 x 512, 16 places x 2 views a batch; cut to 24
   places x 4 views, 8 eval places, 30 steps; finite losses, recall@1
   before and after and the step median printed; the checkpoint in
   ``eigenplaces_descriptor`` at unit norm, and the training forward
   within 1e-2 of ``eigenplaces_descriptor`` with its batch statistics
   merged in); and ``sharded_train_step`` on the (1, 1) mesh against
   ``train_step`` on one batch (loss and parameters within 1e-6, 18
   masked_attention and 18 masked_attention_bwd launches); prints the
   phase's wall time;
8. runs every stage of ``scripts/profile_stages_torch.py`` and checks that
   conv1a1b_full, conv_pair_full and conv3x3 were launched there;
9. profiles, after every timed phase (a profiler session slows the
   launches that follow it on the host), the score half on one frame's
   logits, the logits mode beside the composition it replaces (PyTorch's
   softmax and depth-to-space, then the map mode), 10 extractions with
   ``use_kernel=True`` for the gather kernel's device time, one of 4b's
   track_kf_scan calls (its device events must be one track_frame kernel a
   frame, nothing of the old PyTorch body, beside at most the one marker
   that opens the profile), the device time of pose_solve
   and of track_frame (both epilogues, and promoting) on 4b's median frame,
   5 more frames of 4b's
   default facade (device busy ms a frame, the device's idle share, and
   its device events a frame against depth 0's from 4h), 5 more frames of
   4e's default RGB-D facade (the same figures), and last 5 more steps of
   4f's S = 4 tracker (device busy ms a step, idle share);
10. prints one ``{"kernels": [...]}`` line (each kernel's launches are
    those of the phase that drives it: the main path's six from 4b's
    window, the others from 5, 6, 7 or 8, pose_solve's 0 from 4b's; row 4
    twice, bf16 from phase 5
    and f32 from phase 7's fixed-batch steps; ``nms``, the map mode, from
    phase 6: the main path runs the logits mode; ``track_frame_batched``
    from 4f's Q = 16 call), then, as the last line,
    ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1241, 376
PAD_W, PAD_H = 1248, 384  # the frontends' 32-pixel quantum
WIDTH_CELLS, HEIGHT_CELLS = PAD_W // 8, PAD_H // 8
FX, CX, CY, BF = 718.856, 607.1928, 185.2157, 386.1448  # KITTI 00
TRAIN_FX = 320.0  # focal length of the committed checkpoints' render domain
CIRCUIT_FRAMES = 144  # frames per lap of the bench circuit (bench.py)
N_FRAMES = 30
N_FRAMES_UNFUSED = 10
MAX_KP = 600
KP_THRESHOLD = 0.010
ATE_LIMIT_M = 0.5
# Training phase: the script's defaults (batch 8 pairs, cap 256), the
# reference's functional test (lr 3e-4, last loss < 0.7 x first).
TRAIN_BATCH, TRAIN_CAP, TRAIN_LR = 8, 256, 3e-4
# The first run on the card (30 steps, H100) fell below 0.7 x the start
# after 2 steps and went 6.3808 -> 0.0019; 6 is the reference test's count.
FIXED_BATCH_STEPS = 6
SCRIPT_PAIRS, SCRIPT_STEPS = 24, 20
ATTENTION_PER_STEP = 18  # 9 layers x (self + cross), forward and backward each
# The training slice (phase 7b): scripts/train_superpoint.py's defaults
# (batch 32 at 120x160, lr 1e-3; render pairs 8 at 240x320), started from the
# committed render-trained checkpoint; the gradient on the card against the
# CPU's within 1e-3 of each tensor's largest CPU gradient (on a dithered copy
# of the batch, in f64; in f32 within twice the CPU f32's own distance from
# the f64 gradient: see check_sp_gradient).
SP_BATCH, SP_H, SP_W, SP_LR = 32, 120, 160, 1e-3
SP_RENDER_BATCH, SP_RENDER_H, SP_RENDER_W = 8, 240, 320
SP_GRAD_TOL, SP_F32_SPREAD, SP_FIXED_STEPS = 1e-3, 2.0, 10
SP_GRAD_BATCH = 8  # the wire-format gradient check: the first 8 pairs (the CPU's f64 is slow)
SP_SCRIPT_ARGS = ["--steps", "40", "--pool", "64", "--render-frac", "0.5", "--render-pool", "16",
                  "--eval-every", "20"]
# EigenPlaces at full width (ResNet18, 512-d, 512 x 512, 16 places x 2 views a
# batch), cut to 24 places x 4 views, 8 eval places, 30 steps.
EP_SCRIPT_ARGS = ["--places", "24", "--views", "4", "--eval-places", "8", "--steps", "30"]
# Launches per frame on the default (fused) LightGlue route and on the
# unfused one (SUPERSLAM_PALLAS_LG=0).
PER_FRAME_FUSED = {
    "conv1a1b": 1, "conv_pair": 1, "scores_nms": 1, "nms": 0, "fused_self_block": 9,
    "fused_cross_block": 9, "masked_attention": 0, "gather_normalize": 0,
    "pose_solve": 0, "track_frame": 0,  # depth 0 is host-solved
}
PER_FRAME_UNFUSED = {
    **PER_FRAME_FUSED, "fused_self_block": 0, "fused_cross_block": 0, "masked_attention": 18,
}
# The facade's default on the card: depth 3, device keyframes, batch 1. The
# scan's per-frame body is one track_frame launch; pose_solve, its solve
# alone, is on no path (timed beside it in phase 4c).
PER_FRAME_DEFAULT = {**PER_FRAME_FUSED, "track_frame": 1}
OFF_PATH = ("pose_solve",)
STEADY_FROM = 5  # the default phase counts launches over frames 5..29
# The depth-0 phases measure what they measured before the pipelined default.
DEPTH0_ENV = {"SUPERSLAM_PIPELINE": "0", "SUPERSLAM_DEVICE_TRACKER": "0"}
# pose_solve and track_frame against their plain twins: f32 sums in another
# order, and the LM's stop at an improvement below 1e-4 of the error may fall
# one iteration apart.
POSE_ATOL = 1e-3  # m, and rotation-matrix entries
# A mono solve at K ~ 1000 (phase 4e) can be conditioned so badly that the
# order of the f32 sums alone moves it: the LM stops elsewhere and a chi2
# round keeps another set. Each frame's allowance is measured on the frame:
# the plain twin in f32 over MONO_PERMS orders of the same correspondences
# (a permutation changes only the summation order); the kernel must lie
# within POSE_ATOL plus MONO_SPREAD times the farthest of them from the twin
# run in f64 (pose), and its kept count within 1% of n plus MONO_SPREAD
# times theirs.
MONO_PERMS, MONO_SPREAD = 8, 2.0
# track_frame's epilogue against the twin's on the kernel's own solve: one
# f32 Gram-Schmidt and 3 x 3 products in another order.
EPILOGUE_ATOL = 1e-5
XW_RTOL = 1e-5  # the promoted world points: a point's error over its norm
# f32 operations a correspondence costs in the kernel (pose_solve.cu): the
# normal equations' ~350 and the trial error's ~45 an LM iteration; ~40 a
# reprojection for the gate and each chi2 round.
POSE_OPS_ITER, POSE_OPS_REPROJ = 395, 40
ACCURACY_LEGS = ("stereo", "stereo_sync", "stereo_devkf", "stereo_nogate",
                 "stereo_passthrough", "stereo_devtrack", "stereo_devkf_nohybrid",
                 "stereo_devkf_passthrough", "stereo_covis03", "rgbd", "rgbd_devtrack",
                 "stereo_loop", "stereo_loop_randomplace", "stereo_loop_devkf",
                 "stereo_xla_smoother")
# The RGB-D phases: configs/TUM1.yaml's intrinsics, distortion, size, keypoint
# count and depth factor. An RGB-D camera's bf only sets the virtual right
# coordinate and, with ThDepth 40, the depth cut: TUM1's 40 would cut at 3.1 m
# in a room whose walls stand 3-12 m off, so the accuracy suite's virtual
# baseline of 0.3 m is kept (a 12 m cut, inside uint16 depth's 13.1 m).
TUM_FX, TUM_FY, TUM_CX, TUM_CY = 517.306408, 516.469215, 318.64304, 255.313989
TUM_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
TUM_W, TUM_H, TUM_KP = 640, 480, 1000
TUM_BF = 0.3 * TUM_FX
DEPTH_FACTOR, RGBD_FPS = 5000.0, 30.0  # write_tum_sequence's
RGBD_FRAMES, RGBD_DIST_FRAMES, RGBD_PROFILE_FRAMES = 30, 10, 5
LOOP_COSINE = 0.999  # EigenPlaces' device-gray descriptor against the host-image one
# The multi-sequence phase: S sequences of the bench lap, sequence s from
# frame MULTI_STRIDE * s, one step for all of them (2S images, 4S pair
# problems); the launches a step; the largest position gap a sequence may
# have to its run alone (the same frames through FusedStereoPipeline: the
# batch changes only the order of some sums).
MULTI_S, MULTI_STRIDE, MULTI_PROFILE_STEPS = 4, 36, 5
PER_STEP_MULTI = {"conv1a1b": 1, "conv_pair": 1, "scores_nms": 1, "fused_self_block": 9,
                  "fused_cross_block": 9}
MULTI_GAP_M = 0.05
# batched_track_scan: Q sequences of BATCHED_S frames, against its twin
# within BATCHED_ATOL (exact projections: a well-conditioned solve).
BATCHED_Q, BATCHED_S, BATCHED_ATOL = (4, 16), 3, 1e-4
# The device window solver against the host LM on the same windows
# (tests/test_window_smoother.py:92-121's bound), m and rotation entries.
WS_POSE_TOL = 0.02
VIEWER_FRAMES = 5
# The tooling phase (4g): bench_torch.py's run with its settle and measure
# cut from 15 s and 135 s; a dispatch of its batch-4 device-keyframe step
# launches the two conv pairs and the NMS kernel's logits mode once over
# all 8 images, the matcher's 9 layers once batched over
# the 4 stereo and 4 keyframe pair problems and once more for each of frames
# 1-3 (the re-match against the keyframe carried in the scan), and
# track_frame once a frame. The runners: make_synthetic_sequence_torch.py's
# default geometry, TOOL_FRAMES frames of its straight trajectory (its
# circuit is one lap in as many frames as it writes: 12.7 degrees a frame
# at 30).
BENCH_SETTLE_S, BENCH_MEASURE_S = 3.0, 20.0
# The bench's ATE is held over blocks of BENCH_ATE_FRAMES measured frames,
# not over the window, whose length follows the fps: the error grows ~0.2
# mm a frame over the laps (0.1999 m over the first 1000 measured frames on
# the H100, PERF.md section 6), and the limit is 1.5x that.
BENCH_ATE_FRAMES, BENCH_ATE_LIMIT_M = 1000, 0.3
PER_DISPATCH_BENCH = {"conv1a1b": 1, "conv_pair": 1, "scores_nms": 1, "fused_self_block": 36,
                      "fused_cross_block": 36, "track_frame": 4}
TOOL_FRAMES, TOOL_W, TOOL_H, TOOL_TIMEOUT_S = 30, 640, 352, 300

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

KERNEL_INFO = {
    "conv1a1b": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:558",
    ),
    "conv_pair": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:439",
    ),
    "nms": (
        "superslam_tpu_torch/ops/cuda/nms.cu",
        "superslam_tpu/ops/pallas/nms.py:68",
    ),
    "scores_nms": (
        "superslam_tpu_torch/ops/cuda/nms.cu",
        "superslam_tpu/ops/pallas/nms.py:68 + superslam_tpu/models/superpoint.py:236-240",
    ),
    "masked_attention": (
        "superslam_tpu_torch/ops/cuda/masked_attention.cu",
        "superslam_tpu/ops/pallas/attention.py:145",
    ),
    "masked_attention_f32": (
        "superslam_tpu_torch/ops/cuda/masked_attention.cu",
        "superslam_tpu/ops/pallas/attention.py:145",
    ),
    "fused_self_block": (
        "superslam_tpu_torch/ops/cuda/lightglue_layer.cu",
        "superslam_tpu/ops/pallas/lightglue_layer.py:344",
    ),
    "fused_cross_block": (
        "superslam_tpu_torch/ops/cuda/lightglue_layer.cu",
        "superslam_tpu/ops/pallas/lightglue_layer.py:369",
    ),
    "gather_normalize": (
        "superslam_tpu_torch/ops/cuda/gather.cu",
        "superslam_tpu/ops/pallas/gather.py:69",
    ),
    "masked_attention_bwd": (
        "superslam_tpu_torch/ops/cuda/attention_bwd.cu",
        "superslam_tpu/ops/pallas/attention.py:103",
    ),
    "conv_pair_full": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:461",
    ),
    "conv1a1b_full": (
        "superslam_tpu_torch/ops/cuda/conv_pair_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:580",
    ),
    "conv3x3": (
        "superslam_tpu_torch/ops/cuda/conv3x3_mma.cu",
        "superslam_tpu/ops/pallas/conv.py:640",
    ),
    "pose_solve": (
        "superslam_tpu_torch/ops/cuda/pose_solve.cu",
        "superslam_tpu/ops/frontend_step.py:381 + superslam_tpu/ops/pose_solver.py:159 "
        "(XLA, lax.while_loop :198; no pallas_call)",
    ),
    "track_frame": (
        "superslam_tpu_torch/ops/cuda/track_frame.cu",
        "superslam_tpu/ops/frontend_step.py:719-849 (track_kf_scan's step) + :539-580 "
        "(track_scan's) (XLA, lax.scan; no pallas_call)",
    ),
    "track_frame_batched": (
        "superslam_tpu_torch/ops/cuda/track_frame.cu",
        "superslam_tpu/parallel/batched_tracking.py:80-117 (jax.vmap of "
        "ops/frontend_step.py::track_scan :539-580; XLA, no pallas_call)",
    ),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# nvcc's entry names (mangled) of the kernels whose registers chip_smoke
# reports: substring -> instantiations expected.
# The attention forward's two kernels are instantiated in both
# masked_attention.cu and lightglue_layer.cu.
REPORTED_KERNELS = {
    "conv_pair_mma_kernel": 8,
    "conv3x3_mma_kernel": 2,
    "conv3x3_gray_kernel": 2,
    "attn_bwd_dq_kernel": 2,
    "attn_bwd_dkv_kernel": 2,
    "attn_fwd_bf16_kernel": 2,
    "attn_fwd_f32_kernel": 2,
    "proj_mma_kernel": 1,
    "tail_mma_kernel": 1,
    "nms_tile_kernel": 2,
    "pose_solve_kernel": 1,
    "track_frame_kernel": 2,
}


def _smem_bytes(entry: str) -> int:
    """Dynamic shared memory of a reported kernel, from the address models."""
    from superslam_tpu_torch.ops.cuda.attention import bwd_layout, fwd_layout
    from superslam_tpu_torch.ops.cuda.conv import CONV3X3_GRAY_SMEM_BYTES, mma_layout
    from superslam_tpu_torch.ops.cuda.lightglue_layer import gemm_layout
    from superslam_tpu_torch.ops.cuda.nms import tile_layout

    if "nms_tile_kernel" in entry:
        return tile_layout()["SMEM_BYTES"]
    if "pose_solve_kernel" in entry or "track_frame_kernel" in entry:
        return 0  # static only
    if "attn_fwd_bf16" in entry:
        return fwd_layout("bf16")["smem_bytes"]
    if "attn_fwd_f32" in entry:
        return fwd_layout("f32")["smem_bytes"]
    if "proj_mma_kernel" in entry or "tail_mma_kernel" in entry:
        return gemm_layout("proj" if "proj_mma" in entry else "tail")["smem_bytes"]
    if "conv_pair_mma_kernel" in entry:
        return mma_layout("x", 1 if "conv_pair_mma_kernelILi1E" in entry else 64)["smem_bytes"]
    if "conv3x3_mma_kernel" in entry:
        return mma_layout("x3")["smem_bytes"]
    if "attn_bwd" in entry:
        return bwd_layout()["smem_bytes"]
    return CONV3X3_GRAY_SMEM_BYTES


def report_build(build_dir: str) -> None:
    """Print registers, shared memory and spills of every instantiation of
    the mma.sync kernels (the convs, the attention forward and backward, the
    fused blocks' linears) and of the NMS kernel from nvcc's -Xptxas -v
    report; fail on any spill (they keep their accumulators or their
    cell's channels in registers) or a missing instantiation."""
    with open(os.path.join(build_dir, "nvcc.log")) as f:
        lines = f.read().splitlines()
    found = dict.fromkeys(REPORTED_KERNELS, 0)
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        entry = line.split("'")[1]
        kind = next((k for k in REPORTED_KERNELS if k in entry), None)
        if kind is None:
            continue
        block = []
        for nxt in lines[i + 1 : i + 8]:
            if "Compiling entry function" in nxt:
                break
            block.append(nxt)
        text = " ".join(block)
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        static = re.search(r"(\d+) bytes smem", text)
        if not regs or not spill:
            fail(f"nvcc.log: no resource report after {line.strip()}")
        found[kind] += 1
        print(
            f"build {kind}: {entry}: {regs.group(1)} registers, spill stores "
            f"{spill.group(1)} B, spill loads {spill.group(2)} B, shared memory "
            f"{_smem_bytes(entry)} B dynamic + {static.group(1) if static else 0} B static"
        )
        if int(spill.group(1)) or int(spill.group(2)):
            fail(f"{entry}: spills registers")
    if found != REPORTED_KERNELS:
        fail(f"nvcc.log: instantiations reported {found}, want {REPORTED_KERNELS}")


def time_ms(torch, fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of one call (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0, tf32_ops: float = 0.0):
    """Least time in ms: bytes over HBM rate vs operations over peak rates
    (f32 on the CUDA cores, bf16 and TF32 on the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (
        f32_ops / F32_FLOP_PER_S + bf16_ops / BF16_FLOP_PER_S + tf32_ops / TF32_FLOP_PER_S
    ) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def attention_ops(kv_mask, heads: int = 4, dim: int = 64) -> tuple[float, float]:
    """(product, f32) operations of key-masked attention over (B, K) key
    masks: QK^T and PV over the real keys of each row's key set (a masked
    key's probability is exactly 0; a row with no real key averages all K
    values), priced by the caller at the bf16 rate or, f32-accurate, as
    three TF32 products each (3xTF32); and ~5 f32 operations per logit for
    the softmax."""
    k = kv_mask.shape[1]
    real = kv_mask.sum(dim=1)
    keys = float(real.masked_fill(real == 0, k).sum().item())
    return 4.0 * heads * k * keys * dim, 5.0 * heads * k * keys


def attention_bwd_ops(kv_mask, heads: int = 4, dim: int = 64) -> tuple[float, float]:
    """(TF32, f32) operations of the attention backward over (B, K) key
    masks: five products (s, dp, dv, dq, dk) of 2 K x keys x dim each over
    the real keys of a row's key set, each f32-accurate product three TF32
    ones (3xTF32, the card's fastest f32-accurate product), and ~8 f32
    operations per logit for p and ds. A row with no real key has p uniform
    over all K keys and only the dv product."""
    k = kv_mask.shape[1]
    real = kv_mask.sum(dim=1).double()
    no_keys = (real == 0).double()
    products = 5.0 * 2 * k * real * dim + no_keys * 2.0 * k * k * dim
    logits = 8.0 * k * real + no_keys * 3.0 * k * k
    return 3.0 * heads * float(products.sum().item()), heads * float(logits.sum().item())


def check_row_stats(label: str, got, ref) -> None:
    """The forward kernel's row statistics against the plain softmax's: the
    maximum within 1e-5 of max(|m|, 1), 1 / sum within 1e-5 relative (f32
    sums in another order)."""
    err_m = ((got[0] - ref[0]).abs() / ref[0].abs().clamp_min(1.0)).max().item()
    err_l = ((got[1] - ref[1]).abs() / ref[1].abs()).max().item()
    print(f"kernel masked_attention: {label} row statistics vs plain: maximum {err_m:.3g}, "
          f"1 / sum {err_l:.3g} (limit 1e-5)")
    if not (err_m <= 1e-5 and err_l <= 1e-5):
        fail(f"masked_attention: {label} row statistics error {err_m}, {err_l} > 1e-5")


def padded_pair(torch, left, right):
    """A rendered uint8 stereo pair as the frontends feed SuperPoint: f32 in
    [0, 1], zero-padded to the 32-pixel quantum, (2, 384, 1248) on the card."""
    img = np.zeros((2, PAD_H, PAD_W), np.float32)
    img[:, :HEIGHT, :WIDTH] = np.stack([left, right]).astype(np.float32) / 255.0
    return torch.from_numpy(img).to("cuda")


def frame_logits(torch, sp_params, left, right):
    """SuperPoint's detector logits (2, 65, 48, 156) of one rendered stereo
    pair, through the main path's encoder and heads."""
    from superslam_tpu_torch.models.superpoint import _encoder_and_heads, prepare_superpoint_params

    with torch.no_grad():
        logits, _ = _encoder_and_heads(prepare_superpoint_params(sp_params, "cuda"),
                                       padded_pair(torch, left, right), torch.bfloat16)
    return logits


def check_kernels(torch, sp_params, lg_params, frame) -> dict[str, dict]:
    """Each kernel against its plain version at the main path's shapes;
    ``frame`` is a rendered stereo pair for the NMS kernel's logits mode."""
    import torch.nn.functional as F

    from superslam_tpu_torch.models import lightglue as lg
    from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl
    from superslam_tpu_torch.ops.cuda.attention import (
        attention_row_stats_plain,
        masked_attention,
        masked_attention_backward,
        masked_attention_backward_plain,
        masked_attention_plain,
        masked_attention_with_stats,
    )
    from superslam_tpu_torch.ops.cuda.conv import (
        conv3x3,
        conv3x3_operands,
        conv3x3_plain,
        conv_pair,
        conv_pair_plain,
        conv_pair_pool,
        conv_pair_pool_plain,
        pair_operands,
    )
    from superslam_tpu_torch.ops.cuda.gather import gather_normalize, gather_normalize_plain
    from superslam_tpu_torch.ops.cuda.nms import (
        nms_plain,
        nms_suppress,
        scores_nms,
        scores_nms_plain,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    out: dict[str, dict] = {}

    def record(name, err, ms, plain_ms, lib_ms, bnd):
        out[name] = {
            "name": name,
            "route": "cuda",
            "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            "max_abs_err": float(err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bnd[0],
            "bound_by": bnd[1],
            "library_ms": lib_ms,
        }
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(
            f"kernel {name}: max_abs_err {err:.3g}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  library {lib}  "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})",
            flush=True,
        )

    def conv_case(name, kernel, plain, library, out_shape, bnd_of, prepared=None):
        """One conv kernel against its plain version (2e-2 of max |plain|,
        the kernel rounds its conv_a tile to bf16), timed beside the plain
        version and the cuDNN call; returns the kernel's output. With
        ``prepared`` (the same call on operands prepared once, as the main
        path makes it) that call must give the same bits, and its time is
        the one recorded."""
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != out_shape or got.dtype != bf16:
            fail(f"{name}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        print(f"kernel {name}: max error / max |plain| = {rel:.3g} (limit 2e-2)")
        if not rel <= 2e-2:
            fail(f"{name}: relative error {rel} > 2e-2")
        timed = kernel
        if prepared is not None:
            if not torch.equal(prepared(), got):
                fail(f"{name}: prepared operands give another result than OIHW weights")
            print(f"kernel {name}: with OIHW weights laid out in the call "
                  f"{time_ms(torch, kernel):.4f} ms")
            timed = prepared
        record(name, err, time_ms(torch, timed), time_ms(torch, plain),
               time_ms(torch, library), bnd_of(got))
        return got

    x = None
    for name, cin, h, w in (("conv1a1b", 1, 384, 1248), ("conv_pair", 64, 192, 624)):
        pre = ("conv1a", "conv1b") if cin == 1 else ("conv2a", "conv2b")
        wa, ba = sp_params[f"{pre[0]}.weight"], sp_params[f"{pre[0]}.bias"]
        wb, bb = sp_params[f"{pre[1]}.weight"], sp_params[f"{pre[1]}.bias"]
        ops = pair_operands(wa, ba, wb, bb)
        if cin == 1:
            x = torch.from_numpy(rng.uniform(0, 1, (2, 1, h, w)).astype(np.float32)).to(dev)
        xl = x.to(bf16).contiguous(memory_format=torch.channels_last)
        wal, bal, wbl, bbl = (t.to(bf16) for t in (wa, ba, wb, bb))
        px = 2 * h * w

        def pair_bound(out):
            return bound(
                nbytes(x, wa, ba, wb, bb, out),
                f32_ops=2 * px * 64 * 9 if cin == 1 else 0,
                bf16_ops=2 * px * 64 * 64 * 9 * (1 if cin == 1 else 2),
            )

        def library_pair():
            y = F.relu(F.conv2d(xl, wal, bal, padding=1))
            return F.relu(F.conv2d(y, wbl, bbl, padding=1))

        pooled = conv_case(
            name, lambda: conv_pair_pool(x, wa, ba, wb, bb),
            lambda: conv_pair_pool_plain(x, wa, ba, wb, bb),
            lambda: F.max_pool2d(library_pair(), 2), (2, 64, h // 2, w // 2), pair_bound,
            prepared=lambda: conv_pair_pool(x, wa, ba, wb, bb, operands=ops),
        )
        # The same pair without the pool, and (at conv2a) one conv alone, on
        # the same input: what the stage profiler times.
        conv_case(
            name + "_full", lambda: conv_pair(x, wa, ba, wb, bb),
            lambda: conv_pair_plain(x, wa, ba, wb, bb), library_pair, (2, 64, h, w), pair_bound,
            prepared=lambda: conv_pair(x, wa, ba, wb, bb, operands=ops),
        )
        if cin == 64:
            c3ops = conv3x3_operands(wa, ba)
            conv_case(
                "conv3x3", lambda: conv3x3(x, wa, ba), lambda: conv3x3_plain(x, wa, ba),
                lambda: F.relu(F.conv2d(xl, wal, bal, padding=1)), (2, 64, h, w),
                lambda out: bound(nbytes(x, wa, ba, out), bf16_ops=2 * px * 64 * 64 * 9),
                prepared=lambda: conv3x3(x, wa, ba, operands=c3ops),
            )
        x = pooled  # the next pair's input, as on the main path

    # NMS on a (2, 384, 1248) score map with ties and exact zeros.
    s = rng.uniform(0, 1, (2, 384, 1248)) ** 6
    s = torch.from_numpy((np.round(s * 4096) / 4096).astype(np.float32)).to(dev)
    got, ref = nms_suppress(s, 4), nms_plain(s, 4)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"nms: {(got != ref).sum().item()} elements differ from the plain version")
    ms = time_ms(torch, lambda: nms_suppress(s, 4))
    plain_ms = time_ms(torch, lambda: nms_plain(s, 4))

    def library_nms():
        p = F.max_pool2d(s[:, None], 9, 1, 4)[:, 0]
        return torch.where(s == p, s, 0.0)

    lib_ms = time_ms(torch, library_nms)
    record("nms", 0.0, ms, plain_ms, lib_ms, bound(2 * nbytes(s), f32_ops=s.numel() * 17))

    # NMS from SuperPoint's logits at the serving shape (2, 65, 48, 156),
    # channels_last as the head's convs give them: random logits with peaks,
    # and the checkpoint's own on a rendered frame (the timed input).
    x = rng.standard_normal((2, 65, HEIGHT_CELLS, WIDTH_CELLS)) * 4
    random_logits = torch.from_numpy(x.astype(np.float32)).to(dev)
    random_logits = random_logits.contiguous(memory_format=torch.channels_last)
    logits = frame_logits(torch, sp_params, *frame)
    print(f"kernel scores_nms: the main path's logits {tuple(logits.shape)} {logits.dtype} "
          f"arrive channels_last: {logits.is_contiguous(memory_format=torch.channels_last)}")
    worst = 0.0
    for label, lg_in in (("random logits with peaks", random_logits),
                         ("the checkpoint's logits on a rendered frame", logits)):
        out_k, pre_k = scores_nms(lg_in, 4, return_pre=True)
        out_only, none = scores_nms(lg_in, 4)
        ref_out, ref_pre = scores_nms_plain(lg_in, 4, return_pre=True)
        torch.cuda.synchronize()
        if out_k.shape != ref_out.shape or not torch.isfinite(pre_k).all().item():
            fail(f"scores_nms: {label}: output {tuple(out_k.shape)} not finite")
        err = (pre_k - ref_pre).abs().max().item()
        if not err <= 1e-6:
            fail(f"scores_nms: {label}: pre-NMS map max abs error {err} > 1e-6")
        n_bad = (out_k != nms_plain(pre_k, 4)).sum().item()
        if n_bad:
            fail(f"scores_nms: {label}: {n_bad} pixels differ from nms_plain of its pre-NMS map")
        if none is not None or not torch.equal(out_only, out_k):
            fail(f"scores_nms: {label}: return_pre=False gives another NMS'd map")
        peaks = (out_k > 0).sum().item()
        differ = ((out_k > 0) != (ref_out > 0)).sum().item()
        print(f"kernel scores_nms ({label}): pre-NMS map max abs error {err:.3g} (limit 1e-6), "
              f"NMS'd map == nms_plain(pre-NMS map) bit for bit, {peaks} peaks, {differ} "
              "differ from the plain composition's (not gated)")
        worst = max(worst, err)
    ms = time_ms(torch, lambda: scores_nms(logits, 4, return_pre=True))
    print(f"kernel scores_nms: without the pre-NMS map "
          f"{time_ms(torch, lambda: scores_nms(logits, 4)):.4f} ms")
    plain_ms = time_ms(torch, lambda: scores_nms_plain(logits, 4, return_pre=True))

    def library_scores():
        # A composition, not one call: softmax, pixel_shuffle (the same
        # depth-to-space) and a max_pool2d compare.
        p = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :-1], 8)
        return torch.where(p == F.max_pool2d(p, 9, 1, 4), p, 0.0)

    lib_ms = time_ms(torch, library_scores)
    record(
        "scores_nms", worst, ms, plain_ms, lib_ms,
        bound(nbytes(logits, out_k, pre_k),
              f32_ops=4.0 * logits.numel() + 19.0 * out_k.numel()),
    )

    # Attention at LightGlue's (2 pair problems x 2 sides, 4 heads, K=600).
    shape = (4, 4, 600, 64)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf16)
               for _ in range(3))
    mask = torch.from_numpy(rng.uniform(size=(4, 600)) < 0.7).to(dev)
    mask[1] = False  # the keyframe side before the first keyframe
    got, ref = masked_attention(q, k, v, mask), masked_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not err <= 2e-2:
        fail(f"masked_attention: max abs error {err} > 2e-2")
    mean_v = v[1].float().mean(dim=1, keepdim=True).expand(-1, 600, -1)
    err_masked = (got[1].float() - mean_v).abs().max().item()
    print(f"kernel masked_attention: fully-masked row vs mean of v: {err_masked:.3g}")
    if not err_masked <= 2e-2:
        fail(f"masked_attention: fully-masked row error {err_masked} > 2e-2")
    # The row statistics (the backward's residuals) change no bit of the output.
    got_s, stats_s = masked_attention_with_stats(q, k, v, mask)
    if not torch.equal(got_s, got):
        fail("masked_attention: the output differs when the row statistics are written")
    check_row_stats("bf16", stats_s, attention_row_stats_plain(q, k, mask))
    ms = time_ms(torch, lambda: masked_attention(q, k, v, mask))
    plain_ms = time_ms(torch, lambda: masked_attention_plain(q, k, v, mask))
    sdpa_mask = mask[:, None, None, :]
    lib_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    )
    a_bf16, a_f32 = attention_ops(mask)
    record(
        "masked_attention", err, ms, plain_ms, lib_ms,
        bound(nbytes(q, k, v, mask, got), bf16_ops=a_bf16, f32_ops=a_f32),
    )

    # Attention forward (f32) and backward at the training shape: 8 pairs x
    # 2 sides, 4 heads, cap 256, ragged masks as harvested pairs have them,
    # one fully-masked batch row.
    tshape = (2 * TRAIN_BATCH, 4, TRAIN_CAP, 64)
    tq, tk, tv, tg = (
        torch.from_numpy(rng.standard_normal(tshape).astype(np.float32)).to(dev)
        for _ in range(4)
    )
    n_real = rng.integers(TRAIN_CAP // 2, TRAIN_CAP + 1, size=2 * TRAIN_BATCH)
    tmask = torch.from_numpy(np.arange(TRAIN_CAP)[None] < n_real[:, None]).to(dev)
    tmask[3] = False
    # The residuals from the forward (f32, as training runs it), and the
    # forward itself against its plain version: within 1e-4 of max |plain|
    # (3xTF32; one TF32 product would miss it), the same bits without the
    # row statistics, the fully-masked row the mean of v.
    tout, tstats = masked_attention_with_stats(tq, tk, tv, tmask)
    check_row_stats("f32", tstats, attention_row_stats_plain(tq, tk, tmask))
    tref = masked_attention_plain(tq, tk, tv, tmask)
    torch.cuda.synchronize()
    if tout.shape != tshape or not torch.isfinite(tout).all().item():
        fail(f"masked_attention (f32): output {tuple(tout.shape)} not finite")
    f32_err = (tout - tref).abs().max().item()
    f32_rel = f32_err / max(tref.abs().max().item(), 1e-12)
    print(f"kernel masked_attention (f32, {tshape}): max error / max |plain| = {f32_rel:.3g} "
          "(limit 1e-4)")
    if not f32_rel <= 1e-4:
        fail(f"masked_attention (f32): relative error {f32_rel} > 1e-4")
    with torch.no_grad():
        if not torch.equal(masked_attention(tq, tk, tv, tmask), tout):
            fail("masked_attention (f32): the output differs when the row statistics are written")
    got3 = masked_attention_backward(tq, tk, tv, tmask, tg, tout, tstats)
    ref3 = masked_attention_backward_plain(tq, tk, tv, tmask, tg)
    torch.cuda.synchronize()
    worst = 0.0
    for label, a, b in zip(("dq", "dk", "dv"), got3, ref3):
        if a.shape != tshape or a.dtype != torch.float32 or not torch.isfinite(a).all().item():
            fail(f"masked_attention_bwd: {label} {tuple(a.shape)} {a.dtype}")
        e = (a - b).abs().max().item()
        rel = e / max(b.abs().max().item(), 1e-12)
        print(f"kernel masked_attention_bwd: {label} max error / max |plain| = {rel:.3g} (limit 1e-4)")
        if not rel <= 1e-4:
            fail(f"masked_attention_bwd: {label} relative error {rel} > 1e-4")
        worst = max(worst, e)
    if got3[0][3].abs().max().item() != 0 or got3[1][3].abs().max().item() != 0:
        fail("masked_attention_bwd: dq, dk of the fully-masked batch row are not zero")
    # The Function: a result on the card carries a grad_fn and its gradient
    # is the backward kernel's.
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out_t = masked_attention(*leaves, tmask)
    if out_t.grad_fn is None:
        fail("masked_attention: no grad_fn on a CUDA tensor that requires grad")
    out_t.backward(tg)
    if not all(torch.equal(leaf.grad, g3) for leaf, g3 in zip(leaves, got3)):
        fail("masked_attention: autograd's gradients differ from masked_attention_backward's")
    ms = time_ms(torch, lambda: masked_attention_backward(tq, tk, tv, tmask, tg, tout, tstats))
    plain_ms = time_ms(torch, lambda: masked_attention_backward_plain(tq, tk, tv, tmask, tg))
    sdpa_tmask = tmask[:, None, None, :].clone()
    sdpa_tmask[3] = True  # the library has no replaced-logit row; any mask times the same

    def library_bwd():
        for t in leaves:
            t.grad = None
        F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_tmask).backward(tg)

    # Autograd through the library's attention: forward + backward, less the
    # forward alone.
    lib_ms = time_ms(torch, library_bwd)
    with torch.no_grad():
        lib_ms -= time_ms(
            torch, lambda: F.scaled_dot_product_attention(tq, tk, tv, attn_mask=sdpa_tmask)
        )
    tf32_ops, f32_ops = attention_bwd_ops(tmask)
    record(
        "masked_attention_bwd", worst, ms, plain_ms, lib_ms,
        bound(nbytes(tq, tk, tv, tg, tmask, tout, tstats, *got3),
              f32_ops=f32_ops, tf32_ops=tf32_ops),
    )
    with torch.no_grad():
        f32_fwd_ms = time_ms(torch, lambda: masked_attention(tq, tk, tv, tmask))
        f32_stats_ms = time_ms(torch, lambda: masked_attention_with_stats(tq, tk, tv, tmask))
        f32_plain_ms = time_ms(torch, lambda: masked_attention_plain(tq, tk, tv, tmask))
        f32_lib_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(tq, tk, tv, attn_mask=sdpa_tmask)
        )
    print(f"kernel masked_attention_f32: with the row statistics {f32_stats_ms:.4f} ms")
    # Row 4 in f32: both products f32-accurate as 3xTF32 on the tensor cores,
    # over each row's real keys, and the softmax's per-logit f32 work.
    a_ops, a_f32 = attention_ops(tmask)
    record(
        "masked_attention_f32", f32_err, f32_fwd_ms, f32_plain_ms, f32_lib_ms,
        bound(nbytes(tq, tk, tv, tmask, tout, tstats), f32_ops=a_f32, tf32_ops=3.0 * a_ops),
    )
    del got3, ref3, leaves, out_t

    # The forward's library time is taken twice, before and after the
    # backward check, and the smaller kept: a first reading at a new shape
    # can include the library's own choice of kernel.
    lib_again = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    )
    print(
        f"kernel masked_attention: library time re-taken {lib_again:.4f} ms "
        f"(first reading {out['masked_attention']['library_ms']:.4f} ms; the smaller is kept)"
    )
    out["masked_attention"]["library_ms"] = min(out["masked_attention"]["library_ms"], lib_again)

    # The fused LightGlue blocks at (2 pair problems x 2 sides, K=600, 256)
    # with the committed checkpoint's layer 0, ragged masks and the
    # keyframe side before the first keyframe fully masked.
    x32 = torch.from_numpy(rng.standard_normal((4, 600, 256)).astype(np.float32)).to(dev)
    xb = x32.to(bf16)
    kpts = torch.from_numpy(rng.uniform(-1, 1, (4, 600, 2)).astype(np.float32)).to(dev)
    proj = kpts @ lg_params["posenc.Wr.weight"].float().t()
    cos, sin = torch.cos(proj), torch.sin(proj)
    cast = lg.cast_compute_params(lg_params)  # the unfused route's weights
    m_rows = 4 * 600
    tail_ops = 2.0 * m_rows * (256 * 256 + 512 * 512 + 512 * 256)  # 2 per multiply-add
    swapped = mask.reshape(2, 2, 600).flip(1).reshape(4, 600)  # the cross block's key sets
    for name in ("fused_self_block", "fused_cross_block"):
        is_self = name == "fused_self_block"
        prefix = "transformers.0." + ("self_attn" if is_self else "cross_attn")
        prep = lgl.prep_self_weights if is_self else lgl.prep_cross_weights
        rotary = (cos, sin) if is_self else ()

        def call(fn, dtype):
            xd, w = x32.to(dtype), prep(lg_params, prefix, dtype)
            return lambda: fn(xd, *rotary, mask, w)

        got32 = call(getattr(lgl, name), torch.float32)()
        ref32 = call(getattr(lgl, name + "_plain"), torch.float32)()
        torch.cuda.synchronize()
        err32 = (got32 - ref32).abs().max().item()
        print(f"kernel {name}: f32 max abs error {err32:.3g} (limit 1e-3)")
        if not (torch.isfinite(got32).all().item() and err32 <= 1e-3):
            fail(f"{name}: f32 max abs error {err32} > 1e-3")
        kernel_fn, plain_fn = call(getattr(lgl, name), bf16), call(getattr(lgl, name + "_plain"), bf16)
        got, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if got.shape != (4, 600, 256) or got.dtype != bf16:
            fail(f"{name}: output {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        print(f"kernel {name}: max error / max |plain| = {rel:.3g} (limit 2e-2)")
        if not (torch.isfinite(got.float()).all().item() and rel <= 2e-2):
            fail(f"{name}: relative error {rel} > 2e-2")
        ms = time_ms(torch, kernel_fn)
        plain_ms = time_ms(torch, plain_fn)
        # No single PyTorch call computes a block. For scale: the unfused
        # route's block at the same shapes (PyTorch linears, LayerNorm and
        # GELU around the masked_attention kernel).
        if is_self:
            enc = lg._rotary_encoding(kpts, cast, bf16)
            unfused_ms = time_ms(torch, lambda: lg._self_block(xb, enc, mask, cast, prefix, bf16))
        else:
            unfused_ms = time_ms(torch, lambda: lg._cross_block_paired(xb, mask, cast, prefix, bf16))
        print(f"kernel {name}: the unfused route's block at the same shapes {unfused_ms:.4f} ms")
        proj_ops = 2.0 * m_rows * 256 * (768 if is_self else 512)
        a_bf16, a_f32 = attention_ops(mask if is_self else swapped)
        io = nbytes(xb, *rotary, mask, got, *prep(lg_params, prefix, bf16))
        record(
            name, err, ms, plain_ms, None,
            bound(io, bf16_ops=proj_ops + tail_ops + a_bf16, f32_ops=a_f32 + 30.0 * m_rows * 512),
        )

    # The descriptor gather at the main path's grid (48 x 156 cells of a
    # 1248 x 384 frame, 256 channels, bf16) and keypoint count.
    grid = torch.from_numpy(rng.standard_normal((2, 48 * 156, 256)).astype(np.float32))
    grid = F.normalize(grid.to(dev), dim=-1).to(bf16)
    cells = torch.from_numpy(rng.integers(0, 48 * 156, size=(2, 600))).to(dev)
    got, ref = gather_normalize(grid, cells), gather_normalize_plain(grid, cells)
    torch.cuda.synchronize()
    if got.shape != (2, 600, 256) or got.dtype != torch.float32:
        fail(f"gather_normalize: output {tuple(got.shape)} {got.dtype}")
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        fail(f"gather_normalize: max abs error {err} > 1e-5")
    ms = time_ms(torch, lambda: gather_normalize(grid, cells))
    plain_ms = time_ms(torch, lambda: gather_normalize_plain(grid, cells))
    flat_cells = (cells + torch.arange(2, device=dev)[:, None] * (48 * 156)).reshape(-1)
    flat_grid = grid.reshape(-1, 256)
    lib_ms = time_ms(
        torch, lambda: F.normalize(flat_grid.index_select(0, flat_cells).float(), dim=-1)
    )
    rows = cells.numel() * 256
    record(
        "gather_normalize", err, ms, plain_ms, lib_ms,
        bound(rows * grid.element_size() + nbytes(cells, got), f32_ops=3.0 * rows),
    )
    return out


def render_sequence(n: int, width: int, height: int, start: int = 0, seed: int = 0):
    """The bench circuit (bench.py): the sprite room scaled by FX/TRAIN_FX so
    the apparent feature size matches the checkpoints' render domain, seen
    through the KITTI 00 rig; frames start..start+n of a 144-frame lap."""
    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_stereo,
    )
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

    s = FX / TRAIN_FX
    world = make_room_world(
        np.random.default_rng(seed),
        half_x=8.0 * s,
        half_z=8.0 * s,
        height=2.4 * s,
        n_sprites=420,
        sprite_half=(0.28 * s, 0.55 * s),
    )
    calib = StereoCalib(fx=FX, fy=FX, cx=CX, cy=CY, baseline=BF / FX)
    poses = circuit_trajectory(CIRCUIT_FRAMES, radius_x=4.5 * s, radius_z=4.5 * s, laps=1.0)
    rrng = np.random.default_rng(seed + 1)
    frames = []
    for p in poses[start : start + n]:
        left, right = render_stereo(world, p, calib, height, width, rrng)
        frames.append(
            (np.round(left * 255).astype(np.uint8), np.round(right * 255).astype(np.uint8))
        )
    return frames, poses[start : start + n]


CONFIG = """\
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.bf: {bf}
Camera.width: {width}
Camera.height: {height}
ThDepth: 35
SuperPoint.model_dir: "{weights}"
superpoint:
  max_keypoints: {max_kp}
  keypoint_threshold: {threshold}
  remove_borders: 4
  weights_file: superpoint_render.safetensors
lightglue:
  image_width: {width}
  image_height: {height}
  weights_file: lightglue_synth.safetensors
Backend.window_size: 10
KeyFrame.covis_ratio: 0.75
KeyFrame.max_frames: 20
"""


def build_slam(width: int = WIDTH, height: int = HEIGHT, max_kp: int = MAX_KP,
               use_viewer: bool = False):
    """The port's facade on the bench circuit's config, with the env as it
    stands."""
    from superslam_tpu_torch.slam import SuperSLAM

    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "kitti_render.yaml")
        with open(cfg, "w") as f:
            f.write(
                CONFIG.format(
                    fx=FX, cx=CX, cy=CY, bf=BF, width=width, height=height,
                    weights=os.path.join(REPO, "weights") + os.sep,
                    max_kp=max_kp, threshold=KP_THRESHOLD,
                )
            )
        return SuperSLAM(cfg, use_viewer=use_viewer)


def estimator_ms() -> tuple[float, int]:
    """Mean ms and count of the host estimator's ``vo_track_total`` scope
    (utils/profiler.py, on under SUPERSLAM_PROFILE=1) since the last call;
    clears the accumulator, so nothing is dumped at exit."""
    from superslam_tpu_torch.utils.profiler import Profiler

    prof = Profiler.instance()
    total, n = prof.stats().get("vo_track_total", (0.0, 0))
    with prof._lock:
        prof._acc.clear()
    return total / max(n, 1), n


def tracker_mode(t) -> str:
    kind = ("device keyframes" if t.device_kf else "dispatch-frozen device tracking"
            if t.device_tracking else "host-solved")
    return f"depth {t.depth}, batch {t.batch}, {kind}"


def facade_mode(slam) -> str:
    if slam._tracker is None:
        return "depth 0 (synchronous), host-solved"
    return tracker_mode(slam._tracker)


def run_facade(torch, frames, width: int, height: int, max_kp: int):
    """Drive the port's facade synchronously over rendered frames, with the
    launch counts set to 0 just before the first frame and read just after
    the last. Returns (the facade, poses, per-frame fused-step ms, loop
    seconds after frame 0, launch counts, keyframe count, estimator ms)."""
    from superslam_tpu_torch.ops.cuda import _build

    slam = build_slam(width, height, max_kp)
    if slam._tracker is not None:
        fail(f"the depth-0 phase built a pipelined tracker ({facade_mode(slam)})")
    step_ms: list[float] = []
    process = slam.pipeline.process

    def timed_process(left, right, timestamp):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        result = process(left, right, timestamp)  # ends in the packed readback
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        return result

    slam.pipeline.process = timed_process
    estimator_ms()
    _build.reset_launch_counts()
    t1 = None
    for i, (left, right) in enumerate(frames):
        Tcw = slam.track_stereo(left, right, 0.1 * i)
        if Tcw.shape != (4, 4) or not np.isfinite(Tcw).all():
            fail(f"frame {i}: pose {Tcw}")
        if i == 0:
            t1 = time.perf_counter()
    loop_s = time.perf_counter() - t1
    counts = _build.launch_counts()
    est_ms = estimator_ms()
    slam.pipeline.process = process
    slam.estimator.stop_loop_worker()
    poses = slam.estimator.corrected_trajectory()
    n_kf = len(slam.estimator.anchors())
    return slam, poses, step_ms, loop_s, counts, n_kf, est_ms


def check_facade_run(label, slam, poses, gt, step_ms, loop_s, counts, n_kf, per_frame, est_ms):
    """Print one synchronous facade run's lines and hold it to its launch
    counts and the ATE limit. Returns the ATE result."""
    from superslam_tpu_torch.eval.metrics import ate

    n = len(gt)
    res = ate(poses, gt)
    print(f"facade ({label}): mode {facade_mode(slam)}")
    print(
        f"facade ({label}): {n} frames {WIDTH}x{HEIGHT}, fused step median "
        f"{statistics.median(step_ms):.3f} ms (first {step_ms[0]:.1f} ms), "
        f"{(n - 1) / loop_s:.2f} fps over frames 1..{n - 1}, ATE {res.rmse:.4f} m, "
        f"keyframes {n_kf}, host estimator {est_ms[0]:.3f} ms a frame ({est_ms[1]} frames), "
        f"launches {counts}"
    )
    for k, per in per_frame.items():
        if counts[k] != per * n:
            fail(f"{label}: {k}: {counts[k]} launches in {n} frames, want {per} per frame")
    if not np.isfinite(res.rmse) or res.rmse > ATE_LIMIT_M:
        fail(f"{label}: ATE {res.rmse} m > {ATE_LIMIT_M} m")
    return res


def instrument_window(torch, tracker, pipeline, matcher, estimator):
    """Counting and sync-guard wrappers for a measured window, shared by the
    facade phases and the bench run. While ``window["on"]`` holds:
    ``matcher.match`` adds each call (the host re-match path) with the frame
    it ran for and the launches it made; ``tracker._dispatch`` (counted
    where frames are staged) and ``pipeline.upload`` run under
    set_sync_debug_mode("error"). Without a tracker only the matcher is
    wrapped. Returns (window, restore): restore() puts the originals back."""
    from superslam_tpu_torch.ops.cuda import _build

    window = {"on": False, "dispatches": 0, "rematch_calls": 0, "rematch_frames": [],
              "rematch": dict.fromkeys(_build.KERNELS, 0)}
    saved = [(matcher, "match", matcher.match)]
    if tracker is not None:
        saved += [(tracker, "_dispatch", tracker._dispatch), (pipeline, "upload", pipeline.upload)]
    match = matcher.match

    def counted_match(*a, **kw):
        before = _build.launch_counts()
        out = match(*a, **kw)
        if window["on"]:
            window["rematch_calls"] += 1
            window["rematch_frames"].append(len(estimator._frame_records))
            for k, v in _build.launch_counts().items():
                window["rematch"][k] += v - before[k]
        return out

    def guarded(fn, counted):
        def call(*a, **kw):
            if not window["on"]:
                return fn(*a, **kw)
            if counted and tracker._staged:
                window["dispatches"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return call

    matcher.match = counted_match
    if tracker is not None:
        tracker._dispatch = guarded(tracker._dispatch, True)
        pipeline.upload = guarded(pipeline.upload, False)

    def restore():
        for owner, name, fn in saved:
            setattr(owner, name, fn)

    return window, restore


def run_default_facade(torch, frames, gt):
    """The facade as a user gets it on the card (``SuperSLAM(cfg)``, no env):
    depth 3, device keyframes. Over the dispatches of frames 5..29 the
    launch counts are read (reset before frame 5 is submitted, read before
    the flush), every dispatch runs under set_sync_debug_mode("error"), the
    frames that drain through the host re-match path are counted with the
    matcher launches they add, and each frame's track_frame inputs (and one
    whole track_kf_scan call) are kept for the kernel checks. Returns (the
    facade, the launch counts of the window, the captured track_frame calls,
    the captured scan call)."""
    from superslam_tpu_torch.eval.metrics import ate
    from superslam_tpu_torch.ops import frontend_step
    from superslam_tpu_torch.ops.cuda import _build

    slam = build_slam()
    tracker = slam._tracker
    mode = facade_mode(slam)
    print(f"facade (default): mode {mode}")
    if tracker is None or tracker.depth != 3 or tracker.batch != 1 or not tracker.device_kf:
        fail(f"default facade: {mode}, want depth 3, batch 1, device keyframes")

    window, restore = instrument_window(torch, tracker, slam.pipeline, slam.matcher,
                                        slam.estimator)
    captured, scans = [], []
    body, scan = frontend_step.track_frame, frontend_step.track_kf_scan

    def capturing_body(*a, **kw):
        if window["on"]:
            a = (clone_carry(a[0]), *clone_tree(a[1:]))
            captured.append((a, clone_tree({k: v for k, v in kw.items() if k != "out"})))
        return body(*a, **kw)

    def capturing_scan(*a, **kw):
        if window["on"] and not scans:
            scans.append(((*clone_tree(a[:8]), clone_carry(a[8])), clone_tree(kw)))
        return scan(*a, **kw)

    frontend_step.track_frame, frontend_step.track_kf_scan = capturing_body, capturing_scan
    estimator_ms()
    try:
        t1 = None
        for i, (left, right) in enumerate(frames):
            if i == STEADY_FROM:
                _build.reset_launch_counts()
                reseeds = tracker.reseeds
                window["on"] = True
            Tcw = slam.track_stereo(left, right, 0.1 * i)
            if Tcw.shape != (4, 4) or not np.isfinite(Tcw).all():
                fail(f"default facade: frame {i}: pose {Tcw}")
            if i == 0:
                t1 = time.perf_counter()
        window["on"] = False
        counts = _build.launch_counts()
        reseeds = tracker.reseeds - reseeds
        slam.flush()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
    finally:
        frontend_step.track_frame, frontend_step.track_kf_scan = body, scan
        restore()
    est_ms = estimator_ms()
    poses = slam.estimator.corrected_trajectory()
    res = ate(poses, gt)
    n = len(frames)
    steady = n - STEADY_FROM
    print(
        f"facade (default): {n} frames {WIDTH}x{HEIGHT}, {(n - 1) / loop_s:.2f} fps sustained "
        f"over frames 1..{n - 1} (wall clock, flush included), ATE {res.rmse:.4f} m, keyframes "
        f"{len(slam.estimator.anchors())}, host estimator {est_ms[0]:.3f} ms a frame "
        f"({est_ms[1]} frames)"
    )
    print(
        f"facade (default): frames {STEADY_FROM}..{n - 1}: no synchronizing call in the "
        f"dispatches under set_sync_debug_mode('error'); keyframe reseeds {reseeds}; frames "
        f"drained through the host re-match path {len(window['rematch_frames'])}: "
        f"{window['rematch_frames']} (frames 1-2 are dispatched before the first keyframe "
        f"drains; their matcher "
        f"launches {dict((k, v) for k, v in window['rematch'].items() if v)}); launches {counts}"
    )
    for k, per in PER_FRAME_DEFAULT.items():
        got = counts[k] - window["rematch"][k]
        print(f"facade (default): {k}: {got / steady:g} launches a frame over {steady} dispatches")
        if got != per * steady:
            fail(f"default facade: {k}: {got} launches in {steady} dispatches, want {per} a frame")
    if not np.isfinite(res.rmse) or res.rmse > ATE_LIMIT_M:
        fail(f"default facade: ATE {res.rmse} m > {ATE_LIMIT_M} m")
    return slam, counts, captured, scans[0]


def clone_tree(x):
    """A copy of a call's arguments: tensors cloned (the pipeline reuses its
    buffers), tuples, lists and dicts walked, anything else kept."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


def clone_carry(carry):
    """A copy of a pose carry (R, t, rel_R, rel_t) in one buffer, back to back,
    as the tracker's upload and each frame's kernel output hold it (the
    kernel takes it as one (24,) block without a copy)."""
    import torch

    flat = torch.cat([c.reshape(-1) for c in carry])
    return flat[:9].view(3, 3), flat[9:12], flat[12:21].view(3, 3), flat[21:24]


def run_reversed_pair(torch, frames, gt) -> None:
    """The two modes again, each on a new facade over the same frames, in the
    reverse order of the phases above (the default first, then depth 0), so
    that the comparison runs ABBA in one call. Both track with the same
    loop, flush included, without the checks' instrumentation, and print
    the sustained fps over frames 1..n-1, the host estimator's ms a frame
    and the host ms a frame of the call that issues the device work: the
    default's dispatch (the step's launches, nothing waited for) and depth
    0's fused step (its launches and the wait for its readback)."""
    from scripts.accuracy_suite_torch import leg_environment

    for label, env in (("default", {}), ("depth 0", DEPTH0_ENV)):
        with leg_environment(env):
            mode, fps, est_ms, issue, n_issue, rmse = sustained_run(torch, frames, gt)
        print(f"facade order: {label} again ({mode}), after the phases above: {fps:.2f} fps "
              f"sustained over frames 1..{len(frames) - 1}, host estimator {est_ms:.3f} ms a "
              f"frame, {issue} ({n_issue} calls), ATE {rmse:.4f} m")
        if not np.isfinite(rmse) or rmse > ATE_LIMIT_M:
            fail(f"facade order: {label}: ATE {rmse} m > {ATE_LIMIT_M} m")


def sustained_run(torch, frames, gt):
    """A new facade with the env as it stands over the frames; returns (its
    mode, fps over frames 1.., estimator ms a frame, the issuing call's host
    ms a frame as text, that call's count, ATE)."""
    from superslam_tpu_torch.eval.metrics import ate

    slam = build_slam()
    tracker = slam._tracker
    owner, name = (slam.pipeline, "process") if tracker is None else (tracker, "_dispatch")
    issue, spent = getattr(owner, name), []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return issue(*a, **kw)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(owner, name, timed)
    estimator_ms()
    t1 = None
    for i, (left, right) in enumerate(frames):
        slam.track_stereo(left, right, 0.1 * i)
        if i == 0:
            t1 = time.perf_counter()
            spent.clear()
    slam.flush()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    est_ms = estimator_ms()[0]
    rmse = ate(slam.estimator.corrected_trajectory(), gt).rmse
    mode = facade_mode(slam)
    slam.shutdown()
    what = "fused step" if tracker is None else "dispatch"
    issue_ms = f"{what} {1e3 * sum(spent) / max(len(spent), 1):.3f} ms a frame of host time"
    return mode, (len(frames) - 1) / loop_s, est_ms, issue_ms, len(spent), rmse


def cut_matches(args, n: int, usable=None):
    """A captured pose_solve call's arguments with only the first n matched
    keyframe features left matched, taken from the usable mask ``usable``
    when given (the coast case: 6 against the floor of 10; the chi2-stop
    case: min_matches + 4 usable ones with noisy keypoints)."""
    args = [t.clone() for t in args]
    tm = args[7]
    keep = ((tm >= 0) if usable is None else usable).nonzero().flatten()[:n]
    cut = tm.new_full(tm.shape, -1)
    cut[keep] = tm[keep]
    args[7] = cut
    return args


def check_pose_solve(torch, captured):
    """pose_solve against its plain twin (both on the card) on the frames and
    keyframes of the default phase's run, on a frame cut below min_matches
    (coast) and on one whose first chi2 round stops the re-solves; timed on
    the run's median frame. Returns the kernel's row of the kernels line."""
    from superslam_tpu_torch.ops import pose_solver
    from superslam_tpu_torch.ops.cuda import pose_solve as pose_solve_mod
    from superslam_tpu_torch.ops.cuda.pose_solve import pose_solve, pose_solve_plain

    if not captured:
        fail("pose_solve: the default phase captured no call")
    cases = [(f"frame {i}", a, kw) for i, (a, kw) in enumerate(captured)]
    a0, kw0 = captured[len(captured) // 2]
    # The chi2-stop case keeps min_matches + 4 usable matches (so the floor
    # does not force the stop) and moves the keypoints by 4 px (so the first
    # round's inliers fall below it).
    chi2 = cut_matches(a0, kw0["min_matches"] + 4, usable=pose_solve_plain(*a0, **kw0)[3])
    g = torch.Generator(device="cpu").manual_seed(0)
    chi2[4] = chi2[4] + (4.0 * torch.randn(chi2[4].shape, generator=g)).to(chi2[4].device)
    cases += [("coast", cut_matches(a0, 6), kw0), ("chi2 stop", chi2, kw0)]
    worst = 0.0
    for label, args, kw in cases:
        got = pose_solve(*args, **kw)
        solves = []
        lm = pose_solve_mod.pose_only_lm_impl
        pose_solve_mod.pose_only_lm_impl = lambda *a, **k: solves.append(1) or lm(*a, **k)
        try:
            ref = pose_solve_plain(*args, **kw)
        finally:
            pose_solve_mod.pose_only_lm_impl = lm
        torch.cuda.synchronize()
        dR = (got[0] - ref[0]).abs().max().item()
        dt = (got[1] - ref[1]).abs().max().item()
        n, n_ref, kept, kept_ref = int(got[2]), int(ref[2]), int(got[4]), int(ref[4])
        worst = max(worst, dR, dt)
        if label in ("coast", "chi2 stop") or label == cases[0][0]:
            print(f"kernel pose_solve: {label}: n {n} (plain {n_ref}), kept {kept} (plain "
                  f"{kept_ref}), LM solves {len(solves)}, |dR| {dR:.3g}, |dt| {dt:.3g} m")
        if label == "coast" and not n < kw["min_matches"]:
            fail(f"pose_solve: the coast case has {n} usable matches")
        if label == "chi2 stop" and n_ref < kw["min_matches"]:
            fail(f"pose_solve: the chi2 case has {n_ref} usable matches: the floor stops it")
        if label == "chi2 stop" and len(solves) != 1:
            fail(f"pose_solve: the chi2 case ran {len(solves)} solves: no early stop")
        if not (dR <= POSE_ATOL and dt <= POSE_ATOL and n == n_ref
                and torch.equal(got[3], ref[3]) and abs(kept - kept_ref) <= max(1, n_ref // 100)):
            fail(f"pose_solve: {label}: |dR| {dR}, |dt| {dt}, n {n}/{n_ref}, kept "
                 f"{kept}/{kept_ref}, ok equal {torch.equal(got[3], ref[3])}")
    print(f"kernel pose_solve: {len(cases)} cases, largest |dR|, |dt| {worst:.3g} (limit "
          f"{POSE_ATOL}); n and ok exact, kept within 1% of n")

    # What this frame's solve needs: the plain version's LM iterations.
    iters = []
    system = pose_solver._system

    def counting(*a, **k):
        iters.append(1)
        return system(*a, **k)

    pose_solver._system = counting
    try:
        pose_solve_plain(*a0, **kw0)
    finally:
        pose_solver._system = system
    k = a0[4].shape[0]
    rounds = 1 + (1 if kw0["gate_px"] > 0 else 0) + kw0["chi2_rounds"]
    ops = float(k) * (POSE_OPS_ITER * len(iters) + POSE_OPS_REPROJ * rounds)
    io = nbytes(*a0) + 12 * 4 + 2 * 4 + k + k * 2 * 4
    ms = time_ms(torch, lambda: pose_solve(*a0, **kw0))
    plain_ms = time_ms(torch, lambda: pose_solve_plain(*a0, **kw0))
    bnd = bound(io, f32_ops=ops)
    print(f"kernel pose_solve: K {k}, {len(iters)} LM iterations on the timed frame; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound {bnd[0]:.6f} ms "
          f"({bnd[1]}: {io} B, {ops:.3g} f32 operations)")
    return {
        "name": "pose_solve", "route": "cuda", "source": KERNEL_INFO["pose_solve"][0],
        "replaces": KERNEL_INFO["pose_solve"][1], "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
    }


def solve_call(call):
    """A captured track_frame call as the pose_solve call of its solve: the
    prediction from the carry, the match the frame used."""
    (carry, frame, tm, state), kw = call
    R_prev, t_prev, Rr, tr = carry
    kl, _nkl, _dl, _vl, disp, sok = frame
    if kw.get("rematch") is not None and kw.get("fresh") is not None:
        import torch

        tm = torch.where(kw["fresh"], tm, kw["rematch"])
    solve_kw = {k: v for k, v in kw.items() if k not in ("keyframes", "rematch", "fresh")}
    args = [R_prev, t_prev, R_prev @ Rr, R_prev @ tr + t_prev, kl, disp, sok, tm, state[3],
            state[4]]
    return args, solve_kw


def frame_case(call, *, since=None, t_nan=False, support_px=None, cut=None, usable=None,
               noise_px=0.0, scan=False):
    """A captured track_frame call changed into a constructed case: the match
    the frame used as its only match vector; since set (promotion); a NaN in
    the previous position (a non-finite solve); another support_px (support
    below the floor); the first ``cut`` matched features kept (from the
    usable mask ``usable`` when given) and the keypoints moved by noise_px
    (coast, chi2 stop); scan: track_scan's epilogue."""
    import torch

    (carry, frame, tm, state), kw = clone_tree(call)
    solve_args, solve_kw = solve_call(((carry, frame, tm, state), kw))
    tm = solve_args[7]
    kw = dict(solve_kw, keyframes=None if scan else dict(kw["keyframes"]))
    if since is not None:
        state = (*state[:5], torch.full_like(state[5], since))
    if t_nan:
        carry = (carry[0], carry[1].clone(), *carry[2:])
        carry[1][0] = float("nan")
    if support_px is not None:
        kw["keyframes"]["support_px"] = support_px
    if cut is not None:
        keep = ((tm >= 0) if usable is None else usable).nonzero().flatten()[:cut]
        cut_tm = tm.new_full(tm.shape, -1)
        cut_tm[keep] = tm[keep]
        tm = cut_tm
    if noise_px:
        g = torch.Generator(device="cpu").manual_seed(0)
        kl = frame[0] + (noise_px * torch.randn(frame[0].shape, generator=g)).to(frame[0].device)
        frame = (kl, *frame[1:])
    return (carry, frame, tm, state), kw


def _gap(a, b) -> float:
    """max |a - b|, NaN where both are NaN counting 0, elsewhere inf."""
    d = (a - b).abs().masked_fill(a.isnan() & b.isnan(), 0.0)
    return float("inf") if bool(d.isnan().any()) else float(d.max())


def check_track_frame(torch, captured):
    """track_frame against its plain twin (both on the card) in both
    epilogues on every frame of the default phase's window, and on a
    promotion, a non-finite solve, a support below the floor, a coast and a
    chi2 stop made from the median frame. The raw solve and the poses within
    POSE_ATOL of the full twin; on the kernel's own raw solve the twin's
    epilogue gives exactly its n, support, accept, promo, since, fresh bit,
    match used, valid, depth_ok, nk and desc, its xw within XW_RTOL of |xw|
    and its poses within EPILOGUE_ATOL. Timed on the median frame (and its
    scan epilogue and its promotion) beside the twin and the bound. Returns
    the kernel's row of the kernels line."""
    from superslam_tpu_torch.ops import pose_solver
    from superslam_tpu_torch.ops.cuda.pose_solve import pose_solve_plain
    from superslam_tpu_torch.ops.cuda.track_frame import (
        track_frame,
        track_frame_epilogue_plain,
        track_frame_plain,
    )

    if not captured:
        fail("track_frame: the default phase captured no call")
    mid = captured[len(captured) // 2]
    kw0 = mid[1]
    mm = kw0["min_matches"]
    usable = pose_solve_plain(*solve_call(mid)[0], **solve_call(mid)[1])[3]
    cases = [(f"frame {i}", a, kw) for i, (a, kw) in enumerate(captured)]
    cases += [(f"frame {i} (scan)", *frame_case(c, scan=True)) for i, c in enumerate(captured)]
    cases += [
        ("promotion", *frame_case(mid, since=kw0["keyframes"]["kf_max_frames"])),
        ("non-finite", *frame_case(mid, t_nan=True)),
        ("support", *frame_case(mid, support_px=0.05)),
        ("coast", *frame_case(mid, cut=6)),
        ("chi2 stop", *frame_case(mid, cut=mm + 4, usable=usable, noise_px=4.0)),
    ]
    worst, worst_epi, worst_xw, promos = 0.0, 0.0, 0.0, 0
    for label, args, kw in cases:
        got = track_frame(*args, **kw)
        ref = track_frame_plain(*args, **kw)
        row, used, pose, state, fresh, raw = got
        on_raw = track_frame_epilogue_plain(
            raw, *args, calib=kw["calib"], min_matches=mm, keyframes=kw["keyframes"],
            rematch=kw.get("rematch"), fresh=kw.get("fresh"))
        torch.cuda.synchronize()
        gap = max(_gap(raw[0], ref[5][0]), _gap(raw[1], ref[5][1]), _gap(row[:12], ref[0][:12]))
        epi = max([_gap(row[:12], on_raw[0][:12])]
                  + [_gap(a, b) for a, b in zip(pose, on_raw[2])])
        n, n_ref, kept, kept_ref = int(raw[2]), int(ref[5][2]), int(raw[3]), int(ref[5][3])
        bad = []
        if not (gap <= POSE_ATOL and n == n_ref and abs(kept - kept_ref) <= max(1, n_ref // 100)):
            bad.append(f"solve |d| {gap}, n {n}/{n_ref}, kept {kept}/{kept_ref}")
        if not torch.equal(row[12:], on_raw[0][12:]) or not torch.equal(used, on_raw[1]):
            bad.append(f"row {row[12:].tolist()} vs {on_raw[0][12:].tolist()}, matches "
                       f"equal {torch.equal(used, on_raw[1])}")
        if not epi <= EPILOGUE_ATOL:
            bad.append(f"epilogue poses |d| {epi}")
        if kw["keyframes"] is not None:
            for name, i in (("nk", 0), ("desc", 1), ("valid", 2), ("depth_ok", 4), ("since", 5)):
                if state[i].dtype != on_raw[3][i].dtype or not torch.equal(state[i], on_raw[3][i]):
                    bad.append(f"{name} differs")
            xw, xw_ref = state[3], on_raw[3][3]
            rel = float(((xw - xw_ref).abs().amax(1) / xw_ref.norm(dim=1).clamp(min=1.0)).max())
            worst_xw = max(worst_xw, rel)
            if not rel <= XW_RTOL:
                bad.append(f"xw relative {rel}")
            if bool(fresh) != bool(on_raw[4]):
                bad.append("fresh bit differs")
            promos += int(row[15] > 0.5)
        if bad:
            fail(f"track_frame: {label}: " + "; ".join(bad))
        worst, worst_epi = max(worst, gap), max(worst_epi, epi)
        if not label.startswith("frame") or label in ("frame 0", "frame 0 (scan)"):
            print(f"kernel track_frame: {label}: n {n}, kept {kept} (plain {kept_ref}), row "
                  f"{[round(v, 4) for v in row[12:].tolist()]}, |d| {gap:.3g} m")
        checks = {
            "promotion": lambda: row[15] == 1,
            "non-finite": lambda: row[14] == 0 and not bool(raw[1].isfinite().all()),
            "support": lambda: row[14] == 0 and n >= mm,
            "coast": lambda: n < mm and row[14] == 0,
            "chi2 stop": lambda: n_ref >= mm,
        }
        if label in checks and not checks[label]():
            fail(f"track_frame: the {label} case is not one: row {row.tolist()}, n {n}")
    print(f"kernel track_frame: {len(cases)} cases ({promos} promoted), largest |dR|, |dt| "
          f"{worst:.3g} against the twin (limit {POSE_ATOL}); on the kernel's own solve the "
          f"twin's epilogue: counts, bits, matches and copied keyframe arrays exact, poses "
          f"{worst_epi:.3g} (limit {EPILOGUE_ATOL}), xw {worst_xw:.3g} of |xw| (limit {XW_RTOL})")

    # What the median frame's work needs: its LM iterations, the gate, the
    # chi2 rounds and the support count; its state's one source and copy.
    iters = []
    system = pose_solver._system

    def counting(*a, **k):
        iters.append(1)
        return system(*a, **k)

    pose_solver._system = counting
    try:
        track_frame_plain(*mid[0], **mid[1])
    finally:
        pose_solver._system = system
    (carry, frame, tm, state), kw = mid
    k = frame[0].shape[0]
    rounds = 2 + (1 if kw["gate_px"] > 0 else 0) + kw["chi2_rounds"]
    ops = float(k) * (POSE_OPS_ITER * len(iters) + POSE_OPS_REPROJ * rounds)
    desc = state[1].numel() * state[1].element_size()
    solve_in = nbytes(*carry, frame[0], frame[4], frame[5], tm, state[3], state[4])
    state_io = 2 * (desc + k * (2 * 4 + 1 + 3 * 4 + 1))  # one source read, the new state written
    io = solve_in + state_io + 16 * 4 + k * 4 + 36 * 4 + 3 * 4
    ms = time_ms(torch, lambda: track_frame(*mid[0], **mid[1]))
    plain_ms = time_ms(torch, lambda: track_frame_plain(*mid[0], **mid[1]))
    scan_args, scan_kw = frame_case(mid, scan=True)
    promo_args, promo_kw = frame_case(mid, since=kw0["keyframes"]["kf_max_frames"])
    scan_ms = time_ms(torch, lambda: track_frame(*scan_args, **scan_kw))
    promo_ms = time_ms(torch, lambda: track_frame(*promo_args, **promo_kw))
    bnd = bound(io, f32_ops=ops)
    print(f"kernel track_frame: K {k}, {len(iters)} LM iterations on the timed frame; kernel "
          f"{ms:.4f} ms (track_scan's epilogue, one block, no copy: {scan_ms:.4f} ms; a "
          f"promoting frame {promo_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, bound "
          f"{bnd[0]:.6f} ms ({bnd[1]}: {io} B, {ops:.3g} f32 operations)")
    return {
        "name": "track_frame", "route": "cuda", "source": KERNEL_INFO["track_frame"][0],
        "replaces": KERNEL_INFO["track_frame"][1], "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
    }


MARKERS = 16  # check_scan_body's marker negations
PROFILE_TRIES = 3  # its sessions until one records a marker
# Host time a session's warm-up step waits after tracing starts: sessions on
# the H100 have recorded the body's kernel but none of the markers launched
# just before it (the first device events of a session are lost while
# tracing starts).
PROFILE_SETTLE_S = 0.05


def check_scan_body(torch, scan_call) -> None:
    """One of the default window's track_kf_scan calls again under
    torch.profiler: its device events must be the track_frame kernel alone,
    one a frame (no PyTorch op of the old Python body is left). MARKERS
    one-element negations open the window: the profiler may drop the first
    device events of a session (a profile holding only the kernel once
    recorded nothing), so at least one and at most MARKERS negations must
    be recorded, which shows that what was dropped came before the body,
    and every other event must be a track_frame kernel, n of them; the
    scan body negates nothing. A discarded session warms the profiler
    first, and each session opens with a warm-up step (torch.profiler's
    schedule: tracing on, its events discarded; one marker and
    PROFILE_SETTLE_S of host time) before the recorded step. A session that
    records no device event at all, or none of the markers (both seen now
    and then on the H100; after the warm-up step 2-3 of 8 markers were
    still lost), cannot show that: it is run again, up to PROFILE_TRIES
    times, and the checks apply to the first that records a marker (or to
    the last session)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from superslam_tpu_torch.ops import frontend_step

    a, kw = scan_call
    n = a[1].shape[0]
    frontend_step.track_kf_scan(*a, **kw)
    torch.cuda.synchronize()
    marker = torch.zeros(1, device=a[1].device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        marker.neg_()
        torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            time.sleep(PROFILE_SETTLE_S)
            marker.neg_()
            torch.cuda.synchronize()
            prof.step()  # the warm-up step ends: what follows is recorded
            for _ in range(MARKERS):
                marker.neg_()
            frontend_step.track_kf_scan(*a, **kw)
            torch.cuda.synchronize()
            prof.step()
        # Device-side events, less the schedule's own span of the step
        # (ProfilerStep#1, which the profiler also puts on the device).
        rows = [e for e in prof.key_averages()
                if device_us(e) > 0 and "CPU" not in str(getattr(e, "device_type", "CPU"))
                and not e.key.startswith("ProfilerStep")]
        if any("neg" in e.key for e in rows):
            break
        print(f"scan body: session {attempt} of {PROFILE_TRIES} recorded no marker "
              f"(device events {[e.key[:40] for e in rows]})")
    events = {e.key: e.count for e in rows}
    print(f"scan body: {n} frame(s) of track_kf_scan after {MARKERS} marker negations: device "
          f"events {events}")
    markers = sum(e.count for e in rows if "neg" in e.key)
    body = [e for e in rows if "neg" not in e.key]
    for e in rows:
        print(f"scan body: {e.key[:60]}: {device_us(e) / 1e3 / e.count:.4f} ms of device time a "
              f"call" + (" (the one-element marker: a launch's floor on this card)"
                         if "neg" in e.key else ""))
    if not 1 <= markers <= MARKERS:
        fail(f"track_kf_scan profile: {markers} negation kernels recorded, want 1 to {MARKERS} "
             f"of the markers: {events}")
    if len(body) != 1 or "track_frame_kernel" not in body[0].key or body[0].count != n:
        fail(f"track_kf_scan: device events other than one track_frame kernel a frame: {events}")


def profile_solve_kernels(torch, call, n: int = 10) -> None:
    """Device time a call of the per-frame kernels on one captured frame,
    each run n times under torch.profiler: the solve alone (pose_solve),
    the whole body (track_frame), its track_scan epilogue (one block, no
    copy) and the same frame promoting (the copy from the frame)."""
    from torch.profiler import ProfilerActivity, profile

    from superslam_tpu_torch.ops.cuda.pose_solve import pose_solve
    from superslam_tpu_torch.ops.cuda.track_frame import track_frame

    solve_args, solve_kw = solve_call(call)
    scan_args, scan_kw = frame_case(call, scan=True)
    promo_args, promo_kw = frame_case(call, since=call[1]["keyframes"]["kf_max_frames"])
    for label, name, fn in (
        ("pose_solve", "pose_solve_kernel", lambda: pose_solve(*solve_args, **solve_kw)),
        ("track_frame", "track_frame_kernel", lambda: track_frame(*call[0], **call[1])),
        ("track_frame, track_scan's epilogue", "track_frame_kernel",
         lambda: track_frame(*scan_args, **scan_kw)),
        ("track_frame, promoting", "track_frame_kernel",
         lambda: track_frame(*promo_args, **promo_kw)),
    ):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if name in e.key and device_us(e) > 0]
        calls = sum(e.count for e in rows)
        us = sum(device_us(e) for e in rows)
        print(f"profile: {label} on the median frame: {us / 1e3 / max(calls, 1):.4f} ms of device "
              f"time a call ({calls} calls)")


def time_design_costs(torch, slam, captured) -> None:
    """The cost the sync-free design leaves at batch > 1: the re-match that
    each frame after the first of a dispatch runs, at the main path's
    shapes on a captured frame and keyframe.
    Device ms by CUDA events, host ms as the enqueue time of 20 calls."""
    from superslam_tpu_torch.models.lightglue import extract_matches, lightglue_forward
    from superslam_tpu_torch.ops.cuda import _build

    (_carry, frame, _tm, state), _kw = captured[len(captured) // 2]
    _kl, nkl, dl, vl = frame[:4]
    nk, desc, valid = state[:3]

    def rematch():
        la = lightglue_forward(slam.pipeline.lg_params, nk[None], desc[None], nkl[None],
                               dl[None], valid[None], vl[None])
        return extract_matches(la, valid[None], vl[None], 0.1)[0][0]

    with torch.no_grad():
        rematch()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        rematch()
        torch.cuda.synchronize()
        launched = {n: c for n, c in _build.launch_counts().items() if c}
        device_ms = time_ms(torch, rematch)
        t0 = time.perf_counter()
        for _ in range(20):
            rematch()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    print(f"design cost: re-match (each frame after the first of a dispatch, batch > 1): "
          f"device {device_ms:.4f} ms, host {host_ms:.4f} ms a call, kernels {launched}")


def run_accuracy_legs(torch) -> None:
    """The 150-frame rendered circuit through scripts/accuracy_suite_torch.py:
    stereo, stereo_sync, stereo_devkf, stereo_loop (with at least one loop
    closure) and rgbd each at ATE <= 1.5 x its reference leg; the other legs
    printed. Writes ACCURACY_TORCH.json."""
    from scripts import accuracy_suite_torch as acc

    suite = acc.run_suite(ACCURACY_LEGS, acc.FRAMES, "cuda", log=lambda _m: None)
    for row in suite["legs"]:
        limit = "printed only" if row["limit_m"] is None else f"limit {row['limit_m']:.4f} m"
        extra = (f", loop closures {row['loop_closures']}" if row["loop_enabled"] else "") + (
            f", {row['gap_to_rgbd_m']:+.4f} m against rgbd" if "gap_to_rgbd_m" in row else "")
        print(f"accuracy {row['leg']}: ATE {row['ate_rmse_m']:.4f} m (reference "
              f"{row['reference_ate_m']} m; {limit}), mode {row['mode']}, {row['frames']} frames "
              f"in {row['wall_s']:.2f} s ({row['fps']:.2f} fps sustained over frames 1..), "
              f"keyframes {row['keyframes']}, host pose solves {row['host_solves']}{extra}")
    print(f"accuracy: host core {suite['host_core']}")
    with open(os.path.join(REPO, "ACCURACY_TORCH.json"), "w") as f:
        json.dump(suite, f, indent=2)
        f.write("\n")
    missed = [r["leg"] for r in suite["legs"] if not r["passed"]]
    if missed:
        fail(f"accuracy legs over their limit: {missed}")


# -- RGB-D and loop closure ----------------------------------------------------------


def render_rgbd_sequence(n: int, seed: int = 0):
    """The bench circuit's room and lap (render_sequence's, unscaled: at
    TUM1's fx the scaled room would put most depth past uint16's 13.1 m)
    seen by an RGB-D camera at TUM1's intrinsics, gray uint8 round(x * 255)
    and depth uint16 clip(Z * 5000), as write_tum_sequence writes them."""
    from superslam_tpu_torch.eval.synthetic_sequence import (
        circuit_trajectory,
        make_room_world,
        render_view,
    )
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

    world = make_room_world(np.random.default_rng(seed), n_sprites=420)
    calib = StereoCalib(fx=TUM_FX, fy=TUM_FY, cx=TUM_CX, cy=TUM_CY, baseline=TUM_BF / TUM_FX)
    poses = circuit_trajectory(CIRCUIT_FRAMES, laps=1.0)[:n]
    rng = np.random.default_rng(seed + 1)
    frames = []
    for p in poses:
        img, depth = render_view(world, p, calib, TUM_H, TUM_W, rng, return_depth=True)
        frames.append((np.round(img * 255).astype(np.uint8),
                       np.clip(depth * DEPTH_FACTOR, 0, 65535).astype(np.uint16)))
    return frames, poses


RGBD_CONFIG = """\
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: {k1}
Camera.k2: {k2}
Camera.p1: {p1}
Camera.p2: {p2}
Camera.k3: {k3}
Camera.bf: {bf}
Camera.width: {width}
Camera.height: {height}
ThDepth: 40.0
DepthMapFactor: {depth_factor}
SuperPoint.model_dir: "{weights}"
superpoint:
  max_keypoints: {max_kp}
  keypoint_threshold: {threshold}
  remove_borders: 4
  weights_file: superpoint_render.safetensors
lightglue:
  image_width: {width}
  image_height: {height}
  weights_file: lightglue_synth.safetensors
Backend.window_size: 8
KeyFrame.covis_ratio: 0.7
KeyFrame.max_frames: 20
"""


def build_rgbd_slam(dist=(0.0,) * 5):
    """The port's facade on TUM1's geometry (configs/TUM1.yaml's intrinsics,
    640x480, 1000 keypoints, DepthMapFactor 5000, ThDepth 40; ``dist`` its
    k1, k2, p1, p2, k3, zero by default) with the rendered scene's virtual
    baseline (TUM_BF) and the committed render checkpoints, the env as it
    stands."""
    from superslam_tpu_torch.slam import SuperSLAM

    k1, k2, p1, p2, k3 = dist
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "tum1_render.yaml")
        with open(cfg, "w") as f:
            f.write(RGBD_CONFIG.format(
                fx=TUM_FX, fy=TUM_FY, cx=TUM_CX, cy=TUM_CY, k1=k1, k2=k2, p1=p1, p2=p2, k3=k3,
                bf=TUM_BF, width=TUM_W, height=TUM_H, depth_factor=DEPTH_FACTOR,
                weights=os.path.join(REPO, "weights") + os.sep, max_kp=TUM_KP,
                threshold=KP_THRESHOLD))
        return SuperSLAM(cfg)


def count_host_solves(slam) -> list:
    """A list that grows by one with each pose solve of the host estimator."""
    solves = []
    solve = slam.estimator.tracker.track_arrays
    slam.estimator.tracker.track_arrays = lambda *a, **k: solves.append(1) or solve(*a, **k)
    return solves


def run_rgbd_facade(torch, frames, gt, label: str):
    """The RGB-D facade with the env as it stands over the rendered frames.
    Over frames STEADY_FROM.. the launch counts are read (reset before frame
    STEADY_FROM is submitted, read before the flush), the frames that drain
    through the host re-match path are counted with the matcher launches
    they add, and each track_frame call is kept; a pipelined tracker's
    dispatches (and uploads) run under set_sync_debug_mode("error").
    Holds the launches a frame to 1/1/1/9/9 and track_frame 1 (device
    tracking) or 0, and the ATE to ATE_LIMIT_M. Returns (the facade, the
    captured track_frame calls)."""
    from superslam_tpu_torch.eval.metrics import ate
    from superslam_tpu_torch.ops import frontend_step
    from superslam_tpu_torch.ops.cuda import _build

    slam = build_rgbd_slam()
    tracker = slam._tracker
    device = bool(tracker and tracker.device_tracking)
    print(f"rgbd facade ({label}): mode {facade_mode(slam)}")
    window, restore = instrument_window(torch, tracker, slam.rgbd_pipeline, slam.matcher,
                                        slam.estimator)
    captured = []
    body = frontend_step.track_frame

    def capturing_body(*a, **kw):
        if window["on"]:
            a = (clone_carry(a[0]), *clone_tree(a[1:]))
            captured.append((a, clone_tree({k: v for k, v in kw.items() if k != "out"})))
        return body(*a, **kw)

    frontend_step.track_frame = capturing_body
    solves = count_host_solves(slam)
    estimator_ms()
    try:
        t1 = None
        for i, (gray, depth) in enumerate(frames):
            if i == STEADY_FROM:
                _build.reset_launch_counts()
                window["on"] = True
            Tcw = slam.track_rgbd(gray, depth, i / RGBD_FPS)
            if Tcw.shape != (4, 4) or not np.isfinite(Tcw).all():
                fail(f"rgbd facade ({label}): frame {i}: pose {Tcw}")
            if i == 0:
                t1 = time.perf_counter()
        window["on"] = False
        counts = _build.launch_counts()
        slam.flush()
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t1
    finally:
        frontend_step.track_frame = body
        restore()
    est_ms = estimator_ms()
    res = ate(slam.estimator.corrected_trajectory(), gt)
    n, steady = len(frames), len(frames) - STEADY_FROM
    sync = ("no synchronizing call in the dispatches under set_sync_debug_mode('error'); "
            if tracker is not None else "")
    print(f"rgbd facade ({label}): {n} frames {TUM_W}x{TUM_H}, K {TUM_KP}, {(n - 1) / loop_s:.2f} "
          f"fps over frames 1..{n - 1} (wall clock, flush included), ATE {res.rmse:.4f} m, "
          f"keyframes {len(slam.estimator.anchors())}, host estimator {est_ms[0]:.3f} ms a frame "
          f"({est_ms[1]} frames), host pose solves {len(solves)} in {n} frames")
    print(f"rgbd facade ({label}): frames {STEADY_FROM}..{n - 1}: {sync}frames drained through "
          f"the host re-match path {len(window['rematch_frames'])}: {window['rematch_frames']} "
          f"(their matcher launches {dict((k, v) for k, v in window['rematch'].items() if v)}); "
          f"launches {counts}")
    for k, per in {**PER_FRAME_FUSED, "track_frame": int(device)}.items():
        got = counts[k] - window["rematch"][k]
        print(f"rgbd facade ({label}): {k}: {got / steady:g} launches a frame over {steady} "
              "frames")
        if got != per * steady:
            fail(f"rgbd facade ({label}): {k}: {got} launches in {steady} frames, want {per} a "
                 "frame")
    if not np.isfinite(res.rmse) or res.rmse > ATE_LIMIT_M:
        fail(f"rgbd facade ({label}): ATE {res.rmse} m > {ATE_LIMIT_M} m")
    return slam, captured


def check_track_frame_mono(torch, captured) -> None:
    """track_frame in track_scan's epilogue with mono set (the RGB-D step's
    body) at K = TUM_KP on every captured frame of the device-tracked RGB-D
    run. Its raw solve is held to the plain twin run in f64 on the same
    inputs: n exact, the pose and the kept count within the frame's
    measured allowance (MONO_PERMS, MONO_SPREAD: what the f32 summation
    order alone does to the twin on that frame). The same permutations
    through the kernel (pose_solve, the same solve) are printed beside
    them. On the kernel's own raw solve the twin's epilogue gives its row's
    count exactly and its poses within EPILOGUE_ATOL."""
    from superslam_tpu_torch.ops.cuda.pose_solve import pose_solve, pose_solve_plain
    from superslam_tpu_torch.ops.cuda.track_frame import (
        track_frame,
        track_frame_epilogue_plain,
        track_frame_plain,
    )

    def permuted(args, perm):
        # Keyframe feature i -> perm[i]: the match, world point and depth
        # flag move together; the frame's arrays stay.
        return [*args[:7], args[7][perm], args[8][perm], args[9][perm]]

    def spread(outs, ref):
        pose = max(max(_gap(o[0].double(), ref[0]), _gap(o[1].double(), ref[1])) for o in outs)
        return pose, max(abs(int(o[4]) - int(ref[4])) for o in outs)

    if not captured:
        fail("track_frame (mono): the device-tracked RGB-D run captured no call")
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst, worst_epi, coasts, wide, bad = 0.0, 0.0, 0, [], []
    for i, (args, kw) in enumerate(captured):
        if not (kw["mono"] and kw.get("keyframes") is None and args[1][0].shape[0] == TUM_KP):
            fail(f"track_frame (mono): frame {i} is not a mono scan frame at K {TUM_KP}")
        row, _used, pose, _state, _fresh, raw = track_frame(*args, **kw)
        solve_args, solve_kw = solve_call((args, kw))
        ref = pose_solve_plain(*[t.double() if t.dtype == torch.float32 else t
                                 for t in solve_args], **solve_kw)
        perms = [torch.arange(TUM_KP, device=solve_args[7].device)] + [
            torch.randperm(TUM_KP, generator=gen).to(solve_args[7].device)
            for _ in range(MONO_PERMS)]
        twins = [pose_solve_plain(*permuted(solve_args, p), **solve_kw) for p in perms]
        kernels = [pose_solve(*permuted(solve_args, p), **solve_kw) for p in perms]
        on_raw = track_frame_epilogue_plain(raw, *args, calib=kw["calib"],
                                            min_matches=kw["min_matches"])
        torch.cuda.synchronize()
        gap = max(_gap(raw[0].double(), ref[0]), _gap(raw[1].double(), ref[1]))
        twin_pose, twin_kept = spread(twins, ref)
        kern_pose, kern_kept = spread(kernels, ref)
        epi = max([_gap(row[:12], on_raw[0][:12])] + [_gap(a, b) for a, b in zip(pose, on_raw[2])])
        n, n_ref, kept, kept_ref = int(raw[2]), int(ref[2]), int(raw[3]), int(ref[4])
        pose_lim = POSE_ATOL + MONO_SPREAD * twin_pose
        kept_lim = max(1, n_ref // 100) + MONO_SPREAD * twin_kept
        if twin_pose > POSE_ATOL or twin_kept > max(1, n_ref // 100):
            wide.append(i)
        print(f"kernel track_frame (mono, K {TUM_KP}): frame {i}: n {n}/{n_ref}, kept "
              f"{kept}/{kept_ref}, |d| {gap:.3g} from the f64 twin (limit {pose_lim:.3g}, "
              f"kept limit {kept_lim:g}); over {len(perms)} orders the f32 twin lies up to "
              f"{twin_pose:.3g} and {twin_kept} kept from it, the kernel up to {kern_pose:.3g} "
              f"and {kern_kept}; epilogue |d| {epi:.3g}")
        if not (gap <= pose_lim and n == n_ref and abs(kept - kept_ref) <= kept_lim
                and torch.equal(row[12:], on_raw[0][12:]) and epi <= EPILOGUE_ATOL):
            bad.append(f"frame {i}: |d| {gap} (limit {pose_lim}), n {n}/{n_ref}, kept "
                       f"{kept}/{kept_ref} (limit {kept_lim}), row {row[12:].tolist()} vs "
                       f"{on_raw[0][12:].tolist()}, epilogue |d| {epi}")
        worst, worst_epi = max(worst, gap), max(worst_epi, epi)
        coasts += n < kw["min_matches"]
    if bad:
        fail("track_frame (mono): " + "; ".join(bad))
    print(f"kernel track_frame (mono, track_scan's epilogue, K {TUM_KP}): {len(captured)} frames "
          f"of the device-tracked RGB-D run ({coasts} coast), largest |dR|, |dt| {worst:.3g} "
          f"from the twin in f64; frames where the summation order moves the f32 twin by more "
          f"than {POSE_ATOL} or 1% of n in kept: {len(wide)} {wide}; on the kernel's own solve "
          f"the twin's epilogue: counts exact, poses {worst_epi:.3g} (limit {EPILOGUE_ATOL})")
    mid = captured[len(captured) // 2]
    print(f"kernel track_frame (mono, K {TUM_KP}): kernel "
          f"{time_ms(torch, lambda: track_frame(*mid[0], **mid[1])):.4f} ms, plain "
          f"{time_ms(torch, lambda: track_frame_plain(*mid[0], **mid[1])):.4f} ms on the median "
          "frame")


def check_rgbd_kernels(torch, sp_params, lg_params, gray) -> None:
    """The RGB-D step's kernels at its shapes, batch 1 at 480x640 and
    K = TUM_KP (the stereo checks run batch 2 at 384x1248 and K 600), on a
    rendered TUM-geometry frame, with the stereo checks' limits: the conv
    pairs within 2e-2 of max |plain|, the logits mode's pre-NMS map within
    1e-6 and its NMS'd map exactly nms_plain of it, the fused blocks within
    2e-2 of max |plain| in bf16 and 1e-3 in f32 over one pair problem
    (2 rows of K) with a ragged keyframe side."""
    from superslam_tpu_torch.models.superpoint import _encoder_and_heads, prepare_superpoint_params
    from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl
    from superslam_tpu_torch.ops.cuda.conv import conv_pair_pool, conv_pair_pool_plain
    from superslam_tpu_torch.ops.cuda.nms import nms_plain, scores_nms, scores_nms_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    x = torch.from_numpy(gray.astype(np.float32) / 255.0).to(dev)[None, None]
    for name, pre, shape in (("conv1a1b", ("conv1a", "conv1b"), (1, 64, TUM_H // 2, TUM_W // 2)),
                             ("conv_pair", ("conv2a", "conv2b"), (1, 64, TUM_H // 4, TUM_W // 4))):
        w = [sp_params[f"{p}.{kind}"] for p in pre for kind in ("weight", "bias")]
        got, ref = conv_pair_pool(x, *w), conv_pair_pool_plain(x, *w)
        torch.cuda.synchronize()
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        print(f"kernel {name} (RGB-D shape {tuple(x.shape)}): max error / max |plain| = {rel:.3g} "
              f"(limit 2e-2), kernel {time_ms(torch, lambda: conv_pair_pool(x, *w)):.4f} ms")
        if got.shape != shape or not rel <= 2e-2:
            fail(f"{name} at the RGB-D shape: {tuple(got.shape)}, relative error {rel}")
        x = got
    with torch.no_grad():
        img = torch.from_numpy(gray.astype(np.float32) / 255.0).to(dev)[None]
        logits, _ = _encoder_and_heads(prepare_superpoint_params(sp_params, dev), img,
                                       torch.bfloat16)
    random_logits = torch.from_numpy(
        (rng.standard_normal(tuple(logits.shape)) * 4).astype(np.float32)).to(dev)
    for label, lg_in in (("random logits", random_logits.contiguous(
            memory_format=torch.channels_last)), ("the frame's logits", logits)):
        out, pre = scores_nms(lg_in, 4, return_pre=True)
        _, ref_pre = scores_nms_plain(lg_in, 4, return_pre=True)
        torch.cuda.synchronize()
        err = (pre - ref_pre).abs().max().item()
        exact = torch.equal(out, nms_plain(pre, 4))
        print(f"kernel scores_nms (RGB-D shape {tuple(lg_in.shape)}, {label}): pre-NMS map max "
              f"abs error {err:.3g} (limit 1e-6), NMS'd map == nms_plain(pre) {exact}")
        if out.shape != (1, TUM_H, TUM_W) or not (err <= 1e-6 and exact):
            fail(f"scores_nms at the RGB-D shape ({label}): error {err}, exact {exact}")
    k = TUM_KP
    x32 = torch.from_numpy(rng.standard_normal((2, k, 256)).astype(np.float32)).to(dev)
    kpts = torch.from_numpy(rng.uniform(-1, 1, (2, k, 2)).astype(np.float32)).to(dev)
    proj = kpts @ lg_params["posenc.Wr.weight"].float().t()
    cos, sin = torch.cos(proj), torch.sin(proj)
    mask = torch.ones((2, k), dtype=torch.bool, device=dev)
    mask[0, int(0.7 * k):] = False  # the keyframe's valid prefix
    for name in ("fused_self_block", "fused_cross_block"):
        is_self = name == "fused_self_block"
        prefix = "transformers.0." + ("self_attn" if is_self else "cross_attn")
        prep = lgl.prep_self_weights if is_self else lgl.prep_cross_weights
        rotary = (cos, sin) if is_self else ()

        def call(fn, dtype):
            xd, w = x32.to(dtype), prep(lg_params, prefix, dtype)
            return lambda: fn(xd, *rotary, mask, w)

        for dtype, limit in ((torch.bfloat16, 2e-2), (torch.float32, 1e-3)):
            got = call(getattr(lgl, name), dtype)()
            ref = call(getattr(lgl, name + "_plain"), dtype)()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            if dtype == torch.bfloat16:
                err /= max(ref.float().abs().max().item(), 1e-12)
            what = "max error / max |plain|" if dtype == torch.bfloat16 else "max abs error"
            print(f"kernel {name} (RGB-D shape (2, {k}, 256) {str(dtype)[6:]}): {what} "
                  f"{err:.3g} (limit {limit})")
            if got.shape != (2, k, 256) or not (torch.isfinite(got.float()).all().item()
                                                and err <= limit):
                fail(f"{name} at the RGB-D shape ({dtype}): error {err} > {limit}")
        print(f"kernel {name} (RGB-D shape, bf16): kernel "
              f"{time_ms(torch, call(getattr(lgl, name), torch.bfloat16)):.4f} ms")


def check_distorted_rgbd(torch, frames) -> None:
    """RGB_D_DIST_FRAMES frames through the default facade (device-tracked)
    with TUM1's distortion: finite poses, and the device undistortion
    (ops/rgbd_step.py::undistort_points, f32) of every dispatched frame's
    K keypoints within 1e-3 px of io/undistort.py's (numpy, f64)."""
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib
    from superslam_tpu_torch.io.undistort import undistort_points as undistort_np
    from superslam_tpu_torch.ops import rgbd_step

    undistort, seen = rgbd_step.undistort_points, []

    def capturing(uv, calib, dist, *a, **kw):
        out = undistort(uv, calib, dist, *a, **kw)
        seen.append((uv.clone(), out.clone(), calib, dist))
        return out

    rgbd_step.undistort_points = capturing
    try:
        slam = build_rgbd_slam(TUM_DIST)
        if slam._tracker is None or not slam._tracker.device_tracking:
            fail(f"distorted rgbd: {facade_mode(slam)}, want device tracking")
        solves = count_host_solves(slam)
        for i, (gray, depth) in enumerate(frames):
            Tcw = slam.track_rgbd(gray, depth, i / RGBD_FPS)
            if not np.isfinite(Tcw).all():
                fail(f"distorted rgbd: frame {i}: pose {Tcw}")
        slam.flush()
        traj = slam.estimator.corrected_trajectory()
        slam.shutdown()
    finally:
        rgbd_step.undistort_points = undistort
    if len(seen) != len(frames) or not all(np.isfinite(p.t).all() for p in traj):
        fail(f"distorted rgbd: {len(seen)} device undistortions for {len(frames)} frames")
    worst, n_pts = 0.0, 0
    for uv, out, c5, dist in seen:
        calib = StereoCalib(fx=c5[0], fy=c5[1], cx=c5[2], cy=c5[3], baseline=c5[4])
        uv = uv.reshape(-1, 2).double().cpu().numpy()  # the padding rows too: in the image
        ref = undistort_np(uv, calib, np.asarray(dist))
        worst = max(worst, float(np.abs(out.reshape(-1, 2).cpu().numpy() - ref).max()))
        n_pts += uv.shape[0]
    print(f"rgbd facade (TUM1 distortion): {len(frames)} frames device-tracked, poses finite, "
          f"host pose solves {len(solves)}; device undistortion of {n_pts} keypoints vs "
          f"io/undistort.py max {worst:.3g} px (limit 1e-3)")
    if not worst <= 1e-3:
        fail(f"distorted rgbd: device undistortion {worst} px from io/undistort.py")


def check_loop_pieces(torch, gray) -> None:
    """EigenPlaces on the committed checkpoint at 512: the device-gray
    descriptor of a rendered TUM-geometry frame (its padded upload) within
    cosine LOOP_COSINE of the host-image path's, and one descriptor timed
    (CUDA events); then DeviceCosineIndex against the host index over 200
    random descriptors: the same ids in the same order, scores within 1e-5."""
    from superslam_tpu_torch.core.place_recognition import CosineDescriptorIndex
    from superslam_tpu_torch.frontend.recognizer import EigenPlacesRecognizer
    from superslam_tpu_torch.models.weights import load_safetensors
    from superslam_tpu_torch.ops.retrieval import DeviceCosineIndex

    params = load_safetensors(os.path.join(REPO, "weights", "eigenplaces_resnet18_512.safetensors"),
                              "cuda")
    rec = EigenPlacesRecognizer(params, image_size=512, device="cuda")
    padded = torch.zeros((TUM_H, TUM_W), dtype=torch.uint8, device="cuda")
    padded[:] = torch.from_numpy(gray).cuda()
    host = rec.compute_global_descriptor(gray)
    dev = rec.compute_global_descriptor_from_device(padded, TUM_H, TUM_W)
    cos = float(host @ dev / (np.linalg.norm(host) * np.linalg.norm(dev)))
    ms = time_ms(torch, lambda: rec.compute_global_descriptor_from_device(padded, TUM_H, TUM_W))
    print(f"loop: EigenPlaces descriptor at 512 from a {TUM_W}x{TUM_H} frame: device-gray vs "
          f"host-image path cosine {cos:.6f} (limit {LOOP_COSINE}), max abs "
          f"{np.abs(host - dev).max():.3g}; one device-gray descriptor {ms:.4f} ms (CUDA events, "
          "its readback included)")
    if not (np.isfinite(dev).all() and cos >= LOOP_COSINE):
        fail(f"loop: device-gray descriptor cosine {cos} < {LOOP_COSINE}")
    rng = np.random.default_rng(7)
    descs = rng.standard_normal((200, 512)).astype(np.float32)
    host_idx, dev_idx = CosineDescriptorIndex(), DeviceCosineIndex(4096, 512, device="cuda")
    for i, d in enumerate(descs):
        host_idx.add(i, d)
        dev_idx.add(i, d)
    worst = 0.0
    for q_at, exclude, top_k, min_score in ((7, 0, 5, -1.0), (50, 30, 3, 0.0), (150, 10, 0, 0.05)):
        q = descs[q_at] + rng.normal(0, 0.05, 512).astype(np.float32)
        h = host_idx.query(q, exclude, top_k, min_score)
        d = dev_idx.query(q, exclude, top_k, min_score)
        if [c.keyframe_id for c in h] != [i for i, _ in d] or not h:
            fail(f"loop: DeviceCosineIndex ids {[i for i, _ in d][:8]} vs host "
                 f"{[c.keyframe_id for c in h][:8]}")
        worst = max(worst, max(abs(c.score - s) for c, (_, s) in zip(h, d)))
    print(f"loop: DeviceCosineIndex over 200 descriptors: ids and order equal the host index's "
          f"on 3 queries, scores max |d| {worst:.3g} (limit 1e-5)")
    if not worst <= 1e-5:
        fail(f"loop: DeviceCosineIndex scores {worst} from the host index's")


def profile_rgbd(torch, slam, frames) -> None:
    """The default RGB-D facade (device-tracked) on the next frames of its
    lap under torch.profiler, its flush included: device busy ms a frame,
    the device's idle share and its device events a frame."""
    n = len(frames)

    def track():
        for i, (gray, depth) in enumerate(frames):
            slam.track_rgbd(gray, depth, (RGBD_FRAMES + i) / RGBD_FPS)
        slam.flush()

    rows = profile_device(torch, track, n, "frame", "frames of the default RGB-D facade "
                          "(depth 3, device-tracked, 640x480, K 1000)", top=12)
    print(f"profile: RGB-D device events a frame {sum(e.count for e in rows) / n:g}")

def check_extractor_kernel_route(torch, sp_params, left, right) -> int:
    """One stereo extraction through SuperPointExtractor(use_kernel=True):
    its descriptors against the default route's (atol 1e-5), and the
    gather_normalize launches it made."""
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.ops.cuda import _build

    kw = dict(width=WIDTH, height=HEIGHT, max_keypoints=MAX_KP, keypoint_threshold=KP_THRESHOLD)
    default = SuperPointExtractor(sp_params, **kw).extract_stereo(left, right)
    _build.reset_launch_counts()
    kernel = SuperPointExtractor(sp_params, use_kernel=True, **kw).extract_stereo(left, right)
    torch.cuda.synchronize()
    launches = _build.launch_counts()["gather_normalize"]
    worst = 0.0
    for a, b in zip(default, kernel):
        if a.descriptors.n != b.descriptors.n or a.descriptors.n < 100:
            fail(f"extractor: {a.descriptors.n} vs {b.descriptors.n} keypoints")
        worst = max(worst, (a.descriptors.desc - b.descriptors.desc).abs().max().item())
    print(
        f"extractor (use_kernel=True): {default[0].descriptors.n} + {default[1].descriptors.n} "
        f"keypoints, descriptors vs the default route max abs diff {worst:.3g} "
        f"(limit 1e-5), gather_normalize launches {launches}"
    )
    if not worst <= 1e-5:
        fail(f"extractor: use_kernel descriptors differ by {worst} > 1e-5")
    if launches != 1:
        fail(f"extractor: gather_normalize launched {launches} times, want 1")
    return launches


def check_map_mode(torch, sp_params, left, right) -> int:
    """The map-mode entry point ``nms_suppress`` (the port of the TPU
    kernel's function) on the pre-NMS map that ``superpoint_dense`` gives
    for one rendered stereo pair: the same bits as the NMS'd map of the
    logits mode on the main path. Returns its launches."""
    from superslam_tpu_torch.models.superpoint import prepare_superpoint_params, superpoint_dense
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.nms import nms_suppress

    params = prepare_superpoint_params(sp_params, "cuda")
    with torch.no_grad():
        scores, _, pre = superpoint_dense(params, padded_pair(torch, left, right),
                                          return_pre_nms=True)
        _build.reset_launch_counts()
        got = nms_suppress(pre, 4)
        torch.cuda.synchronize()
    launches = _build.launch_counts()["nms"]
    n_bad = (got != scores).sum().item()
    print(f"nms (map mode) on a frame's pre-NMS map: {n_bad} pixels differ from the logits "
          f"mode's NMS'd map ({(scores > 0).sum().item()} peaks), nms launches {launches}")
    if n_bad or launches != 1:
        fail(f"nms: map mode differs from the logits mode in {n_bad} pixels "
             f"or launched {launches} times")
    return launches


def profile_score_half(torch, sp_params, left, right, n: int = 20) -> None:
    """Device time and events of the score half on one frame's logits, as
    the frame ran it before (PyTorch's softmax and depth-to-space, then the
    map-mode kernel) and as it runs it now (the logits mode)."""
    from superslam_tpu_torch.ops.cuda.nms import nms_suppress, scores_nms, scores_nms_plain

    logits = frame_logits(torch, sp_params, left, right)

    def composed():
        for _ in range(n):
            nms_suppress(scores_nms_plain(logits, 0)[0], 4)

    def fused():
        for _ in range(n):
            scores_nms(logits, 4, return_pre=True)

    profile_device(torch, composed, n, "call",
                   "calls of the composition the logits mode replaces", top=8)
    profile_device(torch, fused, n, "call", "calls of the logits mode", top=8)


def profile_gather(torch, sp_params, left, right, n: int = 10) -> None:
    """The gather kernel's device time (row 7) inside n stereo extractions
    through SuperPointExtractor(use_kernel=True)."""
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor

    extractor = SuperPointExtractor(sp_params, use_kernel=True, width=WIDTH, height=HEIGHT,
                                    max_keypoints=MAX_KP, keypoint_threshold=KP_THRESHOLD)
    rows = profile_device(torch, lambda: [extractor.extract_stereo(left, right) for _ in range(n)],
                          n, "extraction", "extractions with use_kernel=True", top=0)
    gather = [e for e in rows if "gather_kernel" in e.key]
    if not gather:
        fail("extractor: no gather_normalize kernel in the profile")
    for e in gather:
        print(f"extractor (use_kernel=True): {e.key[:60]}: device "
              f"{device_us(e) / 1e3 / n:.4f} ms a call, {e.count / n:.1f} calls an extraction")


# -- multi-sequence batched tracking, the device window solver, the viewer -----------


def bench_calib():
    from superslam_tpu_torch.geometry.stereo_camera import StereoCalib

    return StereoCalib(fx=FX, fy=FX, cx=CX, cy=CY, baseline=BF / FX)


def multi_sequence_frames(n: int):
    """MULTI_S sequences of n frames of the bench lap, sequence s from frame
    MULTI_STRIDE * s. Returns (frames, ground truth), one list a sequence."""
    out = [render_sequence(n, WIDTH, HEIGHT, start=MULTI_STRIDE * s) for s in range(MULTI_S)]
    return [f for f, _ in out], [g for _, g in out]


def report_kernel(torch, name, label, err, limit, fn, plain, library, bnd) -> dict:
    """Time a kernel that passed its check beside its plain version and the
    library call (CUDA events, median of 20), print the row and return it."""
    ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
    lib_ms = None if library is None else time_ms(torch, library)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"kernel {name} {label}: error {err:.3g} (limit {limit}), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib}, bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
    return {"name": name, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err}


def check_superpoint_kernels(torch, sp_params, images, label: str,
                             against_f32: bool = False) -> list[dict]:
    """conv1a1b, conv_pair and scores_nms (logits mode) on ``images`` (B, H,
    W) f32 on the card, each against its plain version with the limits of
    phase 3 (the conv pairs within 2e-2 of max |plain|; the pre-NMS map
    within 1e-6 abs and the NMS'd map exactly nms_plain of it), timed
    beside the plain version and the library call.

    ``against_f32`` holds the conv pairs instead against the same pair in
    f32 (F.conv2d with TF32 off), within the same 2e-2 of max, and prints
    their distance from the plain version beside it: the plain versions
    round the image and each conv's output to bf16 before the bias (the JAX
    package's XLA route), and on small high-contrast images (procedural
    shapes, sprite renders at 120x160) that alone parts them from f32 by
    1.5-3.6e-2 of max, where the kernel, which convolves the f32 image,
    stays within 0.5e-2."""
    import torch.nn.functional as F

    from superslam_tpu_torch.ops.precision import highest_f32_matmuls

    from superslam_tpu_torch.models.superpoint import (
        _encoder_and_heads,
        prepare_superpoint_params,
    )
    from superslam_tpu_torch.ops.cuda.conv import (
        conv_pair_pool,
        conv_pair_pool_plain,
        pair_operands,
    )
    from superslam_tpu_torch.ops.cuda.nms import nms_plain, scores_nms, scores_nms_plain

    bf16 = torch.bfloat16
    b, h0, w0 = images.shape
    rows = []
    x = images[:, None]
    for name, cin, h, w in (("conv1a1b", 1, h0, w0), ("conv_pair", 64, h0 // 2, w0 // 2)):
        pre = ("conv1a", "conv1b") if cin == 1 else ("conv2a", "conv2b")
        wa, ba = sp_params[f"{pre[0]}.weight"], sp_params[f"{pre[0]}.bias"]
        wb, bb = sp_params[f"{pre[1]}.weight"], sp_params[f"{pre[1]}.bias"]
        ops = pair_operands(wa, ba, wb, bb)
        got = conv_pair_pool(x, wa, ba, wb, bb, operands=ops)
        ref = conv_pair_pool_plain(x, wa, ba, wb, bb)
        torch.cuda.synchronize()
        if got.shape != (b, 64, h // 2, w // 2):
            fail(f"{name} {label}: output {tuple(got.shape)}")
        rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        what = "of max |plain|"
        if against_f32:
            with highest_f32_matmuls():
                f32 = F.relu(F.conv2d(F.relu(F.conv2d(x.float(), wa, ba, padding=1)), wb, bb,
                                      padding=1))
                f32 = F.max_pool2d(f32, 2)
            top = f32.abs().max().item()
            print(f"kernel {name} {label}: against f32 {(got.float() - f32).abs().max().item() / top:.3g}"
                  f" of max, its plain version {(ref.float() - f32).abs().max().item() / top:.3g}, "
                  f"kernel vs plain {rel:.3g} of max |plain|")
            rel, what = (got.float() - f32).abs().max().item() / top, "of max |f32|"
        if not rel <= 2e-2:
            fail(f"{name} {label}: error {rel} {what} > 2e-2")
        xl = x.to(bf16).contiguous(memory_format=torch.channels_last)
        wal, bal, wbl, bbl = (t.to(bf16) for t in (wa, ba, wb, bb))
        px = b * h * w
        rows.append(report_kernel(
            torch, name, f"{label} {tuple(x.shape)}", rel, 2e-2,
            lambda: conv_pair_pool(x, wa, ba, wb, bb, operands=ops),
            lambda: conv_pair_pool_plain(x, wa, ba, wb, bb),
            lambda: F.max_pool2d(F.relu(F.conv2d(F.relu(F.conv2d(xl, wal, bal, padding=1)),
                                                 wbl, bbl, padding=1)), 2),
            bound(nbytes(x, wa, ba, wb, bb, got), f32_ops=2 * px * 64 * 9 if cin == 1 else 0,
                  bf16_ops=2 * px * 64 * 64 * 9 * (1 if cin == 1 else 2)),
        ))
        x = got

    with torch.no_grad():
        logits, _ = _encoder_and_heads(prepare_superpoint_params(sp_params, "cuda"), images, bf16)
    out_k, pre_k = scores_nms(logits, 4, return_pre=True)
    _, ref_pre = scores_nms_plain(logits, 4, return_pre=True)
    torch.cuda.synchronize()
    err = (pre_k - ref_pre).abs().max().item()
    if out_k.shape != (b, h0, w0) or not err <= 1e-6:
        fail(f"scores_nms {label}: output {tuple(out_k.shape)}, pre-NMS error {err} > 1e-6")
    if not torch.equal(out_k, nms_plain(pre_k, 4)):
        fail(f"scores_nms {label}: the NMS'd map differs from nms_plain of its pre-NMS map")

    def library_scores():
        p = F.pixel_shuffle(torch.softmax(logits, dim=1)[:, :-1], 8)
        return torch.where(p == F.max_pool2d(p, 9, 1, 4), p, 0.0)

    rows.append(report_kernel(
        torch, "scores_nms", f"{label} {tuple(logits.shape)}", err, 1e-6,
        lambda: scores_nms(logits, 4, return_pre=True),
        lambda: scores_nms_plain(logits, 4, return_pre=True), library_scores,
        bound(nbytes(logits, out_k, pre_k), f32_ops=4.0 * logits.numel() + 19.0 * out_k.numel()),
    ))
    return rows


def check_multi_kernels(torch, sp_params, lg_params, first_frames) -> None:
    """The five frame kernels at the multi-sequence step's shapes (2S = 8
    images, 4S = 16 pair problems) against their plain versions with the
    limits of the single-frame checks, timed beside the plain version and
    the library call."""
    from superslam_tpu_torch.ops.cuda import lightglue_layer as lgl

    dev, bf16, B = torch.device("cuda"), torch.bfloat16, 2 * MULTI_S
    img = np.zeros((B, PAD_H, PAD_W), np.float32)
    for s, (left, right) in enumerate(first_frames):
        img[2 * s, :HEIGHT, :WIDTH] = left / 255.0
        img[2 * s + 1, :HEIGHT, :WIDTH] = right / 255.0
    label = f"at the S = {MULTI_S} step"
    check_superpoint_kernels(torch, sp_params, torch.from_numpy(img).to(dev), label)

    # The blocks at 4S pair-problem sides: S stereo + S track problems, two
    # sides each, with the checkpoint's layer 0, ragged masks and the
    # keyframe sides before the first keyframe fully masked.
    rng = np.random.default_rng(8)
    rows = 4 * MULTI_S
    x32 = torch.from_numpy(rng.standard_normal((rows, MAX_KP, 256)).astype(np.float32)).to(dev)
    kpts = torch.from_numpy(rng.uniform(-1, 1, (rows, MAX_KP, 2)).astype(np.float32)).to(dev)
    proj = kpts @ lg_params["posenc.Wr.weight"].float().t()
    cos, sin = torch.cos(proj), torch.sin(proj)
    mask = torch.from_numpy(rng.uniform(size=(rows, MAX_KP)) < 0.85).to(dev)
    mask[MULTI_S:2 * MULTI_S] = False
    swapped = mask.reshape(rows // 2, 2, MAX_KP).flip(1).reshape(rows, MAX_KP)
    m_rows = rows * MAX_KP
    tail_ops = 2.0 * m_rows * (256 * 256 + 512 * 512 + 512 * 256)
    for name in ("fused_self_block", "fused_cross_block"):
        is_self = name == "fused_self_block"
        prefix = "transformers.0." + ("self_attn" if is_self else "cross_attn")
        prep = lgl.prep_self_weights if is_self else lgl.prep_cross_weights
        rotary = (cos, sin) if is_self else ()
        calls = {}
        for dtype in (torch.float32, bf16):
            xd, w = x32.to(dtype), prep(lg_params, prefix, dtype)
            calls[dtype] = [
                (lambda fn=fn, xd=xd, w=w: fn(xd, *rotary, mask, w))
                for fn in (getattr(lgl, name), getattr(lgl, name + "_plain"))
            ]
        got32, ref32 = (c() for c in calls[torch.float32])
        got, ref = (c() for c in calls[bf16])
        torch.cuda.synchronize()
        err32 = (got32 - ref32).abs().max().item()
        rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
        if got.shape != (rows, MAX_KP, 256) or not (err32 <= 1e-3 and rel <= 2e-2):
            fail(f"multi {name}: f32 error {err32} (limit 1e-3), bf16 {rel} of max |plain| "
                 "(limit 2e-2)")
        print(f"multi kernel {name}: f32 max abs error {err32:.3g} (limit 1e-3)")
        a_bf16, a_f32 = attention_ops(mask if is_self else swapped)
        proj_ops = 2.0 * m_rows * 256 * (768 if is_self else 512)
        io = nbytes(x32.to(bf16), *rotary, mask, got, *prep(lg_params, prefix, bf16))
        report_kernel(torch, name, label, rel, 2e-2, calls[bf16][0], calls[bf16][1], None,
                      bound(io, bf16_ops=proj_ops + tail_ops + a_bf16,
                            f32_ops=a_f32 + 30.0 * m_rows * 512))


def multi_tracker(sp, lg, n_seq: int):
    """MultiSequenceTracker over n_seq sequences with the bench config's
    window and keyframe gate (Backend.window_size 10, covis 0.75, 20)."""
    from superslam_tpu_torch.parallel.multi_tracker import MultiSequenceTracker

    tracker = MultiSequenceTracker(sp, lg, bench_calib(), num_sequences=n_seq, width=WIDTH,
                                   height=HEIGHT, max_keypoints=MAX_KP,
                                   keypoint_threshold=KP_THRESHOLD, window_size=10)
    for est in tracker.estimators:
        est.set_keyframe_params(0.75, 20)
    return tracker


def step_multi(tracker, seqs, i: int) -> None:
    n = tracker.S
    poses = tracker.step([seqs[s][i][0] for s in range(n)], [seqs[s][i][1] for s in range(n)],
                         [0.1 * i] * n)
    if len(poses) != n or not all(np.isfinite(p.t).all() and np.isfinite(p.R).all()
                                  for p in poses):
        fail(f"multi: step {i}: poses {poses}")


def run_multi(torch, sp, lg, seqs, n_seq: int):
    """One run of N_FRAMES steps; the counts reset before step 0 and read
    after the last. Returns (tracker, trajectories, sequence-frames/s over
    steps 1.., counts)."""
    from superslam_tpu_torch.ops.cuda import _build

    tracker = multi_tracker(sp, lg, n_seq)
    _build.reset_launch_counts()
    for i in range(N_FRAMES):
        step_multi(tracker, seqs, i)
        if i == 0:
            t1 = time.perf_counter()  # step 0 carries the first calls' set-up
    torch.cuda.synchronize()
    rate = n_seq * (N_FRAMES - 1) / (time.perf_counter() - t1)
    return tracker, tracker.trajectories(), rate, _build.launch_counts()


def run_single_sequence(torch, sp, lg, frames):
    """One sequence alone through FusedStereoPipeline and VoEstimator, as
    tests/test_parallel.py's reference run: the same config as the tracker."""
    from superslam_tpu_torch.core.vo_estimator import VoEstimator
    from superslam_tpu_torch.frontend.fused import FusedStereoPipeline

    calib = bench_calib()
    pipe = FusedStereoPipeline(sp, lg, calib, width=WIDTH, height=HEIGHT, max_keypoints=MAX_KP,
                               keypoint_threshold=KP_THRESHOLD)
    est = VoEstimator(None, calib, 10, device="cuda")
    est.set_keyframe_params(0.75, 20)
    for i, (left, right) in enumerate(frames):
        frame, m = pipe.process(left, right, 0.1 * i)
        est.track(frame, kf_matches=m)
        if est._last_keyframe is frame:
            pipe.set_keyframe(frame.descriptors_left)
    return est.corrected_trajectory()


def run_multi_phase(torch, sp, lg, seqs, gt):
    """The multi-sequence phase: S = MULTI_S and S = 1 ABBA (sequence-frames
    a second over steps 1..29), the first S = MULTI_S run held to its
    launches a step, every sequence's ATE and its gap to the sequence run
    alone. Returns the last S = MULTI_S tracker (profiled last)."""
    from superslam_tpu_torch.eval.metrics import ate

    first = [s[:N_FRAMES] for s in seqs]
    rates = {MULTI_S: [], 1: []}
    runs = []
    for n_seq in (MULTI_S, 1, 1, MULTI_S):
        tracker, trajs, rate, counts = run_multi(torch, sp, lg, first, n_seq)
        rates[n_seq].append(rate)
        runs.append((n_seq, tracker, trajs, counts))
        print(f"multi: S = {n_seq}, {N_FRAMES} steps: {rate:.2f} sequence-frames/s over steps "
              f"1..{N_FRAMES - 1} ({rate / n_seq:.2f} steps/s)", flush=True)
    _, _, trajs, counts = runs[0]
    for k, v in counts.items():
        want = PER_STEP_MULTI.get(k, 0) * N_FRAMES
        if v != want:
            fail(f"multi: {k}: {v} launches in {N_FRAMES} steps of {MULTI_S} sequences, want "
                 f"{PER_STEP_MULTI.get(k, 0)} a step")
    print(f"multi: launches a step (all {MULTI_S} sequences): "
          f"{ {k: counts[k] / N_FRAMES for k in PER_STEP_MULTI} }")
    worst_gap = 0.0
    for s in range(MULTI_S):
        res = ate(trajs[s], gt[s][:N_FRAMES])
        alone = run_single_sequence(torch, sp, lg, first[s])
        gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(trajs[s], alone))
        worst_gap = max(worst_gap, gap)
        print(f"multi: sequence {s} (frames {MULTI_STRIDE * s}..{MULTI_STRIDE * s + N_FRAMES - 1}"
              f"): ATE {res.rmse:.4f} m, keyframes "
              f"{len(runs[0][1].estimators[s].anchors())}, largest position gap to the "
              f"sequence alone {gap:.4f} m")
        if len(trajs[s]) != N_FRAMES or not np.isfinite(res.rmse) or res.rmse > ATE_LIMIT_M:
            fail(f"multi: sequence {s}: ATE {res.rmse} m > {ATE_LIMIT_M} m")
    if not worst_gap <= MULTI_GAP_M:
        fail(f"multi: a sequence parts from its run alone by {worst_gap} m > {MULTI_GAP_M} m")
    print(f"multi: ABBA sequence-frames/s: S = {MULTI_S} {rates[MULTI_S]}, S = 1 {rates[1]}; "
          f"largest gap to the sequences alone {worst_gap:.4f} m (limit {MULTI_GAP_M})")
    return runs[-1][1]


def profile_multi(torch, tracker, seqs) -> None:
    """MULTI_PROFILE_STEPS more steps of the multi-sequence tracker under
    torch.profiler: device busy ms a step and the idle share."""
    def steps():
        for i in range(N_FRAMES, N_FRAMES + MULTI_PROFILE_STEPS):
            step_multi(tracker, seqs, i)

    profile_device(torch, steps, MULTI_PROFILE_STEPS, "step",
                   f"steps of the multi-sequence tracker (S = {MULTI_S})", top=12)


def batched_scene(torch, q_count: int):
    """tests/test_parallel.py's batched_track_scan inputs at K = MAX_KP and
    BATCHED_S frames, on the card: exact projections of per-sequence
    landmarks under known motions; the last sequence keeps 6 matches from
    its second frame on (below min_matches: it coasts)."""
    rng = np.random.default_rng(9)
    fx, cx, cy, base = 80.0, 80.0, 60.0, 0.1
    kls, disps, xws = [], [], []
    for q in range(q_count):
        xw = rng.uniform([-4, -3, 6], [4, 3, 18], (MAX_KP, 3))
        xws.append(xw)
        kl, disp = [], []
        for s in range(BATCHED_S):
            p = xw - np.array([0.1 * (s + 1) * (q + 1), 0.0, 0.0])
            kl.append(np.stack([fx * p[:, 0] / p[:, 2] + cx, fx * p[:, 1] / p[:, 2] + cy], 1))
            disp.append(fx * base / p[:, 2])
        kls.append(kl)
        disps.append(disp)
    tm = np.tile(np.arange(MAX_KP, dtype=np.int32), (q_count, BATCHED_S, 1))
    tm[-1, 1:, 6:] = -1
    dev = torch.device("cuda")
    arrays = [torch.from_numpy(a).to(dev) for a in (
        np.array(kls, np.float32), np.array(disps, np.float32),
        np.ones((q_count, BATCHED_S, MAX_KP), bool), tm, np.array(xws, np.float32),
        np.ones((q_count, MAX_KP), bool))]
    eye = torch.eye(3, device=dev).expand(q_count, 3, 3).contiguous()
    zero = torch.zeros((q_count, 3), device=dev)
    kw = dict(calib=(fx, fx, cx, cy, base), min_matches=10, track_sigma_px=10.0,
              disp_sigma0=8.0, disp_cond=fx * base / 40.0)
    return arrays, (eye, zero, eye, zero), kw


def batched_scan_plain(torch, arrays, carry, kw):
    """batched_track_scan with the plain twin for every launch, on the same
    tensors: track_frame_batched_plain a frame index."""
    from superslam_tpu_torch.ops.cuda.track_frame import track_frame_batched_plain
    from superslam_tpu_torch.ops.frontend_step import _track_gate_defaults

    kl, disp, sok, tm, xw, dok = arrays
    gate_px, chi2_px, chi2_rounds = _track_gate_defaults(None, None, None)
    Q = kl.shape[0]
    c = torch.cat([carry[0].reshape(Q, 9), carry[1], carry[2].reshape(Q, 9), carry[3]], 1)
    rows = []
    for s in range(kl.shape[1]):
        r, c, _ = track_frame_batched_plain(
            c, kl[:, s], disp[:, s], sok[:, s], tm[:, s], xw, dok, calib=kw["calib"],
            min_matches=kw["min_matches"], inv_sig_uLv=1.0 / kw["track_sigma_px"],
            disp_sigma0=kw["disp_sigma0"], disp_cond=kw["disp_cond"], mono=False,
            gate_px=gate_px, chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=20)
        rows.append(r)
    return torch.stack(rows, 1), c


def check_batched_track_scan(torch) -> tuple[dict, int]:
    """batched_track_scan at Q in (1,) + BATCHED_Q sequences, BATCHED_S
    frames, K = MAX_KP: exactly BATCHED_S launches a call, pose columns and
    carry within BATCHED_ATOL of the plain twin's, counts exact; one
    launch's time at each Q and its bound. Returns the kernels-line row
    (timed at the largest Q) and the launches of that Q's call."""
    from superslam_tpu_torch.ops import pose_solver
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.track_frame import (
        _SMALL,
        TRACK_COLS,
        track_frame_batched,
        track_frame_batched_plain,
    )
    from superslam_tpu_torch.ops.frontend_step import _track_gate_defaults
    from superslam_tpu_torch.parallel.batched_tracking import batched_track_scan

    gate_px, chi2_px, chi2_rounds = _track_gate_defaults(None, None, None)
    worst, row = 0.0, None
    for q_count in (1,) + BATCHED_Q:
        arrays, carry, kw = batched_scene(torch, q_count)
        _build.reset_launch_counts()
        out, new = batched_track_scan(*arrays, carry, **kw)
        torch.cuda.synchronize()
        launches = _build.launch_counts()["track_frame_batched"]
        if launches != BATCHED_S:
            fail(f"batched_track_scan: {launches} launches for {BATCHED_S} frames at Q {q_count}")
        ref, ref_c = batched_scan_plain(torch, arrays, carry, kw)
        err = max((out[..., :12] - ref[..., :12]).abs().max().item(),
                  max((a.reshape(q_count, -1) - b).abs().max().item()
                      for a, b in zip(new, (ref_c[:, :9], ref_c[:, 9:12], ref_c[:, 12:21],
                                            ref_c[:, 21:24]))))
        if not err <= BATCHED_ATOL or not torch.equal(out[..., 12], ref[..., 12]):
            fail(f"batched_track_scan at Q {q_count}: pose error {err} (limit {BATCHED_ATOL}), "
                 f"counts {out[..., 12].tolist()} against {ref[..., 12].tolist()}")
        if q_count > 1 and not (out[-1, 1:, 12] == 6).all().item():
            fail(f"batched_track_scan: the coasting sequence's counts {out[-1, :, 12].tolist()}")
        worst = max(worst, err)
        # One launch (frame 0 of every sequence) and what its work needs.
        kl, disp, sok, tm, xw, dok = arrays
        c0 = torch.cat([carry[0].reshape(q_count, 9), carry[1], carry[2].reshape(q_count, 9),
                        carry[3]], 1)
        solve_kw = dict(calib=kw["calib"], min_matches=kw["min_matches"],
                        inv_sig_uLv=1.0 / kw["track_sigma_px"], disp_sigma0=kw["disp_sigma0"],
                        disp_cond=kw["disp_cond"], mono=False, gate_px=gate_px,
                        chi2_px=chi2_px, chi2_rounds=chi2_rounds, track_iters=20)
        frame0 = (c0, kl[:, 0], disp[:, 0], sok[:, 0], tm[:, 0], xw, dok)
        ms = time_ms(torch, lambda: track_frame_batched(*frame0, **solve_kw))
        iters = []
        system = pose_solver._system
        pose_solver._system = lambda *a, **k: iters.append(1) or system(*a, **k)
        try:
            plain_ms = time_ms(torch, lambda: track_frame_batched_plain(*frame0, **solve_kw),
                               warmup=0, iters=1)
        finally:
            pose_solver._system = system
        rounds = 1 + (1 if gate_px > 0 else 0) + chi2_rounds
        ops = float(MAX_KP) * (POSE_OPS_ITER * len(iters) + POSE_OPS_REPROJ * rounds * q_count)
        io = nbytes(c0[:, :24], *frame0[1:]) + q_count * 4 * (TRACK_COLS + _SMALL + 3)
        bnd = bound(io, f32_ops=ops)
        print(f"kernel track_frame_batched: Q {q_count}, K {MAX_KP}: {BATCHED_S} launches a call, "
              f"poses within {err:.3g} of the twin (limit {BATCHED_ATOL}), counts exact; one "
              f"launch {ms:.4f} ms ({ms / q_count:.4f} ms a sequence), plain {plain_ms:.4f} ms, "
              f"{len(iters)} LM iterations over the {q_count} sequences, bound {bnd[0]:.6f} ms "
              f"({bnd[1]}: {io} B, {ops:.3g} f32 operations)", flush=True)
        row = {
            "name": "track_frame_batched", "route": "cuda",
            "source": KERNEL_INFO["track_frame_batched"][0],
            "replaces": KERNEL_INFO["track_frame_batched"][1], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        }
    row["max_abs_err"] = worst
    return row, launches


def run_xla_smoother_facade(torch, frames, gt) -> None:
    """The default facade (depth 3, device keyframes) with
    SUPERSLAM_XLA_SMOOTHER=1 over the bench frames: ATE <= ATE_LIMIT_M, every
    window it solved on the card solved again by the host LM and the poses
    within WS_POSE_TOL (m, and rotation-matrix entries); the solves' ms by
    CUDA events (readback included) against the host LM's."""
    from scripts.accuracy_suite_torch import leg_environment
    from superslam_tpu_torch.core import window_smoother as ws
    from superslam_tpu_torch.eval.metrics import ate

    captured = []
    real = ws.WindowSmoother._lm_xla

    def timed(self, poses, groups, sigma_px, dyn_px, max_iters, huber_k=0.0):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = real(self, poses, groups, sigma_px, dyn_px, max_iters, huber_k)
        b.record()
        b.synchronize()
        captured.append((self, (poses, groups, sigma_px, dyn_px, max_iters, huber_k), out,
                         a.elapsed_time(b), (time.perf_counter() - t0) * 1e3))
        return out

    ws.WindowSmoother._lm_xla = timed
    try:
        with leg_environment({"SUPERSLAM_XLA_SMOOTHER": "1"}):
            slam = build_slam()
            mode = facade_mode(slam)
            if not (slam._tracker and slam._tracker.depth == 3 and slam._tracker.device_kf):
                fail(f"xla smoother facade: {mode}, want depth 3, device keyframes")
            t0 = time.perf_counter()
            for i, (left, right) in enumerate(frames):
                slam.track_stereo(left, right, 0.1 * i)
            slam.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            slam.estimator.stop_loop_worker()
            poses = slam.estimator.corrected_trajectory()
            slam.shutdown()
    finally:
        ws.WindowSmoother._lm_xla = real
    res = ate(poses, gt)
    if not captured:
        fail("xla smoother facade: no window was solved on the card")
    from superslam_tpu_torch import native

    worst_t = worst_r = 0.0
    host_ms, native_ms = [], []
    for smoother, (seed, groups, sigma_px, dyn_px, max_iters, huber_k), out, _, _ in captured:
        t0 = time.perf_counter()
        ref = smoother._lm(seed, groups, sigma_px, dyn_px, seed[0], 1e-4, max_iters, huber_k)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if native.available():  # the host path the knob replaces (C++, csrc/)
            t0 = time.perf_counter()
            smoother._lm_native(seed, groups, sigma_px, dyn_px, 1e-4, max_iters, huber_k)
            native_ms.append((time.perf_counter() - t0) * 1e3)
        if out is None or ref is None or len(out) != len(ref):
            fail(f"xla smoother: a window gave {out} on the card and {ref} on the host")
        for p, q in zip(out, ref):
            worst_t = max(worst_t, float(np.linalg.norm(p.t - q.t)))
            worst_r = max(worst_r, float(np.abs(p.R - q.R).max()))
    dev_ms = [c[3] for c in captured]
    wall_ms = [c[4] for c in captured]
    print(f"xla smoother facade ({mode}): {len(frames)} frames in {wall:.2f} s, ATE "
          f"{res.rmse:.4f} m; {len(captured)} window solves on the card, median "
          f"{statistics.median(dev_ms):.3f} ms by CUDA events (host wall "
          f"{statistics.median(wall_ms):.3f} ms; first {dev_ms[0]:.1f} ms), the host LM "
          f"median {statistics.median(host_ms):.3f} ms (numpy) and "
          f"{statistics.median(native_ms) if native_ms else float('nan'):.3f} ms (C++) on the "
          f"same windows; largest gap to the numpy LM "
          f"{worst_t:.3g} m, {worst_r:.3g} in rotation (limit {WS_POSE_TOL})", flush=True)
    if not np.isfinite(res.rmse) or res.rmse > ATE_LIMIT_M:
        fail(f"xla smoother facade: ATE {res.rmse} m > {ATE_LIMIT_M} m")
    if not (worst_t <= WS_POSE_TOL and worst_r <= WS_POSE_TOL):
        fail(f"xla smoother: a window parts from the host LM by {worst_t} m, {worst_r}")


def check_viewer(torch, frames) -> None:
    """SuperSLAM(cfg, use_viewer=True) over a few frames: the synchronous
    loop (depth 0) draws every frame, and close() returns (the card's host
    may lack matplotlib: the recorder then logs and returns)."""
    from scripts.accuracy_suite_torch import leg_environment

    with tempfile.TemporaryDirectory() as tmp, leg_environment(
            {"SUPERSLAM_VIEWER_PLOT": os.path.join(tmp, "trajectory.png")}):
        slam = build_slam(use_viewer=True)
        if slam._tracker is not None or slam.viewer is None:
            fail(f"viewer: {facade_mode(slam)}, viewer {slam.viewer}: want depth 0 with a viewer")
        for i, (left, right) in enumerate(frames):
            slam.track_stereo(left, right, 0.1 * i)
        drawn = len(slam.viewer._traj)
        t0 = time.perf_counter()
        slam.shutdown()
        close_s = time.perf_counter() - t0
        plot = os.path.exists(os.path.join(tmp, "trajectory.png"))
    if drawn != len(frames):
        fail(f"viewer: {drawn} poses drawn for {len(frames)} frames")
    print(f"viewer: {facade_mode(slam)}, {drawn} poses drawn, close() returned in "
          f"{close_s:.2f} s (plot written: {plot}; rerun SDK: {slam.viewer._rr is not None})")


# -- the tooling: bench_torch.py, the runners and the evaluators ---------------------


class _Tee:
    """A stream that writes to two (bench_torch.py's stderr lines to stdout
    as well, where the run's record keeps them)."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def write(self, s):
        self.a.write(s)
        self.b.write(s)
        return len(s)

    def flush(self):
        self.a.flush()
        self.b.flush()


def check_bench_run(torch) -> None:
    """bench_torch.py's run at its defaults (depth 3, batch 4, device
    keyframes) with the settle and measure cut to BENCH_SETTLE_S and
    BENCH_MEASURE_S: the mode; over the measured window (counts reset before
    its first frame, read after the flush that ends it) the launches a
    dispatch, exactly PER_DISPATCH_BENCH once the matcher launches of the
    frames that drain through the host re-match path are subtracted (those
    frames counted and printed); every dispatch and upload of the window
    under set_sync_debug_mode("error"); the ATE against the circuit's poses
    over blocks of BENCH_ATE_FRAMES measured frames that cover the window."""
    import contextlib

    import bench_torch
    from superslam_tpu_torch.eval.metrics import ate
    from superslam_tpu_torch.ops.cuda import _build

    state = {}

    def observe(stage, tracker):
        if stage == "measure":
            mode = tracker_mode(tracker)
            print(f"bench_torch: mode {mode}", flush=True)
            if tracker.depth != 3 or tracker.batch != 4 or not tracker.device_kf:
                fail(f"bench_torch: {mode}, want depth 3, batch 4, device keyframes")
            est = tracker.estimator
            state["window"], state["restore"] = instrument_window(
                torch, tracker, tracker.pipeline, est.matcher, est)
            state["reseeds"] = tracker.reseeds
            _build.reset_launch_counts()
            state["window"]["on"] = True
        else:
            state["window"]["on"] = False
            state["counts"] = _build.launch_counts()
            state["reseeds"] = tracker.reseeds - state["reseeds"]
            state["restore"]()

    err = sys.stderr
    with contextlib.redirect_stderr(_Tee(err, sys.stdout)):
        try:
            res = bench_torch.run(settle_s=BENCH_SETTLE_S, measure_s=BENCH_MEASURE_S,
                                  observe=observe)
        except RuntimeError as e:
            if "synchroniz" in str(e):
                fail(f"bench_torch: a synchronizing call in a measured dispatch: {e}")
            raise
    print(f"bench_torch: {bench_torch.result_line(res['fps'])}")
    print(f"bench_torch: device-only per-frame program {res['device_ms']:.4f} ms (batch 1, "
          f"the run's final mode; 12 against 3 iterations, the smallest of 3 samples)")
    tracker = res["tracker"]
    first, end = res["measured"]
    window, counts = state["window"], state["counts"]
    n = window["dispatches"]
    print(f"bench_torch: measured frames {first}..{end - 1} ({end - first} frames, settle "
          f"{BENCH_SETTLE_S} s and measure {BENCH_MEASURE_S} s, cut from 15 and 135), {n} "
          f"dispatches, no synchronizing call in their dispatches and uploads under "
          f"set_sync_debug_mode('error'); keyframe reseeds {state['reseeds']}; frames drained "
          f"through the host re-match path {len(set(window['rematch_frames']))} of "
          f"{end - first} ({window['rematch_calls']} matcher calls, launches "
          f"{dict((k, v) for k, v in window['rematch'].items() if v)}); launches {counts}")
    for k in _build.KERNELS:
        got = counts[k] - window["rematch"][k]
        want = PER_DISPATCH_BENCH.get(k, 0)
        if want:
            print(f"bench_torch: {k}: {got / max(n, 1):g} launches a dispatch")
        if got != want * n:
            fail(f"bench_torch: {k}: {got} launches in {n} dispatches, want {want} a dispatch")
    traj = tracker.estimator.corrected_trajectory()
    gt = bench_torch.circuit_poses(bench_torch.N_FRAMES)

    def ate_over(lo, hi):
        return ate(traj[lo:hi], [gt[i % len(gt)] for i in range(lo, hi)])

    # The bench laps the circuit with no loop closure, so a window's ATE
    # grows with its length and the measured window's length follows the
    # fps: the gate holds blocks of BENCH_ATE_FRAMES measured frames, each
    # aligned on its own, which cover the window (the last ends at its end).
    m = min(BENCH_ATE_FRAMES, end - first)
    starts = sorted({*range(first, end - m + 1, m), end - m})
    blocks = [(lo, ate_over(lo, lo + m).rmse) for lo in starts]
    whole = ate_over(first, end)
    growth = [(k, ate_over(first, first + k).rmse) for k in (500, 1000, 1500, 2000, 2500)
              if k < end - first]
    worst = max(a for _, a in blocks)
    print(f"bench_torch: ATE over blocks of {m} measured frames "
          f"{', '.join(f'{lo}..: {a:.4f}' for lo, a in blocks)} m (limit {BENCH_ATE_LIMIT_M}); "
          f"{whole.rmse:.4f} m over all {end - first} measured frames; over the window's first "
          f"n frames {', '.join(f'{k}: {a:.4f}' for k, a in growth)}; keyframes "
          f"{len(tracker.estimator.anchors())}")
    if len(traj) != end or not np.isfinite(worst) or worst > BENCH_ATE_LIMIT_M:
        fail(f"bench_torch: ATE {worst} m over {m} measured frames > {BENCH_ATE_LIMIT_M} m "
             f"({len(traj)} poses, want {end})")


def run_tools(jobs: list[tuple[str, list[str]]]) -> list[str]:
    """Run repo scripts as concurrent subprocesses from the repo root; print
    each one's wall time and its last lines, fail on a non-zero exit. Returns
    their stdouts."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SUPERSLAM_")}
    t0 = time.perf_counter()
    procs = [
        (rel, subprocess.Popen([sys.executable, os.path.join(REPO, rel), *argv], cwd=REPO,
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True))
        for rel, argv in jobs
    ]
    outs = []
    for rel, proc in procs:
        try:
            out, err = proc.communicate(timeout=TOOL_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            fail(f"tools: {rel} ran past {TOOL_TIMEOUT_S} s")
        tail = " | ".join(out.strip().splitlines()[-3:])
        print(f"tools: {rel} exited {proc.returncode} by {time.perf_counter() - t0:.1f} s: {tail}",
              flush=True)
        if proc.returncode != 0:
            print(err[-3000:], file=sys.stderr)
            fail(f"tools: {rel} exited {proc.returncode}")
        outs.append(out)
    return outs


def check_runners() -> None:
    """scripts/make_synthetic_sequence_torch.py writes TOOL_FRAMES frames of
    its straight trajectory at TOOL_W x TOOL_H in both formats; examples/kitti_torch.py,
    tum_rgbd_torch.py, benchmark_torch.py and multi_sequence_torch.py
    --replicate 2 run on them on the card as subprocesses, each exiting 0;
    their trajectories go through scripts/evaluate_kitti_torch.py and
    evaluate_tum_torch.py, each ATE <= ATE_LIMIT_M."""
    with tempfile.TemporaryDirectory() as tmp:
        kitti, tum = os.path.join(tmp, "kitti"), os.path.join(tmp, "tum")
        common = ["--frames", str(TOOL_FRAMES), "--trajectory", "straight", "--width",
                  str(TOOL_W), "--height", str(TOOL_H), "--model-dir",
                  os.path.join(REPO, "weights") + os.sep]
        run_tools([("scripts/make_synthetic_sequence_torch.py", [kitti, *common]),
                   ("scripts/make_synthetic_sequence_torch.py", [tum, "--format", "tum",
                                                                  *common])])
        est_k, est_t, multi = (os.path.join(tmp, n) for n in ("kitti.txt", "tum.txt", "multi"))
        run_tools([
            ("examples/kitti_torch.py", [f"{kitti}/config.yaml", kitti, "--no-viewer", "--out",
                                         est_k]),
            ("examples/tum_rgbd_torch.py", [f"{tum}/config.yaml", tum, "--no-viewer", "--out",
                                            est_t]),
            ("examples/benchmark_torch.py", [f"{kitti}/config.yaml", kitti]),
            ("examples/multi_sequence_torch.py", [f"{kitti}/config.yaml", kitti, "--replicate",
                                                  "2", "--out-dir", multi]),
        ])
        gt_k, gt_t = f"{kitti}/poses_gt.txt", f"{tum}/groundtruth.txt"
        evals = [("scripts/evaluate_kitti_torch.py", [est_k, gt_k]),
                 ("scripts/evaluate_tum_torch.py", [est_t, gt_t]),
                 ("scripts/evaluate_kitti_torch.py", [f"{multi}/seq00.txt", gt_k]),
                 ("scripts/evaluate_kitti_torch.py", [f"{multi}/seq01.txt", gt_k])]
        outs = run_tools(evals)
    for (rel, argv), out in zip(evals, outs):
        metrics = json.loads(out.strip().splitlines()[-1])
        print(f"tools: {os.path.basename(argv[0])}: {metrics}")
        if not metrics["ate_rmse_m"] <= ATE_LIMIT_M:
            fail(f"tools: {rel} {argv[0]}: ATE {metrics['ate_rmse_m']} m > {ATE_LIMIT_M} m")


def profile_facade(torch, slam, n: int) -> float:
    """Track the next n frames of the lap under torch.profiler, print where
    the device time goes, and fail if a softmax kernel ran: the score half
    is the NMS kernel's logits mode (LightGlue's log_softmax stays).
    Returns the device events a frame."""
    frames, _ = render_sequence(n, WIDTH, HEIGHT, start=N_FRAMES)

    def track():
        for i, (left, right) in enumerate(frames):
            slam.track_stereo(left, right, 0.1 * (N_FRAMES + i))

    rows = profile_device(torch, track, n, "frame", "frames")
    for e in rows:
        if "softmax" in e.key.lower():
            kind = "log_softmax" if is_log_softmax(e.key) else "softmax"
            print(f"profile: {kind} kernel on the frame, {device_us(e) / 1e3 / n:.4f} ms/frame: "
                  f"{e.key}")
            if kind == "softmax":
                fail(f"the frame ran a softmax kernel: {e.key}")
    return sum(e.count for e in rows) / n


def profile_default(torch, slam, n: int, depth0_events: float) -> None:
    """The default facade (depth 3, device keyframes) on the next n frames of
    the lap under torch.profiler, its flush included: device busy ms a frame,
    the device's idle share, and its device events a frame against depth
    0's (profile_facade, the same frames)."""
    frames, _ = render_sequence(n, WIDTH, HEIGHT, start=N_FRAMES)

    def track():
        for i, (left, right) in enumerate(frames):
            slam.track_stereo(left, right, 0.1 * (N_FRAMES + i))
        slam.flush()

    rows = profile_device(torch, track, n, "frame", "frames of the default facade (depth 3, "
                          "device keyframes)", top=12)
    for e in rows:
        if "track_frame_kernel" in e.key:
            print(f"profile: track_frame in the default frame: {device_us(e) / 1e3 / e.count:.4f} "
                  f"ms of device time a call, {e.count / n:g} calls a frame")
    events = sum(e.count for e in rows) / n
    print(f"profile: device events a frame: default {events:g}, depth 0 {depth0_events:g}, "
          f"difference {events - depth0_events:+g}")


def is_log_softmax(key: str) -> bool:
    """Whether a PyTorch softmax kernel's name is log_softmax's: its
    epilogue (cunn_SoftMaxForward, cunn_SpatialSoftMaxForward) or the
    is_log_softmax template flag of softmax_warp_forward."""
    flag = re.search(r"softmax_warp_forward<(?:[^,<>]+,){4}\s*(true|false)", key)
    return "logsoftmax" in key.lower() or bool(flag and flag.group(1) == "true")


def device_us(e) -> float:
    """A profiler row's own device time in microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_device(torch, fn, n: int, unit: str, label: str, top: int = 25) -> list:
    """Run fn (n units of work) under torch.profiler, print the busy share
    of the window and the kernels by device time per unit, and return the
    device-side events by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Device-side events only (kernels, memcpys): the CPU-side aten ops
    # also carry the device time of what they launched.
    rows = sorted(
        (
            e for e in prof.key_averages()
            if device_us(e) > 0 and "CPU" not in str(getattr(e, "device_type", "CPU"))
        ),
        key=device_us,
        reverse=True,
    )
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    print(
        f"profile: {n} {label}, wall under the profiler {wall_ms / n:.3f} ms/{unit}, "
        f"device busy {busy_ms / n:.3f} ms/{unit} ({100 * busy_ms / wall_ms:.1f}% of "
        f"that wall, idle share {100 - 100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in rows) / n:.0f} device events/{unit}"
    )
    for e in rows[:top]:
        print(
            f"profile:   {device_us(e) / 1e3 / n:8.4f} ms/{unit}  "
            f"{e.count / n:6.1f} calls/{unit}  {e.key[:90]}"
        )
    return rows


_BATCH_KEYS = ("kpts0", "desc0", "kpts1", "desc1", "mask0", "mask1", "gt_indices")


def check_training(torch) -> tuple[int, int]:
    """The matcher's training at full width on the card (phase 7 of the
    module docstring). Returns the masked_attention (the f32 forward) and
    masked_attention_bwd launches of the fixed-batch steps."""
    from scripts import train_lightglue_synth_torch as train_script
    from superslam_tpu_torch.models import lightglue as lgm
    from superslam_tpu_torch.models.weights import load_safetensors
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.ops.cuda.attention import masked_attention_plain
    from superslam_tpu_torch.parallel.training import (
        make_optimizer,
        matching_loss,
        synthetic_matching_batch,
        train_step,
    )

    dev = torch.device("cuda")
    batch_np = synthetic_matching_batch(np.random.default_rng(5), TRAIN_BATCH, TRAIN_CAP)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}

    # 1. The whole step's gradient through the kernels against the same
    # graph with attention's plain version (autograd through its einsums).
    def gradients(plain: bool):
        params = lgm.init_lightglue_params(1, device=dev)
        for p in params.values():
            p.requires_grad_(True)
        kernel_route = lgm.masked_attention
        if plain:
            lgm.masked_attention = masked_attention_plain
        try:
            loss = matching_loss(params, *(batch[k] for k in _BATCH_KEYS))
            loss.backward()
        finally:
            lgm.masked_attention = kernel_route
        return loss.item(), {k: p.grad for k, p in params.items()}

    _build.reset_launch_counts()
    loss_k, grads_k = gradients(plain=False)
    counts = _build.launch_counts()
    loss_p, grads_p = gradients(plain=True)
    torch.cuda.synchronize()
    worst, worst_name, n_checked = 0.0, "", 0
    for name, ref in grads_p.items():
        got = grads_k[name]
        if (ref is None) != (got is None):
            fail(f"train: gradient of {name} exists on one route only")
        if ref is None:
            continue
        if not torch.isfinite(got).all().item():
            fail(f"train: gradient of {name} is not finite")
        rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        n_checked += 1
        if rel > worst:
            worst, worst_name = rel, name
    print(
        f"train: gradient of matching_loss (batch {TRAIN_BATCH}, cap {TRAIN_CAP}, f32) through "
        f"the kernels vs the plain versions: loss {loss_k:.6f} vs {loss_p:.6f}, {n_checked} "
        f"tensors, worst max error / max |plain| {worst:.3g} at {worst_name} (limit 1e-3)"
    )
    if not worst <= 1e-3 or not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        fail(f"train: gradient check: {worst} at {worst_name}, loss {loss_k} vs {loss_p}")
    for k in ("masked_attention", "masked_attention_bwd"):
        if counts[k] != ATTENTION_PER_STEP:
            fail(f"train: {k}: {counts[k]} launches in one gradient, want {ATTENTION_PER_STEP}")

    # 2. train_step on that fixed batch: the reference's functional test.
    params = lgm.init_lightglue_params(1, device=dev)
    optimizer = make_optimizer(params, TRAIN_LR)
    train_step(params, optimizer, batch)  # warm-up: cuBLAS handles, optimizer state
    params = lgm.init_lightglue_params(1, device=dev)
    optimizer = make_optimizer(params, TRAIN_LR)
    losses, step_ms = [], []
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(FIXED_BATCH_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = train_step(params, optimizer, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    wall_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    first_below = next((i + 1 for i, v in enumerate(losses) if v < 0.7 * losses[0]), None)
    print(
        f"train: {FIXED_BATCH_STEPS} steps on the fixed batch at lr {TRAIN_LR}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first below 0.7 x start after {first_below} "
        f"steps), step median {statistics.median(step_ms):.3f} ms, "
        f"{FIXED_BATCH_STEPS / wall_s:.2f} steps/s, launches {counts}"
    )
    if not all(np.isfinite(losses)) or not losses[-1] < 0.7 * losses[0]:
        fail(f"train: the loss did not fall below 0.7 x its start: {losses}")
    for k, per in (("masked_attention", ATTENTION_PER_STEP),
                   ("masked_attention_bwd", ATTENTION_PER_STEP),
                   ("fused_self_block", 0), ("fused_cross_block", 0)):
        if counts[k] != per * FIXED_BATCH_STEPS:
            fail(f"train: {k}: {counts[k]} launches in {FIXED_BATCH_STEPS} steps, want {per} per step")
    fwd_launches, bwd_launches = counts["masked_attention"], counts["masked_attention_bwd"]

    # One more step in its three parts (CUDA events), then under the profiler.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    optimizer.zero_grad(set_to_none=True)
    ev[0].record()
    loss = matching_loss(params, *(batch[k] for k in _BATCH_KEYS))
    ev[1].record()
    loss.backward()
    ev[2].record()
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    ev[3].record()
    ev[3].synchronize()
    print(
        f"train: one step in parts (CUDA events): forward {ev[0].elapsed_time(ev[1]):.3f} ms, "
        f"backward {ev[1].elapsed_time(ev[2]):.3f} ms, optimizer {ev[2].elapsed_time(ev[3]):.3f} ms"
    )
    profile_device(torch, lambda: train_step(params, optimizer, batch), 1, "step", "train step", top=30)

    # 3. The training script, in-process, on harvested data.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lightglue_smoke.safetensors")
        t0 = time.perf_counter()
        meta = train_script.main([
            "--pairs", str(SCRIPT_PAIRS), "--steps", str(SCRIPT_STEPS),
            "--batch", str(TRAIN_BATCH), "--cap", str(TRAIN_CAP), "--out", out,
            "--sp-weights", os.path.join(REPO, "weights", "superpoint_render.safetensors"),
        ])
        script_s = time.perf_counter() - t0
        loaded = load_safetensors(out, "cuda")
    if len(meta["losses"]) != SCRIPT_STEPS or not all(np.isfinite(meta["losses"])):
        fail(f"train script: losses {meta['losses']}")
    reference = lgm.init_lightglue_params(0)
    if loaded.keys() != reference.keys():
        fail("train script: the checkpoint's names differ from the model's")
    for name, t in loaded.items():
        if t.shape != reference[name].shape or not torch.isfinite(t).all().item():
            fail(f"train script: checkpoint tensor {name} {tuple(t.shape)}")
    print(
        f"train script: {SCRIPT_PAIRS} pairs, {SCRIPT_STEPS} steps in {script_s:.1f} s, loss "
        f"{meta['losses'][0]:.4f} -> {meta['losses'][-1]:.4f}, P/R init "
        f"{meta['precision_init']:.3f}/{meta['recall_init']:.3f} trained "
        f"{meta['precision']:.3f}/{meta['recall']:.3f}, checkpoint of {len(loaded)} tensors loaded back"
    )
    return fwd_launches, bwd_launches


def sp_batch(torch, samples, device):
    """Stacked wire-format samples as tensors on ``device``."""
    return {k: torch.from_numpy(np.stack([x[k] for x in samples])).to(device) for k in samples[0]}


def sp_gradient(torch, params, batch, dtype):
    """sp_loss and its gradient as sp_train_step computes them
    (highest_f32_matmuls), from fresh ``dtype`` leaves of ``params`` on the
    batch's device, with
    superpoint_raw's convolutions in ``dtype`` (its logits and descriptors,
    and so the loss, stay f32)."""
    import functools

    from superslam_tpu_torch.models import superpoint as spm
    from superslam_tpu_torch.ops.precision import highest_f32_matmuls
    from superslam_tpu_torch.train import superpoint_train as spt

    dev = batch["img0"].device
    leaves = {k: v.to(dev, dtype).clone().requires_grad_(True) for k, v in params.items()}
    raw = spt.superpoint_raw
    spt.superpoint_raw = functools.partial(spm.superpoint_raw, compute_dtype=dtype)
    try:
        with highest_f32_matmuls():
            loss, aux = spt.sp_loss(leaves, batch)
            loss.backward()
    finally:
        spt.superpoint_raw = raw
    return loss.item(), {k: v.item() for k, v in aux.items()}, {k: p.grad for k, p in leaves.items()}


def gradient_gap(torch, got, ref) -> tuple[float, str]:
    """The largest max |got - ref| / max |ref| over the parameters, and where."""
    worst, name = 0.0, ""
    for k, r in ref.items():
        g = got[k].to("cpu", torch.float64)
        if not torch.isfinite(g).all().item():
            fail(f"sp train: gradient of {k} is not finite")
        r = r.to(torch.float64)
        gap = (g - r).abs().max().item() / max(r.abs().max().item(), 1e-300)
        if gap > worst:
            worst, name = gap, k
    return worst, name


def dithered(samples, seed: int = 0):
    """The samples with their uint8 images as f32 plus +-1e-4 of uniform
    noise: no 2x2 pooling window of the network then holds two values that
    are equal in exact arithmetic."""
    rng = np.random.default_rng(seed)
    return [{**x, **{k: (x[k] / 255.0 + rng.uniform(-1e-4, 1e-4, x[k].shape)).astype(np.float32)
                     for k in ("img0", "img1")}} for x in samples]


def check_sp_gradient(torch, params, samples, label: str) -> None:
    """The gradient of sp_loss on the card against the CPU's on the same
    batch (every parameter as max |error| over that tensor's largest
    gradient), on a dithered copy of it: uint8 images have flat regions
    whose 2x2 pooling windows hold values equal in exact arithmetic, and the
    last bit of each implementation's sums decides which element takes the
    gradient, so on them two correct implementations part by ~3e-3.

    With the network in f64 on both devices (the loss in f32, as
    superpoint_raw's outputs are): within SP_GRAD_TOL. In f32, the step's
    precision: the card no farther from that f64 gradient than
    SP_F32_SPREAD times the CPU's f32 gradient is (at least SP_GRAD_TOL);
    at these batches the f32 gradient of sp_loss is 1e-3-1.3e-2 of a
    tensor's largest away from the f64 one on either device."""
    f64, f32 = torch.float64, torch.float32
    smooth = dithered(samples)
    loss_c, aux_c, ref = sp_gradient(torch, params, sp_batch(torch, smooth, "cpu"), f64)
    loss_g, aux_g, got = sp_gradient(torch, params, sp_batch(torch, smooth, "cuda"), f64)
    gap64, at64 = gradient_gap(torch, got, ref)
    loss_c32, _, cpu32 = sp_gradient(torch, params, sp_batch(torch, smooth, "cpu"), f32)
    loss_g32, _, card32 = sp_gradient(torch, params, sp_batch(torch, smooth, "cuda"), f32)
    spread_cpu, at_cpu = gradient_gap(torch, cpu32, ref)
    spread_card, at_card = gradient_gap(torch, card32, ref)
    gap32, at32 = gradient_gap(torch, card32, cpu32)
    limit32 = max(SP_GRAD_TOL, SP_F32_SPREAD * spread_cpu)
    print(f"sp train: gradient of sp_loss ({label}, dithered): network in f64, card vs CPU loss "
          f"{loss_g:.7f} vs {loss_c:.7f}, aux {aux_g} vs {aux_c}, gradient {gap64:.3g} at {at64} "
          f"(limit {SP_GRAD_TOL}); in f32 (loss {loss_g32:.7f} card, {loss_c32:.7f} CPU): card "
          f"vs the f64 gradient {spread_card:.3g} at {at_card}, the CPU's {spread_cpu:.3g} at "
          f"{at_cpu} (card limit {limit32:.3g}), card vs CPU {gap32:.3g} at {at32}")
    if not gap64 <= SP_GRAD_TOL or not abs(loss_g - loss_c) <= 1e-5 * abs(loss_c):
        fail(f"sp train ({label}): f64 gradient {gap64} at {at64}, loss {loss_g} vs {loss_c}")
    if not spread_card <= limit32 or not abs(loss_g32 - loss_c32) <= 1e-4 * abs(loss_c32):
        fail(f"sp train ({label}): f32 gradient {spread_card} from f64 > {limit32}, loss "
             f"{loss_g32} vs {loss_c32}")


def check_training_slice(torch) -> None:
    """The training slice on the card (phase 7b of the module docstring):
    SuperPoint's step, the three SuperPoint kernels at its evaluation shapes,
    both training scripts in-process and the matcher's step over the mesh."""
    from scripts import train_eigenplaces_torch as ep_script
    from scripts import train_superpoint_torch as sp_script
    from superslam_tpu_torch.frontend.extractor import SuperPointExtractor
    from superslam_tpu_torch.models import eigenplaces as epm
    from superslam_tpu_torch.models import lightglue as lgm
    from superslam_tpu_torch.models import superpoint as spm
    from superslam_tpu_torch.models.weights import load_params, load_safetensors
    from superslam_tpu_torch.ops.cuda import _build
    from superslam_tpu_torch.parallel.mesh import make_mesh
    from superslam_tpu_torch.parallel.training import (
        make_optimizer,
        sharded_train_step,
        synthetic_matching_batch,
        train_step,
    )
    from superslam_tpu_torch.train import superpoint_train as spt
    from superslam_tpu_torch.train.render_domain import RenderDomainSource
    from superslam_tpu_torch.train.synthetic_shapes import compact_pair, render_shapes

    t_phase = time.perf_counter()
    sp_file = os.path.join(REPO, "weights", "superpoint_render.safetensors")
    rng = np.random.default_rng(14)
    shapes = [compact_pair(rng, SP_H, SP_W) for _ in range(SP_BATCH)]
    source = RenderDomainSource(rng, SP_RENDER_H, SP_RENDER_W, fx=TRAIN_FX)
    renders = [source.two_view_compact(rng) for _ in range(SP_RENDER_BATCH)]
    if not min((r["corr_pts"][:, 0] > -1e5).sum() for r in renders) > 0:
        fail("sp train: a render pair without a corresponding cell")

    # 1. The gradient on the card against the CPU's, both batch forms.
    params_cpu = load_safetensors(sp_file)
    params_cuda = {k: v.to("cuda") for k, v in params_cpu.items()}
    check_sp_gradient(torch, params_cpu, shapes[:SP_GRAD_BATCH],
                      f"wire format, {SP_GRAD_BATCH} x {SP_H}x{SP_W}")
    check_sp_gradient(torch, params_cpu, renders,
                      f"two-view renders, {SP_RENDER_BATCH} x {SP_RENDER_H}x{SP_RENDER_W}")

    # 2. SP_FIXED_STEPS steps on one fixed wire-format batch.
    batch = sp_batch(torch, shapes, "cuda")
    params = {k: v.clone() for k, v in params_cuda.items()}
    optimizer = spt.make_sp_optimizer(params, SP_LR)
    spt.sp_train_step(params, optimizer, batch)  # warm-up: cuDNN plans, optimizer state
    params = {k: v.clone() for k, v in params_cuda.items()}
    optimizer = spt.make_sp_optimizer(params, SP_LR)
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for _ in range(SP_FIXED_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss, _ = spt.sp_train_step(params, optimizer, batch)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    wall_s = time.perf_counter() - t0
    print(f"sp train: {SP_FIXED_STEPS} steps on one fixed batch ({SP_BATCH} x {SP_H}x{SP_W}, "
          f"lr {SP_LR}, f32): loss {' '.join(f'{v:.4f}' for v in losses)}; step median "
          f"{statistics.median(step_ms):.3f} ms (CUDA events), {SP_FIXED_STEPS / wall_s:.2f} steps/s")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"sp train: the loss did not fall on the fixed batch: {losses}")

    # 3. The three SuperPoint kernels at the slice's evaluation shapes, on
    # what the evaluations extract there (a procedural-shapes image at
    # 120x160, a sprite render at 240x320), the conv pairs against f32; and
    # evaluate_detector's launches: 1/1/1 an extraction.
    render_img = source.labeled_image(np.random.default_rng(16))[0]
    for img in (render_shapes(np.random.default_rng(15), SP_H, SP_W)[0], render_img):
        h, w = img.shape
        images = torch.from_numpy(img.astype(np.float32))[None].to("cuda")
        check_superpoint_kernels(torch, params_cuda, images, f"at the training slice's {h}x{w}",
                                 against_f32=True)
    extract, calls = spm.superpoint_extract, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return extract(*args, **kwargs)

    spm.superpoint_extract = counted
    try:
        _build.reset_launch_counts()
        metrics = spt.evaluate_detector(params_cuda, np.random.default_rng(17), n_images=4)
        counts = _build.launch_counts()
    finally:
        spm.superpoint_extract = extract
    per = {k: counts[k] for k in ("conv1a1b", "conv_pair", "scores_nms")}
    print(f"sp train: evaluate_detector on 4 shape images: {json.dumps(metrics)}; {calls[0]} "
          f"extractions, launches {per}")
    if calls[0] < 1 or any(n != calls[0] for n in per.values()):
        fail(f"sp train: evaluate_detector launched {per} in {calls[0]} extractions, want 1/1/1 each")

    # 4. scripts/train_superpoint_torch.py in-process.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "superpoint_smoke.safetensors")
        t0 = time.perf_counter()
        meta = sp_script.main([*SP_SCRIPT_ARGS, "--resume", sp_file, "--out", out])
        script_s = time.perf_counter() - t0
        loaded = load_params(out, lambda: fail("sp script: no checkpoint"), "cuda")
        feats = SuperPointExtractor(loaded, width=SP_RENDER_W, height=SP_RENDER_H,
                                    max_keypoints=256, device="cuda").extract(render_img)
    if loaded.keys() != spm.init_superpoint_params(0).keys():
        fail("sp script: the checkpoint's names differ from the model's")
    if len(meta["losses"]) != 40 or not all(np.isfinite(meta["losses"])):
        fail(f"sp script: losses {meta['losses']}")
    if feats.descriptors.n < 1 or not torch.isfinite(feats.descriptors.desc).all().item():
        fail(f"sp script: extraction on the checkpoint: {feats.descriptors.n} keypoints")
    print(f"sp script: {len(meta['losses'])} steps in {script_s:.1f} s (pools and evaluations "
          f"included), loss {meta['losses'][0]:.4f} -> {meta['losses'][-1]:.4f}, "
          f"{meta['fresh']} fresh samples; evaluations {json.dumps(meta['evals'])}; final "
          f"{json.dumps(meta['eval'])}, render {json.dumps(meta['render_eval'])}; the checkpoint "
          f"loaded back, one extraction on it: {feats.descriptors.n} keypoints")

    # 5. scripts/train_eigenplaces_torch.py in-process, at full width.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "eigenplaces_smoke.safetensors")
        t0 = time.perf_counter()
        meta = ep_script.main([*EP_SCRIPT_ARGS, "--out", out])
        script_s = time.perf_counter() - t0
        loaded = load_params(out, lambda: fail("eigenplaces script: no checkpoint"), "cuda")
    if loaded.keys() != epm.init_eigenplaces_params(0).keys():
        fail("eigenplaces script: the checkpoint's names differ from the model's")
    if len(meta["losses"]) != 30 or not all(np.isfinite(meta["losses"])):
        fail(f"eigenplaces script: losses {meta['losses']}")
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (4, 3, 512, 512)).astype(np.float32)).to("cuda")
    with torch.no_grad():
        desc_tr, stats = epm.eigenplaces_descriptor_train(loaded, x)
    desc_ckpt = epm.eigenplaces_descriptor(loaded, x)
    desc_inf = epm.eigenplaces_descriptor(dict(loaded, **stats), x)
    gap = (desc_tr - desc_inf).abs().max().item()
    norm_err = (desc_ckpt.norm(dim=1) - 1).abs().max().item()
    print(f"eigenplaces script: {len(meta['losses'])} steps in {script_s:.1f} s (renders "
          f"included), loss {meta['losses'][0]:.4f} -> {meta['losses'][-1]:.4f}, step median "
          f"{statistics.median(meta['step_ms'][1:]):.3f} ms (host clock, loss readback "
          f"included; the first step left out), recall@1 {meta['recall_at_1_init']:.3f} -> "
          f"{meta['recall_at_1']:.3f}, platform {meta['platform']}; the checkpoint in "
          f"eigenplaces_descriptor: unit norm within {norm_err:.3g}; the trained forward vs "
          f"eigenplaces_descriptor with its batch statistics merged in: {gap:.3g} (limit 1e-2)")
    if not gap <= 1e-2 or not norm_err <= 1e-4:
        fail(f"eigenplaces script: forward gap {gap}, norm error {norm_err}")

    # 6. The matcher's step over the mesh: (1, 1) on one card, against
    # train_step on the same batch.
    mesh = make_mesh()
    if mesh.devices.shape != (1, 1):
        fail(f"mesh: {mesh.devices.shape} on {torch.cuda.device_count()} card(s)")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             synthetic_matching_batch(np.random.default_rng(19), TRAIN_BATCH, TRAIN_CAP).items()}
    ref_params = lgm.init_lightglue_params(1, device="cuda")
    ref_loss = float(train_step(ref_params, make_optimizer(ref_params, TRAIN_LR), batch))
    params = lgm.init_lightglue_params(1, device="cuda")
    optimizer = make_optimizer(params, TRAIN_LR)
    _build.reset_launch_counts()
    loss = float(sharded_train_step(params, optimizer, batch, mesh))
    counts = _build.launch_counts()
    worst = max((p - ref_params[k]).abs().max().item() for k, p in params.items())
    print(f"mesh step on the (1, 1) mesh vs train_step: loss {loss:.7f} vs {ref_loss:.7f}, "
          f"parameters within {worst:.3g} (limit 1e-6); launches masked_attention "
          f"{counts['masked_attention']}, masked_attention_bwd {counts['masked_attention_bwd']}")
    if not abs(loss - ref_loss) <= 1e-6 * abs(ref_loss) or not worst <= 1e-6:
        fail(f"mesh step: loss {loss} vs {ref_loss}, parameters {worst}")
    for k in ("masked_attention", "masked_attention_bwd"):
        if counts[k] != ATTENTION_PER_STEP:
            fail(f"mesh step: {k} {counts[k]} launches, want {ATTENTION_PER_STEP}")
    print(f"training slice phase: {time.perf_counter() - t_phase:.1f} s")


def check_profiler(torch) -> dict[str, int]:
    """Every stage of scripts/profile_stages_torch.py at the KITTI shape;
    returns the launches of the three conv kernels only it drives."""
    from scripts import profile_stages_torch as prof
    from superslam_tpu_torch.ops.cuda import _build

    _build.reset_launch_counts()
    results = prof.run_stages(None, "cuda")
    counts = _build.launch_counts()
    if list(results) != list(prof.STAGES):
        fail(f"profiler: stages {list(results)}")
    print("profiler: stage times at 2 x 384 x 1248, 600 keypoints (CUDA events, median of 20):")
    for name, ms in results.items():
        print(f"profiler:   {name:16s} {ms:9.4f} ms")
        if not np.isfinite(ms) or ms <= 0:
            fail(f"profiler: stage {name}: {ms}")
    only_here = {k: counts[k] for k in ("conv1a1b_full", "conv_pair_full", "conv3x3")}
    for k, n in only_here.items():
        if n < 1:
            fail(f"profiler: {k} was not launched")
    return only_here


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import superslam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the superslam_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not readable"
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch.cuda.get_device_name: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from scripts.accuracy_suite_torch import leg_environment as pinned_env
    from superslam_tpu_torch.models.weights import load_safetensors
    from superslam_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds} s)")
    report_build(_build.BUILD_DIR)
    # The host estimator's C++ core (csrc/, built with make at first use):
    # build it here so the build is set-up, not part of the timed loop.
    from superslam_tpu_torch import native

    t0 = time.perf_counter()
    print(f"native host core: available={native.available()} ({time.perf_counter() - t0:.1f} s)")

    sp = load_safetensors(os.path.join(REPO, "weights", "superpoint_render.safetensors"), "cuda")
    lg = load_safetensors(os.path.join(REPO, "weights", "lightglue_synth.safetensors"), "cuda")
    frames, gt = render_sequence(N_FRAMES, WIDTH, HEIGHT)
    kernels = check_kernels(torch, sp, lg, frames[0])

    for knob in ("SUPERSLAM_PALLAS_LG", "SUPERSLAM_PALLAS_ATTN", "SUPERSLAM_PIPELINE",
                 "SUPERSLAM_PIPELINE_BATCH", "SUPERSLAM_DEVICE_TRACKER", "SUPERSLAM_DEVICE_KF"):
        os.environ.pop(knob, None)  # the facade's defaults
    os.environ["SUPERSLAM_PROFILE"] = "1"  # the host estimator's scopes
    with pinned_env(DEPTH0_ENV):
        slam, poses, step_ms, loop_s, counts, n_kf, est_ms = run_facade(
            torch, frames, WIDTH, HEIGHT, MAX_KP
        )
    check_facade_run("fused route", slam, poses, gt, step_ms, loop_s, counts, n_kf,
                     PER_FRAME_FUSED, est_ms)
    slam_d, counts_d, captured, scan_call = run_default_facade(torch, frames, gt)
    run_reversed_pair(torch, frames, gt)
    del os.environ["SUPERSLAM_PROFILE"]
    kernels["track_frame"] = check_track_frame(torch, captured)
    kernels["pose_solve"] = check_pose_solve(torch, [solve_call(c) for c in captured])
    time_design_costs(torch, slam_d, captured)
    mid_call = captured[len(captured) // 2]
    del captured
    run_accuracy_legs(torch)
    # RGB-D: its kernels at its shapes, the facade host-solved at depth 0 and
    # as a user gets it (depth 3, device-tracked), distorted; then the loop's
    # pieces. The loop legs' workers have stopped: none runs inside a
    # sync-checked window.
    rgbd_frames, rgbd_gt = render_rgbd_sequence(RGBD_FRAMES + RGBD_PROFILE_FRAMES)
    check_rgbd_kernels(torch, sp, lg, rgbd_frames[0][0])
    frames_r, gt_r = rgbd_frames[:RGBD_FRAMES], rgbd_gt[:RGBD_FRAMES]
    with pinned_env({**DEPTH0_ENV, "SUPERSLAM_PROFILE": "1"}):
        slam_r0, _ = run_rgbd_facade(torch, frames_r, gt_r, "depth 0, host-solved")
    slam_r0.shutdown()
    with pinned_env({"SUPERSLAM_PROFILE": "1"}):
        slam_r, captured_r = run_rgbd_facade(torch, frames_r, gt_r, "default")
    if not (slam_r._tracker and slam_r._tracker.depth == 3 and slam_r._tracker.device_tracking):
        fail(f"rgbd facade (default): {facade_mode(slam_r)}, want depth 3, device-tracked")
    check_track_frame_mono(torch, captured_r)
    del captured_r
    check_distorted_rgbd(torch, frames_r[:RGBD_DIST_FRAMES])
    check_loop_pieces(torch, rgbd_frames[0][0])
    # Multi-sequence batched tracking: the frame kernels at its shapes, the
    # tracker ABBA against S = 1, each sequence against its run alone; then
    # batched_track_scan, the device window solver and the viewer.
    multi_seqs, multi_gt = multi_sequence_frames(N_FRAMES + MULTI_PROFILE_STEPS)
    check_multi_kernels(torch, sp, lg, [seq[0] for seq in multi_seqs])
    multi = run_multi_phase(torch, sp, lg, multi_seqs, multi_gt)
    kernels["track_frame_batched"], batched_launches = check_batched_track_scan(torch)
    run_xla_smoother_facade(torch, frames, gt)
    check_viewer(torch, frames[:VIEWER_FRAMES])
    # The tooling: bench_torch.py's run at batch 4, then the dataset runners
    # and the evaluators as a user runs them.
    t_tools = time.perf_counter()
    check_bench_run(torch)
    check_runners()
    print(f"tooling phase: {time.perf_counter() - t_tools:.1f} s", flush=True)
    depth0_events = profile_facade(torch, slam, 5)
    slam.shutdown()

    n_u = N_FRAMES_UNFUSED
    with pinned_env({**DEPTH0_ENV, "SUPERSLAM_PALLAS_LG": "0", "SUPERSLAM_PROFILE": "1"}):
        slam_u, poses_u, step_ms_u, loop_s_u, counts_u, n_kf_u, est_ms_u = run_facade(
            torch, frames[:n_u], WIDTH, HEIGHT, MAX_KP
        )
    slam_u.shutdown()
    check_facade_run(
        "unfused route", slam_u, poses_u, gt[:n_u], step_ms_u, loop_s_u, counts_u, n_kf_u,
        PER_FRAME_UNFUSED, est_ms_u,
    )
    gap = max(float(np.linalg.norm(a.t - b.t)) for a, b in zip(poses[:n_u], poses_u))
    print(f"routes: largest per-frame position gap fused vs unfused over {n_u} frames {gap:.4f} m")

    gather_launches = check_extractor_kernel_route(torch, sp, *frames[0])
    map_nms_launches = check_map_mode(torch, sp, *frames[0])

    f32_fwd_launches, bwd_launches = check_training(torch)
    check_training_slice(torch)
    profiler_launches = check_profiler(torch)
    # Profiles after every timed phase: a profiler session slows the
    # launches that follow it on the host.
    profile_score_half(torch, sp, *frames[0])
    profile_gather(torch, sp, *frames[0])
    check_scan_body(torch, scan_call)
    profile_solve_kernels(torch, mid_call)
    del scan_call, mid_call
    profile_default(torch, slam_d, 5, depth0_events)
    slam_d.shutdown()
    profile_rgbd(torch, slam_r, rgbd_frames[RGBD_FRAMES:])
    slam_r.shutdown()
    profile_multi(torch, multi, multi_seqs)

    # Each kernel's launches are those of the phase that drives it: the main
    # path's from the default facade's frames 5..29.
    launches = {k: counts_d[k] for k, per in PER_FRAME_DEFAULT.items() if per}
    launches.update((k, counts_d[k]) for k in OFF_PATH)  # 0: on no path, timed in 4c
    launches["masked_attention"] = counts_u["masked_attention"]
    launches["track_frame_batched"] = batched_launches
    launches["gather_normalize"] = gather_launches
    launches["nms"] = map_nms_launches
    launches["masked_attention_f32"] = f32_fwd_launches
    launches["masked_attention_bwd"] = bwd_launches
    launches.update(profiler_launches)
    rows = []
    for k in KERNEL_INFO:
        if launches[k] < 1 and k not in OFF_PATH:
            fail(f"{k}: no launch on the path that should drive it")
        rows.append({**kernels[k], "launches": launches[k]})
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
