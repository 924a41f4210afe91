#!/usr/bin/env python3
"""Time the zero-lag keyframe step of the PyTorch/CUDA port at the bench's
shapes (KITTI 1241x376, 600 keypoints), one dispatch of ``--batch`` frames.

The port's counterpart of ``scripts/probe_device_kf.py``. Three legs, each
first run once (the first call's set-up and a check that it runs), then
looped on the device with its keyframe state and pose carry threaded
through and each iteration's images derived on the device from the last
output, timed per frame by the same differencing as ``bench_torch.py``
(``difference_ms``: 12 against 3 dispatches, the smallest of 3 samples):

- hybrid: ``fused_stereo_track_kf_step_multi`` with the batched keyframe
  match (the default);
- rematch-always: the same step with ``hybrid=False`` (every frame
  re-matches at pair-batch 1);
- nokf track: the dispatch-frozen ``fused_stereo_track_step_multi``.

Random-init weights (the times do not depend on them). Runs on CUDA
unless ``--device cpu`` is given.

Usage:  python scripts/probe_device_kf_torch.py [--batch 4] [--width 1241 ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import (  # noqa: E402
    difference_ms,
    identity_carry,
    next_images,
    zero_kf_state,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--max-keypoints", type=int, default=600)
    ap.add_argument("--batch", type=int, default=1, help="frames per dispatch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    import torch

    from superslam_tpu_torch.core.keyframe_gate import MIN_FRAMES_DEFAULT, MIN_MATCHES_DEFAULT
    from superslam_tpu_torch.frontend.extractor import pad_to_multiple
    from superslam_tpu_torch.models.lightglue import init_lightglue_params, prepare_params
    from superslam_tpu_torch.models.superpoint import (
        init_superpoint_params,
        prepare_superpoint_params,
    )
    from superslam_tpu_torch.ops.frontend_step import (
        fused_stereo_track_kf_step_multi,
        fused_stereo_track_step_multi,
    )
    from superslam_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})")
    W, H, K, S = args.width, args.height, args.max_keypoints, args.batch
    pw, ph = pad_to_multiple(W), pad_to_multiple(H)
    sp = prepare_superpoint_params(init_superpoint_params(0), device)
    lg = prepare_params(init_lightglue_params(0, passthrough=True), device)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 255, (2 * S, ph, pw), dtype=np.uint8)).to(device)

    common = dict(
        max_keypoints=K, keypoint_threshold=0.0005, remove_borders=4, nms_radius=4,
        true_width=W, true_height=H, min_disparity=1.0, match_threshold=0.1,
        calib=(718.856, 718.856, 607.1928, 185.2157, 386.1448 / 718.856),
        min_matches=10, track_sigma_px=10.0, disp_sigma0=8.0, disp_cond=386.1448 / 40.0,
    )
    kf_kw = dict(
        accept_frac=0.4, support_px=4.0, kf_min_frames=MIN_FRAMES_DEFAULT, kf_max_frames=20,
        kf_min_matches=MIN_MATCHES_DEFAULT, covis_ratio=0.3,
    )

    z = zero_kf_state(K, device)  # the dispatch-frozen leg's keyframe: all invalid

    def step_nokf(im, kf, carry):
        packed, _d, _k, _v, track, carry = fused_stereo_track_step_multi(
            sp, lg, im, z[0], z[1], z[2], z[3], z[4], *carry, **common
        )
        return packed, track, kf, carry

    def step_kf(hybrid):
        def f(im, kf, carry):
            packed, _d, _k, _v, track, kf, carry = fused_stereo_track_kf_step_multi(
                sp, lg, im, kf, carry, hybrid=hybrid, **common, **kf_kw
            )
            return packed, track, kf, carry
        return f

    legs = [
        ("hybrid", step_kf(True)),
        ("rematch-always", step_kf(False)),
        ("nokf track (dispatch-frozen)", step_nokf),
    ]
    for tag, step in legs:
        t0 = time.perf_counter()
        packed, track, _kf, _carry = step(imgs, zero_kf_state(K, device), identity_carry(device))
        track.cpu()
        print(f"[{tag}] single dispatch, first call: {time.perf_counter() - t0:.1f} s "
              f"(packed {tuple(packed.shape)})")

        def run(iters, step=step):
            im, kf, carry = imgs, zero_kf_state(K, device), identity_carry(device)
            for _ in range(iters):
                packed, track, kf, carry = step(im, kf, carry)
                im = next_images(im, packed)
            return track

        ms = difference_ms(run, device) / S
        print(f"[{tag}] device-only per frame: {ms:.3f} ms at batch {S}")


if __name__ == "__main__":
    main()
