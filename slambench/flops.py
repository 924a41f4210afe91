"""The work of the front end, counted from the configuration's shapes.

The benchmark's own arithmetic (the operations and bytes of the kernel
table's bound column, for whole models), so that a roofline reads the same
work whatever kernels do it: SuperPoint's here, the matcher's in its
module (``matchers/<matcher>.py::work``) by the same conventions.
Operations are 2 x multiply-adds of the convolutions, linear layers and
attention products. Bytes are the least a device must move: each input
and weight read once, each output written once. Peaks: one H100 SXM,
dense bf16, f32 outside the tensor cores and HBM3 (NVIDIA's data sheet).

A matcher's work may come in parts. ``matchers/<matcher>.py::work`` is
what its kernels in the ``matcher`` layer do; an optional
``parts(cfg, n0, n1)`` gives ``{layer: (operations, bytes, peak
operations/s)}`` for kernels that a layer file of their own
(``layers/<layer>.json``) takes out of that layer, such as an iterative
normalisation on the CUDA cores, priced at its own peak. Each operation is
counted once, in ``work`` or in one part.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
F32_PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# SuperPoint: (name, in channels, out channels, kernel, pools before it)
SUPERPOINT = (
    ("conv1a", 1, 64, 3, 0), ("conv1b", 64, 64, 3, 0),
    ("conv2a", 64, 64, 3, 1), ("conv2b", 64, 64, 3, 1),
    ("conv3a", 64, 128, 3, 2), ("conv3b", 128, 128, 3, 2),
    ("conv4a", 128, 128, 3, 3), ("conv4b", 128, 128, 3, 3),
    ("convPa", 128, 256, 3, 3), ("convPb", 256, 65, 1, 3),
    ("convDa", 128, 256, 3, 3), ("convDb", 256, 256, 1, 3),
)


def _least_size(x: int) -> int:
    """SuperPoint's three 2x2 pools need a multiple of 8."""
    return (x + 7) // 8 * 8


def superpoint_flops(height: int, width: int) -> float:
    h, w = _least_size(height), _least_size(width)
    total = 0.0
    for _name, cin, cout, k, pools in SUPERPOINT:
        total += 2.0 * k * k * cin * cout * (h >> pools) * (w >> pools)
    return total


def superpoint_params() -> int:
    return sum(k * k * cin * cout + cout for _n, cin, cout, k, _p in SUPERPOINT)


def superpoint_bytes(height: int, width: int, keypoints: int, dim: int = 256) -> float:
    """The uint8 frame and the bf16 weights in; keypoints (2 f32), validity
    (1 byte) and f32 descriptors out."""
    return (height * width + 2.0 * superpoint_params()
            + keypoints * (2 * 4 + 1 + dim * 4))


def least_seconds(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def matcher_parts(matcher, config: dict, n0: int, n1: int) -> dict:
    """The matcher module's ``parts`` of one pair problem; none without."""
    parts = getattr(matcher, "parts", None)
    return parts(config, n0, n1) if parts is not None else {}


def window_work(config: dict, matcher, dispatches: list) -> dict:
    """The operations and bytes the dispatches need: each is (images,
    [(n0, n1) of each pair problem]), the pairs counted at the keypoints
    each side has (what these inputs need, not the K a step pads to) by
    ``matcher.work``, the configuration's matcher module's, and under
    ``"parts"`` by its ``parts``: {layer: (operations, bytes, peak)}."""
    cam, sp = config["camera"], config["superpoint"]
    K, dim = sp["max_keypoints"], sp["descriptor_dim"]
    images = sum(n for n, _pairs in dispatches)
    problems = [(a, b) for _n, ps in dispatches for a, b in ps]
    pairs = [matcher.work(config, a, b) for a, b in problems]
    parts: dict = {}
    for a, b in problems:
        for layer, (f, nb, peak) in matcher_parts(matcher, config, a, b).items():
            f0, b0, p0 = parts.get(layer, (0.0, 0.0, peak))
            if p0 != peak:
                raise ValueError(f"part {layer!r} names two peaks, {p0} and {peak}")
            parts[layer] = (f0 + f, b0 + nb, peak)
    return {
        "detector_flops": images * superpoint_flops(cam["height"], cam["width"]),
        "detector_bytes": images * superpoint_bytes(cam["height"], cam["width"], K, dim),
        "matcher_flops": sum(f for f, _b in pairs),
        "matcher_bytes": sum(b for _f, b in pairs),
        "parts": parts,
    }
