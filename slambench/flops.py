"""The work of the front end, counted from the configuration's shapes.

The benchmark's own arithmetic (the operations and bytes of the kernel
table's bound column, for whole models), so that a roofline reads the same
work whatever kernels do it. Operations are 2 x multiply-adds of the
convolutions, linear layers and attention products. Bytes are the least a
device must move: each input and weight read once, each output written
once. Peaks: one H100 SXM, dense bf16 and HBM3 (NVIDIA's data sheet).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
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


def lightglue_linear_params(dim: int, layers: int) -> int:
    """Weights of the linear layers (bias included)."""
    lin = lambda i, o: i * o + o  # noqa: E731
    per_layer = (lin(dim, 3 * dim) + lin(dim, dim) + lin(2 * dim, 2 * dim) + lin(2 * dim, dim)
                 + 3 * lin(dim, dim) + lin(2 * dim, 2 * dim) + lin(2 * dim, dim))
    return lin(dim, dim) + layers * per_layer + lin(dim, dim) + lin(dim, 1)


def lightglue_flops(n0: int, n1: int, dim: int, layers: int, heads: int) -> float:
    """One pair problem with n0 and n1 keypoints."""
    tokens = n0 + n1
    per_token = (
        2 * dim * 3 * dim + 2 * dim * dim + 2 * (2 * dim) * (2 * dim) + 2 * (2 * dim) * dim  # self
        + 3 * 2 * dim * dim + 2 * (2 * dim) * (2 * dim) + 2 * (2 * dim) * dim  # cross
    )
    attention = 4.0 * dim * (n0 * n0 + n1 * n1) + 8.0 * dim * n0 * n1  # QK^T and PV, both blocks
    head = 2.0 * dim * dim * tokens + 2.0 * n0 * n1 * dim + 2.0 * dim * tokens  # assignment
    rotary = 2.0 * 2 * (dim // heads // 2) * tokens  # the positional projection
    return 2.0 * dim * dim * tokens + layers * (per_token * tokens + attention) + head + rotary


def lightglue_bytes(n0: int, n1: int, dim: int, layers: int) -> float:
    """Keypoints (2 f32), validity and f32 descriptors of both sides and the
    bf16 weights in; one int32 match index a row of side 0 out."""
    return (n0 + n1) * (2 * 4 + 1 + dim * 4) + 2.0 * lightglue_linear_params(dim, layers) + 4.0 * n0


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def window_work(config: dict, dispatches: list) -> dict:
    """The operations and bytes the dispatches need: each is (images,
    [(n0, n1) of each pair problem]), the pairs counted at the keypoints
    each side has (what these inputs need, not the K a step pads to)."""
    cam, sp, lg = config["camera"], config["superpoint"], config["lightglue"]
    K, dim, layers, heads = sp["max_keypoints"], lg["width"], lg["layers"], lg["heads"]
    images = sum(n for n, _pairs in dispatches)
    pairs = [p for _n, ps in dispatches for p in ps]
    return {
        "detector_flops": images * superpoint_flops(cam["height"], cam["width"]),
        "detector_bytes": images * superpoint_bytes(cam["height"], cam["width"], K, dim),
        "matcher_flops": sum(lightglue_flops(a, b, dim, layers, heads) for a, b in pairs),
        "matcher_bytes": sum(lightglue_bytes(a, b, dim, layers) for a, b in pairs),
    }
