"""EigenPlaces place-recognition embedding (ResNet18 -> GeM -> 512-d).

Port of ``superslam_tpu/models/eigenplaces.py``: a ResNet18 backbone (no
avgpool/fc) followed by the EigenPlaces aggregation head (L2Norm -> GeM
pooling -> Linear(512, fc_dim) -> L2Norm) on an ImageNet-normalized RGB
input, producing one L2-normalized global descriptor. Functions on a flat
parameter dict in torch layout (OIHW convs, (out, in) linear), NCHW.

The convolutions are PyTorch's (cuDNN on the card): the JAX package runs
them as XLA convolutions, not Pallas kernels. They round where the JAX
package rounds: each conv in bf16 (bf16 output), each batch norm in f32
from the running statistics and cast back to bf16, the residual sum in
bf16; the aggregation in f32. Images are resized with antialiasing, as
``jax.image.resize(..., "bilinear")`` does when it downsamples.
``eigenplaces_descriptor_train`` is the training forward: the same network
with batch norm from the batch's own statistics (the biased variance, as
``jnp.var``), which it returns for the trainer to EMA into the running
statistics.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# ResNet18 stage plan: (name, blocks, out_channels, first_stride)
_STAGES = [
    ("layer1", 2, 64, 1), ("layer2", 2, 128, 2), ("layer3", 2, 256, 2), ("layer4", 2, 512, 2),
]


def _conv(x, params: Params, name: str, stride: int, dtype):
    w = params[f"{name}.weight"].to(dtype)  # OIHW
    # Symmetric k//2 padding (torch semantics).
    return F.conv2d(x.to(dtype), w, stride=stride, padding=w.shape[-1] // 2)


def _bn(x, params: Params, name: str, dtype):
    """Inference batch norm from the running statistics, in f32."""
    g = params[f"{name}.weight"].float()
    b = params[f"{name}.bias"].float()
    mean = params[f"{name}.running_mean"].float()
    var = params[f"{name}.running_var"].float()
    scale = g * torch.rsqrt(var + 1e-5)
    shift = b - mean * scale
    return (x.float() * scale[:, None, None] + shift[:, None, None]).to(dtype)


def _basic_block(x, params: Params, name: str, stride: int, dtype):
    out = _conv(x, params, f"{name}.conv1", stride, dtype)
    out = F.relu(_bn(out, params, f"{name}.bn1", dtype))
    out = _conv(out, params, f"{name}.conv2", 1, dtype)
    out = _bn(out, params, f"{name}.bn2", dtype)
    if f"{name}.downsample.0.weight" in params:
        x = _conv(x, params, f"{name}.downsample.0", stride, dtype)
        x = _bn(x, params, f"{name}.downsample.1", dtype)
    return F.relu(out + x)


def resnet18_features(params: Params, image: torch.Tensor, dtype=torch.bfloat16):
    """(B, 3, H, W) normalized RGB -> (B, 512, H/32, W/32) feature map."""
    x = _conv(image, params, "backbone.conv1", 2, dtype)  # 7x7 s2
    x = F.relu(_bn(x, params, "backbone.bn1", dtype))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, blocks, _, first_stride in _STAGES:
        for b in range(blocks):
            x = _basic_block(
                x, params, f"backbone.{stage}.{b}", first_stride if b == 0 else 1, dtype
            )
    return x


def _l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + 1e-12)


@torch.inference_mode()
def eigenplaces_descriptor(params: Params, image: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) ImageNet-normalized RGB -> (B, Dg) L2-normalized global
    descriptor. Aggregation: L2Norm -> GeM(p) -> Linear -> L2Norm, in f32."""
    feat = _l2_normalize(resnet18_features(params, image).float(), 1)
    p = params["aggregation.1.p"].float().reshape(())
    pooled = torch.mean(torch.clamp(feat, min=1e-6) ** p, dim=(2, 3)) ** (1.0 / p)
    out = pooled @ params["aggregation.3.weight"].float().t()
    out = out + params["aggregation.3.bias"].float()
    return _l2_normalize(out, -1)


def _bn_batch(x, params: Params, name: str, dtype, stats: dict):
    """Train-mode batch norm: normalize by THIS batch's statistics and
    record them in ``stats`` (detached) for the caller to EMA into the
    running statistics that ``_bn`` reads. The variance is the biased one,
    as ``jnp.var``; ``F.batch_norm``'s running update would EMA the unbiased
    variance instead, so the statistics are computed here."""
    xf = x.float()
    mean = torch.mean(xf, dim=(0, 2, 3))
    var = torch.mean(torch.square(xf - mean[:, None, None]), dim=(0, 2, 3))
    stats[f"{name}.running_mean"] = mean.detach()
    stats[f"{name}.running_var"] = var.detach()
    g = params[f"{name}.weight"].float()
    b = params[f"{name}.bias"].float()
    scale = g * torch.rsqrt(var + 1e-5)
    shift = b - mean * scale
    return (xf * scale[:, None, None] + shift[:, None, None]).to(dtype)


def _basic_block_train(x, params: Params, name: str, stride: int, dtype, stats: dict):
    out = _conv(x, params, f"{name}.conv1", stride, dtype)
    out = F.relu(_bn_batch(out, params, f"{name}.bn1", dtype, stats))
    out = _conv(out, params, f"{name}.conv2", 1, dtype)
    out = _bn_batch(out, params, f"{name}.bn2", dtype, stats)
    if f"{name}.downsample.0.weight" in params:
        x = _conv(x, params, f"{name}.downsample.0", stride, dtype)
        x = _bn_batch(x, params, f"{name}.downsample.1", dtype, stats)
    return F.relu(out + x)


def eigenplaces_descriptor_train(params: Params, image: torch.Tensor, dtype=torch.bfloat16):
    """Training forward (scripts/train_eigenplaces_torch.py): the math of
    ``eigenplaces_descriptor`` except that batch norm uses the batch's
    statistics; differentiable. (B, 3, H, W) ImageNet-normalized RGB ->
    (L2-normalized (B, Dg) f32 descriptors, {BN running-stat name: batch
    statistic}) so the trainer can EMA the statistics the inference forward
    uses."""
    stats: dict[str, torch.Tensor] = {}
    x = _conv(image, params, "backbone.conv1", 2, dtype)
    x = F.relu(_bn_batch(x, params, "backbone.bn1", dtype, stats))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for stage, blocks, _, first_stride in _STAGES:
        for b in range(blocks):
            x = _basic_block_train(
                x, params, f"backbone.{stage}.{b}", first_stride if b == 0 else 1, dtype, stats
            )
    feat = _l2_normalize(x.float(), 1)
    p = params["aggregation.1.p"].float().reshape(())
    pooled = torch.mean(torch.clamp(feat, min=1e-6) ** p, dim=(2, 3)) ** (1.0 / p)
    out = pooled @ params["aggregation.3.weight"].float().t()
    out = out + params["aggregation.3.bias"].float()
    return _l2_normalize(out, -1), stats


def _resize(img: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size, size), bilinear, antialiased when it
    downsamples (jax.image.resize's bilinear)."""
    if img.shape[-2:] == (size, size):
        return img
    return F.interpolate(img, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, std) as (3, 1, 1) tensors, made once per device."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device)[:, None, None],
            torch.from_numpy(IMAGENET_STD).to(device)[:, None, None])


def _imagenet_normalize(img: torch.Tensor) -> torch.Tensor:
    mean, std = _imagenet_stats(img.device)
    return (img - mean) / std


@torch.inference_mode()
def eigenplaces_descriptor_from_device_gray(
    params: Params,
    gray_u8: torch.Tensor,  # (H, W) uint8, device-resident (may be padded)
    true_height: int,
    true_width: int,
    size: int = 512,
) -> torch.Tensor:
    """Global descriptor straight from a device-resident tracking frame: the
    fused step's own uint8 upload is sliced to the true image, scaled,
    resized, replicated to RGB and ImageNet-normalized on the device, then
    the ResNet18 + GeM forward. Matches preprocess_image +
    eigenplaces_descriptor to resize precision. Returns (Dg,) f32."""
    img = gray_u8[:true_height, :true_width].float() / 255.0
    img = _resize(img[None, None], size).expand(1, 3, size, size)
    return eigenplaces_descriptor(params, _imagenet_normalize(img))[0]


def preprocess_image(image: np.ndarray, size: int = 512, device="cpu") -> torch.Tensor:
    """Gray/BGR uint8 or float -> (1, 3, size, size) ImageNet-normalized RGB
    on ``device`` (the image is uploaded as it is and converted there).

    Mirrors the reference preprocessing (src/EigenPlaces.cc:123-143): gray is
    replicated to 3 channels; BGR is flipped to RGB; bilinear resize."""
    img = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    else:
        img = img.float()
        if img.max() > 1.5:  # a host read: float input of 0..255
            img = img / 255.0
    if img.dim() == 2:
        img = img[None].expand(3, -1, -1)
    else:
        img = img.flip(-1).permute(2, 0, 1)  # BGR -> RGB (reference convention)
    return _imagenet_normalize(_resize(img[None], size))


# -- parameter init -----------------------------------------------------------


def init_eigenplaces_params(
    seed: int = 0, fc_dim: int = 512, device="cpu", dtype=torch.float32
) -> Params:
    """Random parameters, the JAX package's init (the same draws in the same
    order, laid out OIHW and (out, in)): the random-place ablation and
    ``load_params``' fallback."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k):
        std = float(np.sqrt(2.0 / (k * k * cin)))
        w = rng.standard_normal((k, k, cin, cout)) * std  # HWIO, as drawn
        params[f"{name}.weight"] = w.transpose(3, 2, 0, 1)

    def bn(name, c):
        params[f"{name}.weight"] = np.ones(c)
        params[f"{name}.bias"] = np.zeros(c)
        params[f"{name}.running_mean"] = np.zeros(c)
        params[f"{name}.running_var"] = np.ones(c)

    conv("backbone.conv1", 3, 64, 7)
    bn("backbone.bn1", 64)
    cin = 64
    for stage, blocks, cout, first_stride in _STAGES:
        for b in range(blocks):
            name = f"backbone.{stage}.{b}"
            stride = first_stride if b == 0 else 1
            conv(f"{name}.conv1", cin if b == 0 else cout, cout, 3)
            bn(f"{name}.bn1", cout)
            conv(f"{name}.conv2", cout, cout, 3)
            bn(f"{name}.bn2", cout)
            if b == 0 and (stride != 1 or cin != cout):
                conv(f"{name}.downsample.0", cin, cout, 1)
                bn(f"{name}.downsample.1", cout)
        cin = cout
    params["aggregation.1.p"] = np.asarray(3.0)
    params["aggregation.3.weight"] = (
        rng.standard_normal((512, fc_dim)) * np.sqrt(1.0 / 512)
    ).T
    params["aggregation.3.bias"] = np.zeros(fc_dim)
    return {
        k: torch.from_numpy(np.array(v, np.float32, order="C")).to(device=device, dtype=dtype)
        for k, v in params.items()
    }
