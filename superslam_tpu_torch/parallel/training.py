"""Self-supervised fine-tuning step for the matcher, on one device.

Port of ``superslam_tpu/parallel/training.py``: ``matching_loss`` (the
negative log-likelihood of a ground-truth assignment under LightGlue's
log-assignment), ``train_step`` (one AdamW step on it) and
``synthetic_matching_batch`` (i <-> i self-supervision from numpy). The
forward is the unfused LightGlue route in f32, so every attention call goes
through ``ops/cuda/attention.py::masked_attention`` and is differentiated by
its hand-written backward: 18 forward and 18 backward launches per step.

The JAX package runs the step under ``jit`` over a (data, model) mesh;
``train_step`` is the step on one device and ``sharded_train_step`` the
step over the port's mesh (``parallel/mesh.py``): data-parallel over its
data axis, tensor-parallel over its model axis
(``parallel/tensor_parallel.py``). Parameters are a flat dict of leaf
tensors that require grad, updated in place by the optimizer.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..models.lightglue import lightglue_forward
from .mesh import Mesh
from .tensor_parallel import tensor_parallel_forward

Params = dict[str, torch.Tensor]


def _nll_sum(
    params: Params,
    kpts0: torch.Tensor,
    desc0: torch.Tensor,
    kpts1: torch.Tensor,
    desc1: torch.Tensor,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
    gt_indices: torch.Tensor,
) -> torch.Tensor:
    """The numerator of ``matching_loss``: the summed negative
    log-likelihood over the batch's valid rows."""
    la = lightglue_forward(
        params, kpts0, desc0, kpts1, desc1, mask0, mask1,
        compute_dtype=torch.float32, fused=False,
    )
    return _assignment_nll(la, mask0, gt_indices)


def _assignment_nll(
    la: torch.Tensor, mask0: torch.Tensor, gt_indices: torch.Tensor
) -> torch.Tensor:
    """The summed NLL of the ground truth under the log-assignment ``la``."""
    matched = gt_indices >= 0
    safe_idx = torch.where(matched, gt_indices, 0).to(torch.int64)
    picked = torch.gather(la, 2, safe_idx[..., None])[..., 0]
    zero = torch.zeros_like(picked)
    pos_nll = -torch.where(matched & mask0, picked, zero)

    row_mass = torch.sum(torch.exp(la), dim=2)  # (B, K)
    neg_nll = -torch.where(
        (~matched) & mask0, torch.log1p(-torch.clamp(row_mass, 0.0, 1.0 - 1e-6)), zero
    )
    return pos_nll.sum() + neg_nll.sum()


def _denominator(mask0: torch.Tensor) -> torch.Tensor:
    return torch.clamp(mask0.sum().to(torch.float32), min=1.0)


def matching_loss(
    params: Params,
    kpts0: torch.Tensor,
    desc0: torch.Tensor,
    kpts1: torch.Tensor,
    desc1: torch.Tensor,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
    gt_indices: torch.Tensor,  # (B, K) index into set1, -1 = unmatched
) -> torch.Tensor:
    """Negative log-likelihood of the ground-truth assignment, over the
    valid rows of set 0.

    Matched rows: -log P(i -> gt_i). Unmatched rows: -log(1 - sum_j P(i,j))
    (the dual-softmax 'dustbin' mass), clamped for stability.
    """
    nll = _nll_sum(params, kpts0, desc0, kpts1, desc1, mask0, mask1, gt_indices)
    return nll / _denominator(mask0)


def make_optimizer(params: Params, lr: float = 1e-4) -> torch.optim.Optimizer:
    """AdamW as the JAX package's ``optax.adamw(lr)``: betas (0.9, 0.999),
    eps 1e-8, weight decay 1e-4 on every parameter (PyTorch's own default
    decay is 1e-2). Marks the parameters as requiring grad."""
    for p in params.values():
        p.requires_grad_(True)
    return torch.optim.AdamW(
        list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


_BATCH_KEYS = ("kpts0", "desc0", "kpts1", "desc1", "mask0", "mask1", "gt_indices")


def _apply_update(params: Params, optimizer: torch.optim.Optimizer, lr: float | None) -> None:
    """The optimizer's step on the gradients in ``.grad``. A parameter the
    loss does not read (the assignment heads of layers 0..7) gets a zero
    gradient, not none, so AdamW still decays it as the JAX package's step
    does."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if lr is not None:
        for group in optimizer.param_groups:
            group["lr"] = lr
    optimizer.step()


def train_step(
    params: Params,
    optimizer: torch.optim.Optimizer,
    batch: dict[str, torch.Tensor],
    lr: float | None = None,
) -> torch.Tensor:
    """One optimizer step; returns the loss before the step (a 0-d tensor on
    the parameters' device). ``batch`` keys: kpts0, desc0, kpts1, desc1,
    mask0, mask1, gt_indices, all with a leading batch dim. ``lr``, when
    given, is this step's learning rate (a schedule's value)."""
    optimizer.zero_grad(set_to_none=True)
    loss = matching_loss(params, *(batch[k] for k in _BATCH_KEYS))
    loss.backward()
    _apply_update(params, optimizer, lr)
    return loss.detach()


def sharded_train_step(
    params: Params,
    optimizer: torch.optim.Optimizer,
    batch: dict[str, torch.Tensor],
    mesh: Mesh,
    lr: float | None = None,
) -> torch.Tensor:
    """``train_step`` over ``mesh``: the JAX package's step under ``jit``
    with the batch placed by ``data_sharding`` and the parameters by
    ``lightglue_param_sharding``.

    The batch is split over the mesh's data axis (its leading dim must
    divide); data shard i runs forward and backward across the devices of
    row i, its heads and FFN units split over the model axis
    (``tensor_parallel_forward``; the model axis must be 1, 2 or 4), its
    activations and loss on the device at (i, 0). A data shard on the
    parameters' device differentiates the parameters themselves, any other
    a copy of them on its device, and its gradient is summed onto the
    parameters' device: the all-reduce. Every shard's loss is its NLL sum
    over the WHOLE batch's ``sum(mask0)``, so the step computes what
    ``train_step`` does, up to the order of the sums (over a model axis of
    1, in ``train_step``'s order within a shard). Returns the loss before
    the step."""
    n = mesh.shape["data"]
    if batch["mask0"].shape[0] % n:
        raise ValueError(
            f"sharded_train_step: batch {batch['mask0'].shape[0]} does not split over "
            f"a data axis of {n}"
        )
    home = next(iter(params.values())).device
    optimizer.zero_grad(set_to_none=True)
    denom = _denominator(batch["mask0"])
    total = torch.zeros((), device=home)
    for i, shard in enumerate(zip(*(batch[k].chunk(n) for k in _BATCH_KEYS))):
        dev = mesh.devices[i, 0]
        local = params if dev == home else {
            k: p.detach().to(dev).requires_grad_(True) for k, p in params.items()
        }
        kpts0, desc0, kpts1, desc1, mask0, mask1, gt = (t.to(dev) for t in shard)
        la = tensor_parallel_forward(local, kpts0, desc0, kpts1, desc1, mask0, mask1, mesh, row=i)
        loss = _assignment_nll(la, mask0, gt) / denom.to(dev)
        loss.backward()
        if local is not params:
            for k, p in params.items():
                g = local[k].grad
                if g is not None:
                    g = g.to(home)
                    p.grad = g if p.grad is None else p.grad + g
        total = total + loss.detach().to(home)
    _apply_update(params, optimizer, lr)
    return total


def warmup_cosine_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float,
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` as a function of the step
    (0 for the first update): linear from init_value to peak_value over
    warmup_steps, then a cosine from peak_value to end_value that ends at
    decay_steps (warm-up included) and stays there."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return init_value + (peak_value - init_value) * step / warmup_steps
        span = max(decay_steps - warmup_steps, 1)
        frac = min(step - warmup_steps, span) / span
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return end_value + (peak_value - end_value) * cosine

    return schedule


def synthetic_matching_batch(
    rng: np.random.Generator,
    batch: int,
    k: int,
    dim: int = 256,
    kpt_jitter: float = 0.01,
) -> dict[str, np.ndarray]:
    """Self-supervision: set1 is a noised permutation-free copy of set0 with
    a random keypoint jitter; ground truth is i <-> i for the valid prefix.
    `kpt_jitter` (normalized units) controls the simulated motion scale."""
    n_valid = k * 3 // 4
    kpts0 = rng.uniform(-1, 1, (batch, k, 2)).astype(np.float32)
    jitter = rng.normal(0, kpt_jitter, (batch, k, 2)).astype(np.float32)
    kpts1 = kpts0 + jitter
    desc0 = rng.standard_normal((batch, k, dim)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    noise = rng.normal(0, 0.05, (batch, k, dim)).astype(np.float32)
    desc1 = desc0 + noise
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    mask = (np.arange(k) < n_valid)[None].repeat(batch, 0)
    gt = np.where(mask, np.arange(k)[None], -1).astype(np.int32)
    return {
        "kpts0": kpts0,
        "desc0": desc0,
        "kpts1": kpts1,
        "desc1": desc1,
        "mask0": mask,
        "mask1": mask,
        "gt_indices": gt,
    }
