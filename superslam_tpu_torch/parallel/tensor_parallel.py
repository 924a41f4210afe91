"""LightGlue's unfused forward split over a mesh's model axis.

The JAX package has no module of its own for this: it places LightGlue's
weights by ``_LG_RULES`` and ``lightglue_param_sharding``
(``superslam_tpu/parallel/mesh.py:48-74``), and GSPMD splits the step under
``jit`` and inserts the all-reduces. Here the split is written out, for the
unfused route (``models/lightglue.py``'s ``fused=False``: the route GSPMD
splits, since the JAX package's sharded programs run with
``SUPERSLAM_PALLAS_LG=0``).

The blocks are ``models/lightglue.py``'s, written once over a list of
parameter shards: the single-device forward passes one whole shard
(``WholeParams``), this module M shards and their all-reduces. Each
parameter's split is read from ``lightglue_param_sharding``'s spec
(``parallel/mesh.py``; the port's (out, in) linears carry the reversed
rules). Shard j of a model axis of size M takes part j of M contiguous
parts of every dimension its spec gives to ``model``:

- a linear whose output rows are split (``Wqkv``, ``to_qk``, ``to_v``,
  ``ffn.0``, each with its bias) computes its share of the outputs: the
  attention's H/M heads (heads are the outermost factor of every packing,
  Wqkv's (head, channel, qkv) included) or the FFN's 2·DIM/M hidden units;
- a linear whose input columns are split (``out_proj``, ``to_out``,
  ``ffn.3``) computes a partial sum over its share of the inputs. The
  partials are summed in the fixed order 0..M-1 on the data shard's device
  (the all-reduce) and the bias, which is replicated, is added once;
- the ``ffn.1`` LayerNorm, replicated by the rules, normalises over all
  2·DIM hidden units: each shard applies its part of the gain and shift,
  and its statistics are all-reduced in two passes (the mean, then the
  mean square deviation from it);
- everything else (``input_proj``, the rotary encoding, the assignment
  heads) runs once per data shard, on its device.

Shard j runs on ``mesh.devices[i, j]`` of data shard i; the first entry
of the row holds the activations between blocks. Parameters stay whole:
a shard reads slices of them, through ``.to(device)`` copies where its
device is not theirs, so autograd carries every gradient back to the
parameter it came from and one optimizer step updates them as on one
device. Every attention call goes through ``ops/cuda/attention.py``'s
hand-written kernels, one call a block and shard on that shard's heads:
18·M forward launches (and as many backward) a forward.

A model axis of size 1 computes exactly what ``lightglue_forward(...,
fused=False)`` does, in the same order. There is no fused route here: the
fused blocks are not split. A model axis that does not divide the heads and
the hidden units raises.
"""

from __future__ import annotations

import torch

from ..models.lightglue import (
    DIM,
    HEAD_DIM,
    NUM_HEADS,
    WholeParams,
    _final_assignment,
    _linear,
    _pair_rows,
    _to,
    _unfused_layers,
)
from .mesh import Mesh, lightglue_param_sharding

Params = dict[str, torch.Tensor]
AXIS = "model"
# The rows a head (or hidden unit) takes in each output-split linear: a
# shard's contiguous rows must be whole heads.
_ROWS_PER_UNIT = {"Wqkv": 3 * HEAD_DIM, "to_qk": HEAD_DIM, "to_v": HEAD_DIM, "ffn.0": 1}


def _check_model_axis(m: int) -> None:
    """A model axis must split the heads and the FFN's hidden units evenly."""
    if m < 1 or NUM_HEADS % m or (2 * DIM) % m:
        raise ValueError(
            f"a model axis of {m} does not divide LightGlue's {NUM_HEADS} heads and "
            f"{2 * DIM} hidden units (1, 2 or 4)"
        )


def _split_dims(spec: tuple) -> tuple[int, ...]:
    return tuple(d for d, e in enumerate(spec)
                 if e == AXIS or (isinstance(e, tuple) and AXIS in e))


_PLANS: dict = {}


def _plan(params: Params, mesh: Mesh) -> dict[str, tuple[int, ...]]:
    """{parameter: the dimensions its placement splits over the model
    axis}, checked against what the blocks compute (output rows of whole
    heads with their bias, or input columns with a replicated bias). Made
    once for each parameter layout and model axis."""
    m = mesh.shape[AXIS]
    key = (tuple((k, tuple(v.shape)) for k, v in params.items()), m)
    if key in _PLANS:
        return _PLANS[key]
    dims = {k: _split_dims(v.spec) for k, v in lightglue_param_sharding(mesh, params).items()}
    for name, d in dims.items():
        stem, kind = name.rsplit(".", 1)
        if kind != "weight" or not d:
            continue
        bias = dims.get(f"{stem}.bias")
        unit = next((u for s, u in _ROWS_PER_UNIT.items() if stem.endswith(f".{s}")), None)
        rows = params[name].shape[0] // m
        if d == (0,) and unit is not None and rows % unit == 0 and bias == (0,):
            continue
        if d == (1,) and bias == ():
            continue
        raise ValueError(f"{name}: splitting dims {d} over '{AXIS}' (bias {bias}) is not a "
                         "split of whole heads or of input columns with a replicated bias")
    _PLANS[key] = dims
    return dims


class _Shard(WholeParams):
    """Shard j of M on ``device``: reads its part of each parameter, part j
    of M contiguous parts of every dimension ``dims`` gives to the model
    axis, as a ``.to(device)`` copy where the parameter lives elsewhere."""

    def __init__(self, params: Params, dims: dict, j: int, m: int, device: torch.device):
        super().__init__(params)
        self.dims, self.j, self.m, self.device = dims, j, m, device

    def here(self, t: torch.Tensor) -> torch.Tensor:
        return _to(t, self.device)

    def take(self, name: str, dims=None) -> torch.Tensor:
        t = self.params[name]
        for d in self.dims[name] if dims is None else dims:
            n = t.shape[d] // self.m
            t = t.narrow(d, self.j * n, n) if self.m > 1 else t
        return _to(t, self.device)


def tensor_parallel_forward(
    params: Params,
    kpts0: torch.Tensor,
    desc0: torch.Tensor,
    kpts1: torch.Tensor,
    desc1: torch.Tensor,
    mask0: torch.Tensor,
    mask1: torch.Tensor,
    mesh: Mesh,
    row: int = 0,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """``lightglue_forward(..., fused=False)`` for data shard ``row`` of
    ``mesh``, split over ``mesh.devices[row, :]``; returns the (B, M, N)
    f32 log-assignment on ``mesh.devices[row, 0]``. The inputs are moved
    there; the parameters are read where they are."""
    devices = list(mesh.devices[row])
    m = len(devices)
    _check_model_axis(m)
    home = devices[0]
    args = [_to(t, home) for t in (kpts0, desc0, kpts1, desc1, mask0, mask1)]
    dims = _plan(params, mesh)
    shards = [_Shard(params, dims, j, m, d) for j, d in enumerate(devices)]
    rep = {k: _to(v, home) for k, v in params.items() if not dims[k]}
    x, kpts, mask = _pair_rows(*args)
    x = _linear(x, rep, "input_proj", compute_dtype)
    x = _unfused_layers(x, kpts, mask, rep, compute_dtype, shards)
    return _final_assignment(x, args[4], args[5], rep)
