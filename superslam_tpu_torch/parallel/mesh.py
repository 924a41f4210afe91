"""Device-mesh construction and sharding rules.

Port of ``superslam_tpu/parallel/mesh.py``. The reference is a
single-process single-GPU system with no DP/TP/PP/SP/EP; the JAX package
keeps a 2-D (data, model) mesh:

- ``data``: multi-sequence batched tracking (BASELINE config 5), pure data
  parallelism over independent image streams, and the batch axis of the
  fine-tuning step;
- ``model``: tensor parallelism over LightGlue's FFN hidden dim and
  attention projections (never needed for memory at this model size;
  ``parallel/tensor_parallel.py`` splits the forward by these rules).

Here a mesh is a (data, model) grid of ``torch.device``s and a placement
(``NamedSharding``) says which mesh axis splits which tensor dimension;
nothing is moved by building one. A mesh may also be built from an
explicit device list in which a device repeats (eight ``cpu`` entries):
the port's stand-in for XLA's ``--xla_force_host_platform_device_count``,
so that sharded logic runs on the CPU and on one card. On one card the
data axis has size 1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """devices: an object array (data, model) of ``torch.device``."""

    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def flat(self) -> list[torch.device]:
        """Every device of the mesh, data-major (a device may repeat)."""
        return list(self.devices.reshape(-1))


def make_mesh(n_devices: int | None = None, model_axis: int | None = None,
              devices: list | None = None) -> Mesh:
    """A (data, model) mesh over the first n devices: the CUDA devices, or
    ``devices`` when given. The model axis defaults to 2 when the device
    count allows it, else 1."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        kind = "CUDA"
    else:
        devs = [torch.device(d) for d in devices]
        kind = "listed"
    n = n_devices or len(devs)
    if n < 1 or len(devs) < n:
        raise ValueError(
            f"make_mesh({n_devices}) needs {max(n, 1)} devices but only {len(devs)} {kind} "
            "devices exist; for a mesh on one device pass devices=[...] with the device "
            "repeated"
        )
    devs = devs[:n]
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n >= 2 else 1
    data_axis = n // model_axis
    arr = np.empty(data_axis * model_axis, dtype=object)
    arr[:] = devs[: data_axis * model_axis]
    return Mesh(arr.reshape(data_axis, model_axis))


@dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec[d]`` is the mesh axis (a name, a tuple of names,
    or None) that splits tensor dimension d; dimensions past the spec and
    None entries are replicated."""

    mesh: Mesh
    spec: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return all(self.mesh.shape[a] == 1 for a in self._axes())

    def _axes(self) -> list[str]:
        out = []
        for entry in self.spec:
            if entry is not None:
                out.extend(entry if isinstance(entry, tuple) else (entry,))
        return out


# name-suffix -> PartitionSpec rules for LightGlue parameters, as data: the
# JAX package's specs on its (in, out) weights (shard the contracted or
# output dim on 'model').
_LG_RULES: list[tuple[str, tuple]] = [
    (".Wqkv.weight", (None, "model")),
    (".Wqkv.bias", ("model",)),
    (".out_proj.weight", ("model", None)),
    (".to_qk.weight", (None, "model")),
    (".to_qk.bias", ("model",)),
    (".to_v.weight", (None, "model")),
    (".to_v.bias", ("model",)),
    (".to_out.weight", ("model", None)),
    (".ffn.0.weight", (None, "model")),
    (".ffn.0.bias", ("model",)),
    (".ffn.3.weight", ("model", None)),
]


def lightglue_param_sharding(mesh: Mesh, params: dict) -> dict:
    """Placements for a port LightGlue param dict: TP on attention and FFN
    dims, replicated elsewhere. The port stores linear weights (out, in),
    the transpose of the JAX package's, so a 2-D rule's spec is reversed."""
    out = {}
    for name in params:
        spec = ()
        for suffix, rule in _LG_RULES:
            if name.endswith(suffix):
                spec = tuple(reversed(rule)) if len(rule) == 2 else rule
                break
        out[name] = NamedSharding(mesh, spec)
    return out


def data_sharding(mesh: Mesh, *batch_axes: int) -> NamedSharding:
    """Shard the leading batch dimension over 'data'."""
    spec = [None] * (max(batch_axes) + 1 if batch_axes else 1)
    spec[0] = "data"
    return NamedSharding(mesh, tuple(spec))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())
