"""Multi-sequence batched tracking, the device mesh and the matcher's
training step of the port, on one device and data-parallel over a mesh."""

from .batched_tracking import batched_stereo_frontend, batched_track_scan
from .mesh import data_sharding, lightglue_param_sharding, make_mesh, replicate
from .multi_tracker import MultiSequenceTracker
from .training import (
    make_optimizer,
    matching_loss,
    sharded_train_step,
    synthetic_matching_batch,
    train_step,
    warmup_cosine_schedule,
)

__all__ = [
    "batched_stereo_frontend",
    "batched_track_scan",
    "data_sharding",
    "lightglue_param_sharding",
    "make_mesh",
    "replicate",
    "MultiSequenceTracker",
    "make_optimizer",
    "matching_loss",
    "sharded_train_step",
    "synthetic_matching_batch",
    "train_step",
    "warmup_cosine_schedule",
]
