"""Multi-sequence batched tracking, the device mesh and the training step
of the port (the sharded training step comes with the training slice)."""

from .batched_tracking import batched_stereo_frontend, batched_track_scan
from .mesh import data_sharding, lightglue_param_sharding, make_mesh, replicate
from .multi_tracker import MultiSequenceTracker
from .training import (
    make_optimizer,
    matching_loss,
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
    "synthetic_matching_batch",
    "train_step",
    "warmup_cosine_schedule",
]
