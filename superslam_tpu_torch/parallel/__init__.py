"""Training steps of the port (single device)."""

from .training import (
    make_optimizer,
    matching_loss,
    synthetic_matching_batch,
    train_step,
    warmup_cosine_schedule,
)

__all__ = [
    "make_optimizer",
    "matching_loss",
    "synthetic_matching_batch",
    "train_step",
    "warmup_cosine_schedule",
]
