"""Training of the port's models: SuperPoint's pretraining on procedural
shapes and sprite-world renders (``synthetic_shapes``, ``superpoint_train``,
``render_domain.RenderDomainSource``) and the matcher's supervision
(``render_domain.harvest_matching_pair``; its step is
``parallel/training.py``). EigenPlaces trains through
``models/eigenplaces.py::eigenplaces_descriptor_train`` and
``scripts/train_eigenplaces_torch.py``."""

from .render_domain import RenderDomainSource, harvest_matching_pair, match_prf, mutual_nn_prf
from .superpoint_train import (
    detection_prf,
    evaluate_detector,
    make_sp_optimizer,
    sp_loss,
    sp_train_step,
)
from .synthetic_shapes import (
    corners_to_labels,
    render_shapes,
    sample_homography,
    training_batch,
    training_pair,
    warp_points,
)

__all__ = [
    "RenderDomainSource",
    "harvest_matching_pair",
    "match_prf",
    "mutual_nn_prf",
    "detection_prf",
    "evaluate_detector",
    "make_sp_optimizer",
    "sp_loss",
    "sp_train_step",
    "corners_to_labels",
    "render_shapes",
    "sample_homography",
    "training_batch",
    "training_pair",
    "warp_points",
]
