from .lightglue import (
    extract_matches,
    init_lightglue_params,
    lightglue_forward,
    lightglue_match,
    normalize_keypoints,
)
from .superpoint import (
    init_superpoint_params,
    select_keypoints,
    superpoint_dense,
    superpoint_extract,
    superpoint_raw,
)
from .weights import (
    from_jax_params,
    load_params,
    load_safetensors,
    save_params,
    to_jax_params,
)

__all__ = [
    "extract_matches",
    "init_lightglue_params",
    "lightglue_forward",
    "lightglue_match",
    "normalize_keypoints",
    "init_superpoint_params",
    "select_keypoints",
    "superpoint_dense",
    "superpoint_extract",
    "superpoint_raw",
    "from_jax_params",
    "load_params",
    "load_safetensors",
    "save_params",
    "to_jax_params",
]
