from .extractor import SuperPointExtractor
from .features import PaddedFeatures
from .fused import FusedStereoPipeline
from .matcher import LightGlueMatcher

__all__ = [
    "SuperPointExtractor",
    "PaddedFeatures",
    "FusedStereoPipeline",
    "LightGlueMatcher",
]
