from .extractor import SuperPointExtractor
from .features import PaddedFeatures, host_descriptors
from .fused import FusedStereoPipeline
from .matcher import LightGlueMatcher
from .recognizer import EigenPlacesRecognizer
from .rgbd_frontend import RgbdFrontEnd
from .stereo_frontend import StereoFrontEnd

__all__ = [
    "SuperPointExtractor",
    "PaddedFeatures",
    "host_descriptors",
    "FusedStereoPipeline",
    "LightGlueMatcher",
    "EigenPlacesRecognizer",
    "RgbdFrontEnd",
    "StereoFrontEnd",
]
