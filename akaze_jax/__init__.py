"""AKAZE-SLAM in JAX: a visual feature & SLAM/SfM framework.

A from-scratch JAX reimplementation of the capabilities of the
CUDA-AKAZE reference (Accustomer/CUDA-AKAZE): FED nonlinear scale space,
Hessian-determinant keypoint detection with sub-pixel refinement, MLDB
binary descriptors (float32 and 16.16 fixed-point paths) and brute-force
Hamming matching — extended with a multi-view geometry back-end (RANSAC
two-view pose, pose-graph optimization, distributed bundle adjustment).
"""

from .config import AkazeConfig, Diffusivity
from .pipeline import (Akaze, Features, detect_and_compute,
                       detect_and_compute_pair, features_to_numpy)
from .plan import PipelinePlan, build_plan
from .match import Matches, match, hamming_distance_matrix

__version__ = "0.2.0"

__all__ = [
    "AkazeConfig", "Diffusivity", "Akaze", "Features", "detect_and_compute",
    "detect_and_compute_pair",
    "features_to_numpy", "PipelinePlan", "build_plan", "Matches", "match",
    "hamming_distance_matrix", "__version__",
]
