"""Multi-view geometry: SO(3)/SE(3), epipolar geometry, RANSAC.

This subsystem extends the reference front-end (Accustomer/CUDA-AKAZE has no
geometry layer; see SURVEY.md §7 step 7) into the two-view back-end required
by the north star: RANSAC essential-matrix pose on top of AKAZE matches.
Everything is batched and statically shaped so it jits to one program.
"""

from .se3 import (so3_exp, so3_log, se3_exp, se3_log, se3_inverse,
                  se3_compose, se3_apply, se3_identity, highest_precision)
from .epipolar import (essential_from_eight, decompose_essential,
                       triangulate, sampson_error, recover_pose)
from .ransac import ransac_essential, RansacResult
from .homography import (homography_from_points, ransac_homography,
                         HomographyResult, pnp_dlt)

__all__ = [
    "so3_exp", "so3_log", "se3_exp", "se3_log", "se3_inverse",
    "se3_compose", "se3_apply", "se3_identity",
    "essential_from_eight", "decompose_essential", "triangulate",
    "sampson_error", "recover_pose", "ransac_essential", "RansacResult",
    "homography_from_points", "ransac_homography", "HomographyResult",
    "pnp_dlt",
]
