"""Vectorized robust estimators: F / E / H / EPnP, hypothesis-parallel RANSAC.

The port of monocularsfm_tpu/estimators.  Every estimator takes its uniform
draws as an argument (see estimators/ransac.py).
"""

from monocularsfm_torch.estimators.fundamental import (
    estimate_fundamental_ransac,
    estimate_fundamental_ransac_batch,
)
from monocularsfm_torch.estimators.essential import (
    estimate_essential_ransac,
    decompose_essential,
    recover_pose_from_essential,
)
from monocularsfm_torch.estimators.homography import estimate_homography_ransac
from monocularsfm_torch.estimators.pnp import estimate_pnp_ransac
from monocularsfm_torch.estimators.ransac import (
    num_ransac_iterations,
    rounds_to_confidence,
)

__all__ = [
    "estimate_fundamental_ransac",
    "estimate_fundamental_ransac_batch",
    "estimate_essential_ransac",
    "decompose_essential",
    "recover_pose_from_essential",
    "estimate_homography_ransac",
    "estimate_pnp_ransac",
    "num_ransac_iterations",
    "rounds_to_confidence",
]
