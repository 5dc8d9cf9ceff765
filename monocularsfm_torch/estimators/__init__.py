"""Vectorized robust estimators: hypothesis-parallel F-RANSAC.

The port of monocularsfm_tpu/estimators; the essential, homography and PnP
estimators follow with the reconstruct stage.
"""

from monocularsfm_torch.estimators.fundamental import (
    estimate_fundamental_ransac,
    estimate_fundamental_ransac_batch,
)
from monocularsfm_torch.estimators.ransac import (
    num_ransac_iterations,
    rounds_to_confidence,
)

__all__ = [
    "estimate_fundamental_ransac",
    "estimate_fundamental_ransac_batch",
    "num_ransac_iterations",
    "rounds_to_confidence",
]
