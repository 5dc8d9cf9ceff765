"""Bundle adjustment: Levenberg-Marquardt with the Schur complement.

The port of monocularsfm_tpu/optim (the reference's Ceres stack,
src/Optimizer/CeresBundleOptimizer.cpp): dense Schur for small bundles,
block-Jacobi PCG beyond, on the device the problem lies on.
"""

from monocularsfm_torch.optim.ba import (
    BundleProblem,
    bundle_adjust,
    bundle_adjust_refine_focal,
    make_bundle_problem,
)

__all__ = [
    "BundleProblem",
    "bundle_adjust",
    "bundle_adjust_refine_focal",
    "make_bundle_problem",
]
