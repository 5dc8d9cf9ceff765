"""monocularsfm_torch — the PyTorch/CUDA port of monocularsfm_tpu.

The JAX package beside it stays the reference: every module here keeps the
name of its counterpart there, and the tests run both on the same inputs.
Plain tensor code is PyTorch; every Pallas kernel of the reference is a
hand-written CUDA kernel for Hopper (sm_90a) under `csrc/`, built at first
use by `ops/_build.py`.
"""

__version__ = "0.1.0"

import torch as _torch

# Full fp32 for every float32 product and convolution on the card.  The
# reference pins jax_default_matmul_precision=float32 for the same reason:
# geometry code (eigh/svd internals, pose algebra) loses whole pixels to
# reduced-precision contractions.  The deliberate low-precision paths (the
# bf16 descriptor similarity, f16 SIFT descriptors) cast explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from monocularsfm_torch import types  # noqa: E402,F401
