"""High-precision small-matrix products.

The reference chains jnp.matmul at Precision.HIGHEST because the TPU
contracts f32 in bf16 by default.  Here the package pins full fp32 at
import (no TF32), so a plain float32 matmul chain is the same product.
"""

from __future__ import annotations

import torch


def mm(*ms):
    """Left-to-right float32 matrix product."""
    out = ms[0]
    for m in ms[1:]:
        out = torch.matmul(out, m)
    return out
