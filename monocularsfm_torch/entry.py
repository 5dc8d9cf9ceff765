"""Entry points of the port: one LM solve on a tiny problem, and the
multi-device dry run.

The counterpart of the JAX package's root-level `__graft_entry__.py`.
`entry(device)` returns (fn, (problem,)): fn is `bundle_adjust` with 3 LM
iterations and the problem a perturbed 6-camera ring on `device`, so
`fn(*args)` is one solve.  `dryrun_multichip(n, device)` runs the sharded
steps over n spawned ranks (`parallel/dryrun.py`).

    python -m monocularsfm_torch.entry [--device cuda]
"""

from __future__ import annotations

import argparse
import functools

from monocularsfm_torch.optim import bundle_adjust
from monocularsfm_torch.parallel.dryrun import dryrun_multichip
from monocularsfm_torch.parallel.dryrun import tiny_problem as _tiny_problem
from monocularsfm_torch.reconstruction.map_builder import resolve_device

__all__ = ["tiny_problem", "entry", "dryrun_multichip"]


def tiny_problem(num_cams: int = 6, num_points: int = 64, T: int = 4,
                 seed: int = 0, device="cuda"):
    """The JAX package's `_tiny_problem` on `device` (raises for a CUDA
    device without a GPU)."""
    return _tiny_problem(num_cams, num_points, T, seed).to(resolve_device(device))


def entry(device="cuda"):
    """(fn, example_args): one LM solve of 3 iterations on `device`."""
    prob = tiny_problem(device=device)
    return functools.partial(bundle_adjust, max_iterations=3), (prob,)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="One LM solve, then the dry run.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    fn, fargs = entry(args.device)
    print("entry:", float(fn(*fargs)["cost_final"]))
    dryrun_multichip(args.ranks, args.device)
    print("dryrun_multichip OK")
