"""Small sizes of the benchmark's cells, for runs on the CPU.

    python -m pytest sfmbench/tests -q

The tests import the harness from the checkout.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_CONFIG = {
    "neu": {
        "width": 480, "height": 320,
        "settings": {"camera": {"fx": 322.06, "fy": 322.06, "cx": 240.0, "cy": 160.0}},
        "ba": {"cameras": 40, "points": 3000, "rot_perturb": 0.05,
               "x_perturb": 0.1}},
    # 8 views of 640x480 at the cell's spacing of 3 degrees, the focal
    # length scaled with the width, the lens as stated.
    "south-building": {
        "views": 8, "width": 640, "height": 480,
        "settings": {"camera": {"fx": 533.2667, "fy": 533.2667, "cx": 320.0,
                                "cy": 240.0}},
        "scene": {"arc_deg": 22.5, "texture_res": 512,
                  "texture_cells": [[9, 40], [5, 14], [3, 5], [1.5, 2]]}},
}
SMALL_TRAFFIC = {
    # The small bundle converges in a few iterations: its control stops
    # after 2 (the card size's after 5 of about 40).  Its sound runs leave
    # a gain of 6e-5 to 4.3e-4 at LM's stop (seven seeds), its control
    # 4.7e-3 to 5.2e-2: the small size holds them to 1.5e-3.
    "global_ba": {"control": {"bundle": {"max_iterations": 2}},
                  "limits": {"bundle_gain": 1.5e-3}},
    # SIFT at 512 candidates an octave (a full budget costs about a minute
    # of CPU time an image), a warm-up of 4 views.  The small builds read
    # bundle_gain 2.4e-3 to 4.0e-3 sound, 1.44-1.51 under the control.
    "reconstruct": {"k_per_octave": 512, "warm_up_views": 4,
                    "limits": {"registered_miss": 0.0, "bundle_gain": 0.05}},
}


def run_small(cell: str, seed: int = 2 ** 31 + 17, control: bool = False,
              device: str = "cpu", trace: bool = False):
    """One run of `cell` at the small size; returns the harness's Outcome."""
    from sfmbench import harness

    found = harness.find_cell(harness.load_manifest(), cell)
    return harness.execute(cell, seed, 0.5, trace, device, time.perf_counter(),
                           log=lambda *a: None,
                           params=SMALL_TRAFFIC[found.traffic["stage"]],
                           config_over=SMALL_CONFIG[found.workload["config"]],
                           control=control)
