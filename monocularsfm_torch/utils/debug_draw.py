"""Match-visualisation renderer (the reference's ShowMatches / CheckMatches).

Reference parity: FeatureUtils::ShowMatches (FeatureUtils.cpp:221-260) pops a
GUI window per pair from the CheckMatches binary; headless equivalent: render
the side-by-side image with match lines to a PNG.
"""

from __future__ import annotations

import numpy as np


def draw_matches(img1, img2, uv1, uv2, out_path=None, max_lines: int = 200):
    """Side-by-side render with green match lines. Returns the BGR canvas."""
    import cv2

    if img1.ndim == 2:
        img1 = cv2.cvtColor(img1, cv2.COLOR_GRAY2BGR)
    if img2.ndim == 2:
        img2 = cv2.cvtColor(img2, cv2.COLOR_GRAY2BGR)
    h = max(img1.shape[0], img2.shape[0])
    w = img1.shape[1] + img2.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1] :] = img2
    off = img1.shape[1]
    n = min(len(uv1), max_lines)
    idx = np.linspace(0, len(uv1) - 1, n).astype(int) if len(uv1) else []
    for i in idx:
        p1 = (int(uv1[i, 0]), int(uv1[i, 1]))
        p2 = (int(uv2[i, 0]) + off, int(uv2[i, 1]))
        cv2.circle(canvas, p1, 3, (0, 128, 255), 1)
        cv2.circle(canvas, p2, 3, (0, 128, 255), 1)
        cv2.line(canvas, p1, p2, (0, 255, 0), 1)
    if out_path is not None:
        cv2.imwrite(str(out_path), canvas)
    return canvas
