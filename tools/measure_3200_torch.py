"""The port's SIFT at the shipped configs' max_image_size of 3200.

The PyTorch counterpart of tools/measure_3200.py.  Renders one 3200x2400
textured view and times `SIFT(device=...).extract` on it: one warm-up call,
then `--reps` calls, each waited for on the card.  At this size the 2x
upsample makes octave 0 6400x4800, so the extraction stage's
batch_pixel_budget takes one image per dispatch.  The OpenCV half of the
JAX script runs only where cv2 imports (not on the GPU machine); without
it the output says so and gives no figure in its place.

Usage: python tools/measure_3200_torch.py [--reps 3] [--device cuda]
       [--width 3200 --height 2400]

Prints one JSON line: seconds per image, images per second, the feature
count, the card (nvidia-smi name and power limit) and the peak of
torch.cuda.max_memory_allocated over the timed extractions.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def opencv_half(img, reps: int) -> dict:
    """cv2.SIFT on the same image and feature budget, where cv2 imports."""
    try:
        import cv2
    except ImportError:
        return {"opencv": "not run: cv2 does not import on this machine"}
    sift = cv2.SIFT_create(nfeatures=8024)
    sift.detectAndCompute(img, None)                  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        kp, _ = sift.detectAndCompute(img, None)
    dt = (time.perf_counter() - t0) / reps
    return {"opencv_s_per_image": dt, "opencv_images_per_sec": 1 / dt,
            "opencv_features": len(kp)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=3200)
    ap.add_argument("--height", type=int, default=2400)
    args = ap.parse_args(argv)

    import torch

    from monocularsfm_torch.ops.sift import SIFT
    from monocularsfm_torch.reconstruction.map_builder import resolve_device
    from monocularsfm_torch.utils.card import card_line, sync
    from monocularsfm_torch.utils.synthetic import render_textured_images

    dev = resolve_device(args.device)
    card = card_line(dev)
    imgs, _, _, _ = render_textured_images(
        scene_seed=11, num_cameras=1, width=args.width, height=args.height)
    img = imgs[0]
    ex = SIFT(device=dev)
    kp, _ = ex.extract(img)                           # warm
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        kp, _ = ex.extract(img)
        sync(dev)
    dt = (time.perf_counter() - t0) / args.reps
    result = {
        "image": f"{args.width}x{args.height}",
        "device": dev.type,
        "card": card,
        "s_per_image": dt,
        "images_per_sec": 1 / dt,
        "features": len(kp),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        **opencv_half(img, args.reps),
    }
    if "opencv_s_per_image" in result:
        result["vs_opencv"] = result["opencv_s_per_image"] / dt
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
